"""AMR tree pruning (paper §2.1) — remove ghost-subtree redundancy.

RAMSES' multigrid solver requires every MPI process to hold a *degraded
global* view of the whole box's mesh, and hydro stencils require ghost
neighbor cells; both make each process' local tree heavily redundant for
post-processing. The pruning algorithm walks the tree bottom-up and
"dynamically changes the refinement values of unnecessary cells which are
defined as ghost coarse cells of whom leafs are also all ghosts": such a
coarse cell is demoted to a (ghost) leaf and its children dropped.

On the paper's Orion data this removed 31.3 % of cells on average
(17.2 % worst, 47.3 % best domain) — reproduced by
``benchmarks/bench_pruning.py`` on the Orion-like substrate.
"""
from __future__ import annotations

import numpy as np

from .amr import AMRTree, subset_tree


def prune(tree: AMRTree) -> AMRTree:
    """Return the pruned copy of ``tree`` (bottom-up ghost-subtree collapse)."""
    refine = tree.refine.copy()
    alive = np.ones(tree.n_nodes, bool)
    cs = tree.child_start()
    # Bottom-up sweep: a ghost refined node whose 8 children are all
    # (currently) leaves and all ghosts becomes a leaf; children die.
    for l in range(tree.n_levels - 2, -1, -1):
        sl = tree.level_slice(l)
        idx = np.flatnonzero(tree.refine[sl]) + sl.start  # originally refined
        if idx.size == 0:
            continue
        kids = cs[idx][:, None] + np.arange(8)[None, :]   # (m, 8)
        all_leaf = ~refine[kids].any(axis=1)
        all_ghost = ~tree.owner[kids].any(axis=1)
        collapse = (~tree.owner[idx]) & all_leaf & all_ghost
        victims = idx[collapse]
        refine[victims] = False
        alive[(cs[victims][:, None] + np.arange(8)[None, :]).ravel()] = False
    return subset_tree(
        AMRTree(refine=tree.refine, owner=tree.owner,
                level_offsets=tree.level_offsets, coords=tree.coords,
                fields=tree.fields),
        keep=alive,
        force_leaf=np.flatnonzero(tree.refine & ~refine),
    )


def removed_fraction(before: AMRTree, after: AMRTree) -> float:
    """Paper fig. 3 metric: fraction of cells removed by pruning."""
    return 1.0 - after.n_nodes / before.n_nodes
