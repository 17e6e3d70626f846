"""Hilbert-curve domain decomposition + local-tree (ghost zone) extraction.

Reproduces RAMSES' data layout that the paper prunes:

  * leaves are ordered along a 3D Hilbert curve at the finest level and cut
    into equal-count segments -> one *domain* per MPI process;
  * each domain's local tree contains (a) its own leaves, (b) ghost
    neighbor leaves (stencil halo), and (c) a *degraded global* coarse view
    of the whole box down to ``coarse_level`` (multigrid requirement);
  * coarse ownership: a coarse cell is owned iff any descendant leaf is.

The redundancy introduced by (b)+(c) is what :mod:`repro.core.prune`
removes for the post-processing (HDep) flow.
"""
from __future__ import annotations

import numpy as np

from . import hilbert
from .amr import AMRTree, morton3, subset_tree


def leaf_hilbert_keys(tree: AMRTree) -> np.ndarray:
    """Hilbert key (at the finest level) of each leaf's first fine cell."""
    max_level = tree.n_levels - 1
    leaves = np.flatnonzero(~tree.refine)
    lv = tree.levels()[leaves]
    fine = tree.coords[leaves].astype(np.uint64) << (max_level - lv)[:, None].astype(np.uint64)
    return hilbert.coords_to_key(fine, bits=max(max_level, 1))


def assign_domains(tree: AMRTree, n_domains: int) -> np.ndarray:
    """(n_leaves,) domain id per leaf, contiguous along the Hilbert curve."""
    keys = leaf_hilbert_keys(tree)
    return hilbert.domain_split(keys, n_domains)


class _LevelIndex:
    """Per-level sorted-Morton index for covering-leaf queries."""

    def __init__(self, tree: AMRTree):
        self.tree = tree
        self.max_level = tree.n_levels - 1
        self.codes = []
        self.node_ids = []
        for l in range(tree.n_levels):
            sl = tree.level_slice(l)
            ids = np.arange(sl.start, sl.stop, dtype=np.int64)
            codes = morton3(tree.coords[sl])
            order = np.argsort(codes)
            self.codes.append(codes[order])
            self.node_ids.append(ids[order])

    def covering_leaf(self, fine_coords: np.ndarray) -> np.ndarray:
        """Leaf node id covering each fine-level coordinate (-1 if none)."""
        out = np.full(fine_coords.shape[0], -1, np.int64)
        todo = np.ones(fine_coords.shape[0], bool)
        for l in range(self.tree.n_levels):
            shift = np.uint64(self.max_level - l)
            c = (fine_coords.astype(np.uint64) >> shift)
            q = morton3(c)
            pos = np.searchsorted(self.codes[l], q)
            pos = np.minimum(pos, len(self.codes[l]) - 1)
            hit = (self.codes[l][pos] == q) & todo
            node = self.node_ids[l][pos]
            is_leaf = ~self.tree.refine[node]
            take = hit & is_leaf
            out[take] = node[take]
            todo &= ~take
            if not todo.any():
                break
        return out


_NEIGHBOR_OFFSETS = np.array(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
     if (dx, dy, dz) != (0, 0, 0)], np.int64)


def ghost_leaves(tree: AMRTree, leaf_domain: np.ndarray, domain: int,
                 index: _LevelIndex | None = None,
                 chunk: int = 200_000) -> np.ndarray:
    """Global leaf ids of the ghost halo of ``domain`` (26-neighborhood).

    For each owned leaf, sample the center of each of its 26 same-level
    neighbors (periodic box) and find the covering leaf; any covering leaf
    owned by another domain is a ghost. One-level-finer neighbors are caught
    via the neighbor's 8 sub-centers on face-adjacent offsets.
    """
    if index is None:
        index = _LevelIndex(tree)
    max_level = tree.n_levels - 1
    box = np.int64(1) << max_level
    leaves = np.flatnonzero(~tree.refine)
    mine = leaves[leaf_domain == domain]
    lv = tree.levels()[mine].astype(np.int64)
    size = (np.int64(1) << (max_level - lv))
    base = tree.coords[mine] * size[:, None]

    ghost_ids: list[np.ndarray] = []
    for lo in range(0, mine.size, chunk):
        sel = slice(lo, lo + chunk)
        b, s = base[sel], size[sel]
        pts = []
        # same-level neighbor centers (26 offsets)
        for off in _NEIGHBOR_OFFSETS:
            p = b + off[None, :] * s[:, None] + (s // 2)[:, None]
            pts.append(p)
        # half-cell sub-centers across the 6 faces (catch finer neighbors)
        for axis in range(3):
            for sign in (-1, 1):
                for u in (1, 3):
                    for v in (1, 3):
                        p = b.copy()
                        p[:, axis] += np.where(sign > 0, s, -(s // 2) - (s // 4))
                        p[:, axis] += np.where(sign > 0, s // 4, 0)
                        ax_u, ax_v = [a for a in range(3) if a != axis]
                        p[:, ax_u] += (u * s) // 4
                        p[:, ax_v] += (v * s) // 4
                        pts.append(p)
        q = np.concatenate(pts, axis=0) % box  # periodic wrap
        cover = index.covering_leaf(q)
        cover = cover[cover >= 0]
        ghost_ids.append(np.unique(cover))
    if not ghost_ids:
        return np.zeros(0, np.int64)
    g = np.unique(np.concatenate(ghost_ids))
    # drop my own leaves
    leaf_rank = np.full(tree.n_nodes, -1, np.int64)
    leaf_rank[leaves] = np.arange(leaves.size)
    g = g[leaf_domain[leaf_rank[g]] != domain]
    return g


def subtree_ownership(tree: AMRTree, leaf_domain: np.ndarray, domain: int) -> np.ndarray:
    """(n_nodes,) owner flags: leaf owned iff assigned; coarse iff any son."""
    owner = np.zeros(tree.n_nodes, bool)
    leaves = np.flatnonzero(~tree.refine)
    owner[leaves[leaf_domain == domain]] = True
    cs = tree.child_start()
    for l in range(tree.n_levels - 2, -1, -1):
        sl = tree.level_slice(l)
        idx = np.flatnonzero(tree.refine[sl]) + sl.start
        if idx.size == 0:
            continue
        kids = cs[idx][:, None] + np.arange(8)[None, :]
        owner[idx] |= owner[kids].any(axis=1)
    return owner


def local_tree(tree: AMRTree, leaf_domain: np.ndarray, domain: int,
               coarse_level: int = 3,
               index: _LevelIndex | None = None) -> AMRTree:
    """Extract the RAMSES-like local tree of ``domain`` (own+ghost+coarse)."""
    owner = subtree_ownership(tree, leaf_domain, domain)
    levels = tree.levels()
    keep = np.zeros(tree.n_nodes, bool)

    # (a) own leaves, (b) ghost halo leaves
    leaves = np.flatnonzero(~tree.refine)
    keep[leaves[leaf_domain == domain]] = True
    keep[ghost_leaves(tree, leaf_domain, domain, index=index)] = True
    # (c) degraded global coarse view
    keep[levels <= coarse_level] = True

    # ancestor closure (bottom-up through parents)
    parent = tree.parent()
    for l in range(tree.n_levels - 1, 0, -1):
        sl = tree.level_slice(l)
        kept = np.flatnonzero(keep[sl]) + sl.start
        keep[parent[kept]] = True

    # sibling closure + demote refined nodes with no kept children
    cs = tree.child_start()
    force_leaf = []
    for l in range(tree.n_levels - 1):
        sl = tree.level_slice(l)
        idx = np.flatnonzero(tree.refine[sl] & keep[sl]) + sl.start
        if idx.size == 0:
            continue
        kids = cs[idx][:, None] + np.arange(8)[None, :]
        any_kid = keep[kids].any(axis=1)
        keep[kids[any_kid].ravel()] = True           # all 8 siblings
        force_leaf.append(idx[~any_kid])             # degraded view leaf
    force = np.concatenate(force_leaf) if force_leaf else np.zeros(0, np.int64)

    base = AMRTree(refine=tree.refine, owner=owner,
                   level_offsets=tree.level_offsets, coords=tree.coords,
                   fields=tree.fields)
    return subset_tree(base, keep, force_leaf=force)
