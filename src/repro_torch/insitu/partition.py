"""Contributor-group partitioning of staged snapshots.

The paper's scalability comes from every MPI process writing *its own*
domains and post-processing reassembling them lazily. One in-process
engine has no MPI ranks, so this module manufactures the same shape:
a staged snapshot is split into ``n_groups`` contributor parts, each
reduced by its own worker lane and written as its own Hercule domain
(merged back at read — see ``hercule.api.ReducedKind``).

Two snapshot kinds partition differently:

  * ``amr``      — leaves are assigned to groups contiguously along the
    Hilbert curve (the same :func:`repro_torch.core.decompose.assign_domains`
    split the writer uses for real domains), then each group gets the
    closed subtree of its owned leaves: ancestors, full sibling octets,
    and demoted ``force_leaf`` nodes where a branch leaves the group.
    ``owner`` flags mark which leaves the group actually owns, so
    owner-aware reducers contribute each global leaf exactly once and
    per-group outputs tile/sum back to the global answer.
  * ``tensors``  — named arrays are striped over groups in sorted-name
    order (each tensor is reduced by exactly one group; merged objects
    concatenate and re-sort by name).
"""
from __future__ import annotations

import numpy as np

from ..core import decompose
from ..core.amr import AMRTree, subset_tree

__all__ = ["partition_snapshot", "partition_tree", "partition_named",
           "leaf_shards"]


def leaf_shards(arrays: dict[str, np.ndarray], n_shards: int) -> np.ndarray:
    """Per-leaf shard id, Hilbert-contiguous — the mesh path's split.

    Returns an ``(n_leaves,)`` int array aligned with
    ``np.flatnonzero(~refine)`` (BFS leaf order). Shard ``g``'s leaves
    are the same set the multi-domain writer would assign to domain
    ``g`` (:func:`repro_torch.core.decompose.assign_domains`), so per-shard
    partial reductions are bitwise the per-domain host outputs and the
    on-device merge can mirror the read-side merge strategies exactly.
    """
    tree = AMRTree.from_arrays(arrays)
    if n_shards <= 1:
        return np.zeros(int((~tree.refine).sum()), np.int64)
    return np.asarray(decompose.assign_domains(tree, n_shards),
                      np.int64)


def _group_tree(tree: AMRTree, leaf_domain: np.ndarray, group: int,
                parent: np.ndarray, cs: np.ndarray) -> AMRTree:
    """Closed subtree of one group's owned leaves (no ghosts, no coarse view).

    Same closure rules as :func:`repro_torch.core.decompose.local_tree` minus the
    ghost halo and the degraded global coarse view: ancestors of owned
    leaves are kept, kept refined nodes keep all eight sons, and kept
    refined nodes whose sons all fall outside the group are demoted to
    leaves (they already carry the intensive restriction of their sons).
    """
    owner = decompose.subtree_ownership(tree, leaf_domain, group)
    keep = np.zeros(tree.n_nodes, bool)
    leaves = np.flatnonzero(~tree.refine)
    keep[leaves[leaf_domain == group]] = True

    # ancestor closure, bottom-up
    for l in range(tree.n_levels - 1, 0, -1):
        sl = tree.level_slice(l)
        kept = np.flatnonzero(keep[sl]) + sl.start
        keep[parent[kept]] = True

    # sibling closure + demote refined nodes whose branch leaves the group
    force_leaf = []
    for l in range(tree.n_levels - 1):
        sl = tree.level_slice(l)
        idx = np.flatnonzero(tree.refine[sl] & keep[sl]) + sl.start
        if idx.size == 0:
            continue
        kids = cs[idx][:, None] + np.arange(8)[None, :]
        any_kid = keep[kids].any(axis=1)
        keep[kids[any_kid].ravel()] = True
        force_leaf.append(idx[~any_kid])
    force = np.concatenate(force_leaf) if force_leaf \
        else np.zeros(0, np.int64)

    base = AMRTree(refine=tree.refine, owner=owner,
                   level_offsets=tree.level_offsets, coords=tree.coords,
                   fields=tree.fields)
    return subset_tree(base, keep, force_leaf=force)


def partition_tree(arrays: dict[str, np.ndarray], n_groups: int
                   ) -> list[dict[str, np.ndarray]]:
    """Split tree arrays into ``n_groups`` closed contributor subtrees."""
    tree = AMRTree.from_arrays(arrays)
    leaf_domain = decompose.assign_domains(tree, n_groups)
    parent, cs = tree.parent(), tree.child_start()
    return [_group_tree(tree, leaf_domain, g, parent, cs).to_arrays()
            for g in range(n_groups)]


def partition_named(arrays: dict[str, np.ndarray], n_groups: int
                    ) -> list[dict[str, np.ndarray]]:
    """Stripe named arrays over groups in sorted-name order."""
    names = sorted(arrays)
    return [{n: arrays[n] for n in names[g::n_groups]}
            for g in range(n_groups)]


def partition_snapshot(arrays: dict[str, np.ndarray], kind: str,
                       n_groups: int) -> list[dict[str, np.ndarray]]:
    """Split one staged payload into per-contributor-group payloads.

    ``n_groups == 1`` is the degenerate identity (no copies, no closure
    work) so a single-group engine behaves bit-for-bit like the
    single-writer one.
    """
    if n_groups <= 1:
        return [arrays]
    if kind == "amr":
        try:
            return partition_tree(arrays, n_groups)
        except KeyError as e:
            raise ValueError(
                "multi-domain in-transit reduction needs complete AMR tree "
                f"arrays (AMRTree.to_arrays schema); missing {e}") from None
    if kind == "tensors":
        return partition_named(arrays, n_groups)
    raise ValueError(
        f"cannot partition snapshot kind {kind!r} over contributor groups; "
        "supported kinds: 'amr', 'tensors'")
