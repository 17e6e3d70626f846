"""AMR octree model in the Hercule HDep "AMR-3D" linearization.

Paper §2: each MPI process stores its piece of the AMR structure as a
*self-describing object* whose key attributes are two boolean arrays in
breadth-first order (top level -> bottom level, left -> right inside each
level):

  * ``refine``  — True: coarse cell (has 2**ndim children), False: leaf.
  * ``owner``   — True: cell belongs to this process, False: ghost.

Children of refined node i sit contiguously at the next level, ordered by
the node's rank among refined nodes of its level; inside a father the
children follow Morton order (k = ix + 2*iy + 4*iz).

The flat-array representation here is exactly that linearization, plus
derived navigation arrays (levels, child_start, parent) and per-node
physical fields — coarse "father" cells carry values too (restriction of
their sons), which is what the father–son delta compression predicts from.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def morton3(coords: np.ndarray) -> np.ndarray:
    """Interleave (N, 3) int coords into 64-bit Morton codes (<=21 bits/axis)."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v
    return (spread(coords[:, 0]) | (spread(coords[:, 1]) << np.uint64(1))
            | (spread(coords[:, 2]) << np.uint64(2)))


CHILD_OFFSETS = np.array(
    [[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64)


@dataclasses.dataclass
class AMRTree:
    """Flat BFS-linearized octree with ownership and per-node fields."""

    refine: np.ndarray                 # (n_nodes,) bool
    owner: np.ndarray                  # (n_nodes,) bool
    level_offsets: np.ndarray          # (n_levels+1,) int64
    coords: np.ndarray                 # (n_nodes, 3) int64, per-level integer coords
    fields: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    # ---------------------------------------------------------- properties
    @property
    def n_nodes(self) -> int:
        return int(self.refine.shape[0])

    @property
    def n_levels(self) -> int:
        return int(self.level_offsets.shape[0] - 1)

    @property
    def n_leaves(self) -> int:
        return int((~self.refine).sum())

    def levels(self) -> np.ndarray:
        """(n_nodes,) level of each node."""
        out = np.zeros(self.n_nodes, np.int32)
        for l in range(self.n_levels):
            out[self.level_offsets[l]:self.level_offsets[l + 1]] = l
        return out

    def level_slice(self, l: int) -> slice:
        return slice(int(self.level_offsets[l]), int(self.level_offsets[l + 1]))

    # ---------------------------------------------------------- navigation
    def child_start(self) -> np.ndarray:
        """(n_nodes,) index of first child for refined nodes, -1 for leaves."""
        out = np.full(self.n_nodes, -1, np.int64)
        for l in range(self.n_levels - 1):
            sl = self.level_slice(l)
            ref = self.refine[sl]
            rank = np.cumsum(ref) - ref  # refined-rank within level
            out[sl][ref] = 0  # placeholder to keep shapes; assign below
            idx = np.flatnonzero(ref) + sl.start
            out[idx] = self.level_offsets[l + 1] + 8 * rank[ref]
        return out

    def parent(self) -> np.ndarray:
        """(n_nodes,) parent index, -1 for root level."""
        out = np.full(self.n_nodes, -1, np.int64)
        cs = self.child_start()
        refined = np.flatnonzero(self.refine)
        for k in range(8):
            out[cs[refined] + k] = refined
        return out

    # ---------------------------------------------------------- validation
    def validate(self) -> None:
        assert self.refine.shape == self.owner.shape == (self.n_nodes,)
        assert self.coords.shape == (self.n_nodes, 3)
        for l in range(self.n_levels - 1):
            n_ref = int(self.refine[self.level_slice(l)].sum())
            n_next = int(self.level_offsets[l + 2] - self.level_offsets[l + 1])
            assert n_next == 8 * n_ref, f"level {l}: {n_next} != 8*{n_ref}"
        if self.n_levels:
            assert not self.refine[self.level_slice(self.n_levels - 1)].any(), \
                "deepest level must be all leaves"
        # children coords must be 2*parent + morton offset
        cs = self.child_start()
        refined = np.flatnonzero(self.refine)
        if refined.size:
            for k in range(8):
                got = self.coords[cs[refined] + k]
                want = 2 * self.coords[refined] + CHILD_OFFSETS[k]
                assert np.array_equal(got, want), "child coords broken"
        for f, v in self.fields.items():
            assert v.shape[0] == self.n_nodes, f"field {f} wrong length"

    # ---------------------------------------------------------- fields
    def restrict_fields_upward(self) -> None:
        """Recompute coarse-node field values as the mean of their sons.

        Intensive ("non conservative" in the paper's wording) restriction:
        the father value is the average of its 8 sons, which is exactly the
        predictor the father–son codec assumes.
        """
        cs = self.child_start()
        for name, v in self.fields.items():
            for l in range(self.n_levels - 2, -1, -1):
                sl = self.level_slice(l)
                idx = np.flatnonzero(self.refine[sl]) + sl.start
                if idx.size == 0:
                    continue
                sons = v[(cs[idx][:, None] + np.arange(8)[None, :]).ravel()]
                v[idx] = sons.reshape(-1, 8).mean(axis=1)

    def leaf_mask(self) -> np.ndarray:
        return ~self.refine

    # ---------------------------------------------------------- serialization
    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "refine": self.refine,
            "owner": self.owner,
            "level_offsets": self.level_offsets,
            "coords": self.coords,
            **{f"field:{k}": v for k, v in self.fields.items()},
        }

    @staticmethod
    def from_arrays(arrs: dict[str, np.ndarray]) -> "AMRTree":
        fields = {k[len("field:"):]: v for k, v in arrs.items() if k.startswith("field:")}
        return AMRTree(refine=np.asarray(arrs["refine"], bool),
                       owner=np.asarray(arrs["owner"], bool),
                       level_offsets=np.asarray(arrs["level_offsets"], np.int64),
                       coords=np.asarray(arrs["coords"], np.int64),
                       fields=fields)


def subset_tree(tree: AMRTree, keep: np.ndarray, force_leaf: np.ndarray | None = None) -> AMRTree:
    """Extract the sub-tree of ``keep`` nodes, re-linearized in BFS order.

    ``keep`` must be closed: if a refined node is kept and not forced leaf,
    all 8 children are kept; ancestors of kept nodes are kept. Nodes in
    ``force_leaf`` are demoted to leaves (their kept descendants dropped).
    """
    keep = keep.copy()
    refine = tree.refine.copy()
    if force_leaf is not None:
        refine[force_leaf] = False
    cs = tree.child_start()
    # Drop descendants of forced leaves, top-down.
    for l in range(tree.n_levels - 1):
        sl = tree.level_slice(l)
        par = np.flatnonzero(tree.refine[sl]) + sl.start
        dead_par = par[~keep[par] | ~refine[par]]
        for k in range(8):
            keep[cs[dead_par] + k] = False
        # children of dropped nodes can't be refined either
        kids = (cs[dead_par][:, None] + np.arange(8)[None, :]).ravel()
        refine[kids] = False
    new_index = np.cumsum(keep) - 1
    offsets = [0]
    for l in range(tree.n_levels):
        offsets.append(offsets[-1] + int(keep[tree.level_slice(l)].sum()))
    offsets = np.asarray(offsets, np.int64)
    # trim empty deepest levels
    n_lv = len(offsets) - 1
    while n_lv > 1 and offsets[n_lv] == offsets[n_lv - 1]:
        n_lv -= 1
    offsets = offsets[:n_lv + 1]
    sel = np.flatnonzero(keep)
    return AMRTree(
        refine=refine[sel],
        owner=tree.owner[sel],
        level_offsets=offsets,
        coords=tree.coords[sel],
        fields={k: v[sel].copy() for k, v in tree.fields.items()},
    )
