"""Post-processing / visualization over HDep databases (paper §4).

The PyMSES-5 + VTK HyperTreeGrid role: assemble per-domain objects into
the global AMR tree, apply threshold filters, extract axis-aligned slices.
VTK is unavailable offline, so the outputs are dense numpy images /
cell lists with the same semantics as the paper's fig. 8 pipeline
(HyperTreeGrid threshold on the density field).
"""
from __future__ import annotations

import numpy as np

from ..core.amr import AMRTree, morton3
from . import api
from .database import HerculeDB


def assemble(trees: list[AMRTree]) -> AMRTree:
    """Merge per-domain (pruned) trees into one global tree.

    Nodes are matched by (level, coords); structure is the union of the
    domains' structures; owned nodes supply field values (ghost copies are
    ignored — the ownership array is exactly the assembly key, paper §2).
    """
    n_levels = max(t.n_levels for t in trees)
    fields = sorted({f for t in trees for f in t.fields})
    out_refine, out_coords, out_fields = [], [], {f: [] for f in fields}
    for lvl in range(n_levels):
        codes_l, ref_l, own_l, coords_l = [], [], [], []
        fields_l = {f: [] for f in fields}
        for t in trees:
            if lvl >= t.n_levels:
                continue
            sl = t.level_slice(lvl)
            if sl.start == sl.stop:
                continue
            codes_l.append(morton3(t.coords[sl]))
            ref_l.append(t.refine[sl])
            own_l.append(t.owner[sl])
            coords_l.append(t.coords[sl])
            for f in fields:
                fields_l[f].append(t.fields[f][sl])
        if not codes_l:
            out_refine.append(np.zeros(0, bool))
            out_coords.append(np.zeros((0, 3), np.int64))
            for f in fields:
                out_fields[f].append(np.zeros(0))
            continue
        codes = np.concatenate(codes_l)
        ref = np.concatenate(ref_l)
        own = np.concatenate(own_l)
        coords = np.concatenate(coords_l)
        # unique codes in Morton order; merge duplicates vectorized:
        # refine = OR over copies; fields prefer the OWNED copy
        uniq, inv = np.unique(codes, return_inverse=True)
        n = uniq.shape[0]
        refine_m = np.zeros(n, bool)
        np.logical_or.at(refine_m, inv, ref)
        # representative row per unique code, owned copies win
        best = np.full(n, -1, np.int64)
        rows = np.arange(codes.shape[0])
        np.maximum.at(best, inv, np.where(own, rows + codes.shape[0], rows))
        best = np.where(best >= codes.shape[0], best - codes.shape[0], best)
        out_refine.append(refine_m)
        out_coords.append(coords[best])
        for f in fields:
            vals = np.concatenate(fields_l[f])
            out_fields[f].append(vals[best])
    # Morton order within a level == BFS order for Morton-grown trees
    # (parent prefix property), so the concatenation below is valid BFS.
    offsets = np.zeros(len(out_refine) + 1, np.int64)
    for i, r in enumerate(out_refine):
        offsets[i + 1] = offsets[i] + r.shape[0]
    tree = AMRTree(refine=np.concatenate(out_refine),
                   owner=np.ones(int(offsets[-1]), bool),
                   level_offsets=offsets,
                   coords=np.concatenate(out_coords),
                   fields={f: np.concatenate(out_fields[f]) for f in fields})
    return tree


def load_global_tree(db: HerculeDB, step: int) -> AMRTree:
    view = db.view(step)
    return assemble([api.AMR_TREE.assemble(view, d)
                     for d in api.AMR_TREE.domains_in(view)])


def threshold(tree: AMRTree, field: str, lo: float = -np.inf,
              hi: float = np.inf) -> dict[str, np.ndarray]:
    """Leaf cells whose field value lies in [lo, hi] (paper fig. 8 filter)."""
    leaves = ~tree.refine
    v = tree.fields[field]
    sel = leaves & (v >= lo) & (v <= hi)
    levels = tree.levels()
    return {"coords": tree.coords[sel], "level": levels[sel],
            "value": v[sel]}


def slice_image(tree: AMRTree, field: str, *, axis: int = 2,
                position: float = 0.5, resolution: int = 256,
                owned_only: bool = False) -> np.ndarray:
    """Rasterize an axis-aligned slice through the AMR tree.

    Each output pixel takes the value of the deepest leaf covering it —
    the HyperTreeGrid slice semantics. With ``owned_only`` only owned
    leaves paint (contributor-partition trees: per-domain images then
    tile by extent back to the global slice, NaN where not owned).
    """
    img = np.full((resolution, resolution), np.nan)
    depth = np.full((resolution, resolution), -1, np.int32)
    levels = tree.levels()
    v = tree.fields[field]
    leaves = np.flatnonzero(~tree.refine)
    if owned_only:
        leaves = leaves[tree.owner[leaves]]
    ax_u, ax_v = [a for a in range(3) if a != axis]
    for lvl in range(tree.n_levels):
        sel = leaves[levels[leaves] == lvl]
        if sel.size == 0:
            continue
        size = 1.0 / (1 << lvl)
        c = tree.coords[sel]
        lo_w = c[:, axis] * size
        hit = (lo_w <= position) & (position < lo_w + size)
        sel = sel[hit]
        if sel.size == 0:
            continue
        c = tree.coords[sel]
        u0 = np.floor(c[:, ax_u] * size * resolution).astype(int)
        v0 = np.floor(c[:, ax_v] * size * resolution).astype(int)
        px = max(1, int(round(size * resolution)))
        for i, node in enumerate(sel):
            uu, vv = u0[i], v0[i]
            img[uu:uu + px, vv:vv + px] = v[node]
            depth[uu:uu + px, vv:vv + px] = lvl
    return img
