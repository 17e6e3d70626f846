"""Plain torch twins of the raster kernels (the CPU path and the oracle).

Counterparts of ``repro/kernels/ref.py``'s raster oracles, written so
that they are deterministic on any device: no duplicate-index ``set``
or float ``index_add_`` whose order a device may change. Bit-identical
to the host numpy reducers (``insitu.reducers``/``hercule.analysis``):

  * slice — every valid leaf competes for its per-level cell with the
    order-free key "largest row wins" (``scatter_reduce`` amax), which
    is the host painter's later-overrides rule; the level pyramid is then
    composed coarse to fine, so deeper leaves override;
  * projection — per level, a leaf's rank among the leaves of its cell
    (row order) splits the level into passes whose target cells are
    unique, so each pixel's f64 adds run in the host's BFS order;
  * histogram — integer counts (``bincount``) are order-free.

Pixel geometry is exact integer arithmetic; ``resolution`` must be a
power of two (``ops`` checks it).
"""
from __future__ import annotations

import torch

_NAN = float("nan")


def level_scale(n_levels: int, device) -> torch.Tensor:
    """Exact float64 path lengths ``2^-l`` for l in [0, n_levels)."""
    return torch.tensor([2.0 ** -l for l in range(max(n_levels, 1))],
                        dtype=torch.float64, device=device)


def level_bases(n_levels: int, k: int) -> list[int]:
    """Offsets of each level's cell grid (side 2^min(l, k)) in one buffer,
    plus the total cell count as the last entry."""
    bases, off = [], 0
    for lvl in range(n_levels):
        bases.append(off)
        off += 1 << (2 * min(lvl, k))
    return bases + [off]


def level_cells(coords2: torch.Tensor, levels: torch.Tensor, *,
                resolution: int, n_levels: int) -> torch.Tensor:
    """Pyramid cell of each node: base[l] + its cell on the level grid.

    Level ``l`` uses a grid of side ``2^min(l, k)`` (k = log2 R): a
    coarse leaf owns one cell, a leaf finer than a pixel lands on its
    pixel. Levels outside [0, n_levels) get a clipped, meaningless cell;
    callers mask them out.
    """
    k = resolution.bit_length() - 1
    bases = torch.tensor(level_bases(n_levels, k)[:-1], dtype=torch.int64,
                         device=coords2.device)
    safe = levels.to(torch.int64).clamp(0, n_levels - 1)
    dn = (safe - k).clamp(min=0)
    g = torch.ones_like(safe) << safe.clamp(max=k)
    c = coords2.to(torch.int64)
    return bases[safe] + (c[:, 0] >> dn) * g + (c[:, 1] >> dn)


def _upsample(grid: torch.Tensor, px: int) -> torch.Tensor:
    return grid.repeat_interleave(px, 0).repeat_interleave(px, 1)


def slice_raster_ref(coords2, c_axis, levels, values, ok, *,
                     position: float, resolution: int, n_levels: int):
    """Slice image: the deepest covering valid leaf, NaN where none.

    ``coords2`` is the (N, 2) in-plane coords, ``c_axis`` the (N,) coord
    along the slice axis, ``ok`` the valid-leaf mask.
    """
    r = resolution
    k = r.bit_length() - 1
    dev = values.device
    lvl = levels.to(torch.int64)
    in_range = (lvl >= 0) & (lvl < n_levels)
    size = level_scale(n_levels, dev)[lvl.clamp(0, n_levels - 1)]
    lo = c_axis.to(torch.float64) * size
    sel = ok & in_range & (lo <= position) & (position < lo + size)
    bases = level_bases(n_levels, k)
    total = bases[-1]
    idx = torch.where(sel, level_cells(coords2, levels, resolution=r,
                                       n_levels=n_levels),
                      torch.full_like(lvl, total))
    rows = torch.arange(lvl.shape[0], dtype=torch.int64, device=dev)
    win = torch.full((total + 1,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, idx, torch.where(sel, rows, -1), reduce="amax")
    img_row = torch.full((r, r), -1, dtype=torch.int64, device=dev)
    for level in range(n_levels):
        g = 1 << min(level, k)
        grid = win[bases[level]:bases[level] + g * g].reshape(g, g)
        up = _upsample(grid, r // g)
        img_row = torch.where(up >= 0, up, img_row)
    painted = img_row >= 0
    img = values[img_row.clamp(min=0)]
    return torch.where(painted, img, torch.full_like(img, _NAN))


def projection_raster_ref(coords2, levels, values, ok, *,
                          resolution: int, n_levels: int):
    """Column density: per-leaf value * 2^-level summed along the axis.

    Several leaves of one level can land on one pixel (they differ along
    the projection axis), so each pixel's adds must run leaf by leaf in
    BFS order. Per level, the leaves are split by their rank within
    their cell; every rank pass targets unique cells, so a plain
    gather-add-scatter keeps the host's accumulation order exactly. At
    coarse levels the pass runs on a coarse view of the running image —
    exact, since every coarser level wrote values constant over this
    level's cells — and touched cells are replicated back.
    """
    r = resolution
    k = r.bit_length() - 1
    dev = values.device
    lvl = levels.to(torch.int64)
    scale = level_scale(n_levels, dev)
    cells = level_cells(coords2, levels, resolution=r, n_levels=n_levels)
    bases = level_bases(n_levels, k)
    img = torch.zeros((r, r), dtype=values.dtype, device=dev)
    for level in range(n_levels):
        sel = torch.nonzero(ok & (lvl == level)).flatten()
        if sel.numel() == 0:
            continue
        g = 1 << min(level, k)
        px = r // g
        cell = cells[sel] - bases[level]
        sorted_cell, perm = torch.sort(cell, stable=True)
        rank = (torch.arange(sorted_cell.numel(), device=dev)
                - torch.searchsorted(sorted_cell, sorted_cell))
        rows = sel[perm]
        contrib = values[rows] * scale[level]
        flat = img[::px, ::px].reshape(-1).clone()
        for rk in range(int(rank.max()) + 1):
            m = rank == rk
            tgt = sorted_cell[m]
            flat[tgt] = flat[tgt] + contrib[m]
        hit = torch.zeros(g * g, dtype=torch.bool, device=dev)
        hit[sorted_cell] = True
        up = _upsample(flat.reshape(g, g), px)
        img = torch.where(_upsample(hit.reshape(g, g), px), up, img)
    return img


def level_hist_ref(values, levels, ok, edges, *, n_levels: int):
    """(L, B) int32 per-level histogram with ``np.histogram`` bins."""
    bins = edges.shape[-1] - 1
    lvl = levels.to(torch.int64)
    idx = torch.searchsorted(edges, values, right=True) - 1
    b = torch.where(values == edges[-1], bins - 1, idx)
    good = (ok & (values >= edges[0]) & (values <= edges[-1])
            & (lvl >= 0) & (lvl < n_levels))
    flat = (lvl * bins + b)[good]
    hist = torch.bincount(flat, minlength=n_levels * bins)
    return hist.to(torch.int32).reshape(n_levels, bins)
