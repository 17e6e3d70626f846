"""Plain torch twins of the CUDA kernels (the CPU path and the oracle).

Counterparts of ``repro/kernels/ref.py``'s oracles, written so that they
are deterministic on any device: no duplicate-index ``set`` or float
``index_add_`` whose order a device may change.

Raster twins, bit-identical to the host numpy reducers
(``insitu.reducers``/``hercule.analysis``):

  * slice — every valid leaf competes for its per-level cell with the
    order-free key "largest row wins" (``scatter_reduce`` amax), which
    is the host painter's later-overrides rule; the level pyramid is then
    composed coarse to fine, so deeper leaves override;
  * projection — per level, a leaf's rank among the leaves of its cell
    (row order) splits the level into passes whose target cells are
    unique, so each pixel's f64 adds run in the host's BFS order;
  * histogram — integer counts (``bincount``) are order-free;
  * seeded (``init=``) — the carry twins of the tiled rasters start
    from an earlier tile's partial instead of NaN/-1 or zeros.

Pixel geometry is exact integer arithmetic; ``resolution`` must be a
power of two (``ops`` checks it).

Codec twins (father–son XOR delta, bitfields): 32-bit words travel as
``torch.int32`` tensors holding the uint32 bit patterns. ``torch.uint32``
has no ``>>`` and an int32 ``>>`` is arithmetic, so every shift or
comparison widens to int64 masked with ``0xFFFFFFFF`` first
(:func:`u32`); :func:`i32` narrows back.
"""
from __future__ import annotations

import torch

_NAN = float("nan")


#: level_scale's tensors per (device, n_levels): made once, so a call on
#: the card copies nothing from the host (a copy from pageable memory
#: synchronizes the stream). Read only: callers index or cast them.
_LEVEL_SCALES: dict = {}


def level_scale(n_levels: int, device) -> torch.Tensor:
    """Exact float64 path lengths ``2^-l`` for l in [0, n_levels)."""
    key = (torch.device(device), n_levels)
    scale = _LEVEL_SCALES.get(key)
    if scale is None:
        scale = _LEVEL_SCALES[key] = torch.tensor(
            [2.0 ** -l for l in range(max(n_levels, 1))],
            dtype=torch.float64, device=key[0])
    return scale


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
    img, _ = slice_raster_depth_ref(
        coords2, c_axis, levels, values, ok, position=position,
        resolution=resolution, n_levels=n_levels)
    return img


def slice_raster_depth_ref(coords2, c_axis, levels, values, ok, *,
                           position: float, resolution: int, n_levels: int,
                           init=None):
    """Depth-tracking slice, optionally seeded: returns ``(image, depth)``.

    ``depth`` (int32) holds the painting leaf's level, -1 where nothing
    painted. ``init=(img0, depth0)`` seeds the paint (the earlier tiles'
    partial of a tiled raster): a level-``l`` leaf lands only where
    ``l >= depth0``, the sequential kernel's gate, so a tile's deeper or
    equal-level leaves repaint the seed and shallower ones do not.
    """
    r = resolution
    k = r.bit_length() - 1
    dev = values.device
    lvl = levels.to(torch.int64)
    in_range = (lvl >= 0) & (lvl < n_levels)
    # the plane test in the values' dtype, as the reference's: 2^-l is
    # exact; c, lo + size and ``position`` round to that dtype (in
    # float32 once c > 2^24 or lo + size needs more bits)
    vdt = values.dtype
    size = level_scale(n_levels, dev).to(vdt)[lvl.clamp(0, n_levels - 1)]
    lo = c_axis.to(vdt) * size
    pos = torch.tensor(position, dtype=vdt, device=dev)
    sel = ok & in_range & (lo <= pos) & (pos < lo + size)
    bases = level_bases(n_levels, k)
    total = bases[-1]
    idx = torch.where(sel, level_cells(coords2, levels, resolution=r,
                                       n_levels=n_levels),
                      torch.full_like(lvl, total))
    rows = torch.arange(lvl.shape[0], dtype=torch.int64, device=dev)
    win = torch.full((total + 1,), -1, dtype=torch.int64, device=dev)
    win.scatter_reduce_(0, idx, torch.where(sel, rows, -1), reduce="amax")
    if init is None:
        img = torch.full((r, r), _NAN, dtype=values.dtype, device=dev)
        depth = torch.full((r, r), -1, dtype=torch.int32, device=dev)
    else:
        img, depth = init
    for level in range(n_levels):
        g = 1 << min(level, k)
        grid = win[bases[level]:bases[level] + g * g].reshape(g, g)
        up = _upsample(grid, r // g)
        take = (up >= 0) & (depth <= level)
        img = torch.where(take, values[up.clamp(min=0)], img)
        depth = torch.where(take, level, depth)
    return img, depth


def projection_raster_ref(coords2, levels, values, ok, *,
                          resolution: int, n_levels: int, init=None,
                          tile_n: int | None = None):
    """Column density: per-leaf value * 2^-level summed along the axis.

    Several leaves of one level can land on one pixel (they differ along
    the projection axis), so each pixel's adds must run leaf by leaf in
    BFS order. Per level, the leaves are split by their rank within
    their cell; every rank pass targets unique cells, so a plain
    gather-add-scatter over the cells' pixel blocks keeps the host's
    accumulation order exactly. ``init`` seeds the accumulator (the
    earlier tiles' partial of a tiled raster); the adds run per pixel,
    so any seed is exact and pixels no leaf covers keep its bits.
    ``tile_n``: the table chained in ``tile_n``-row tiles, each seeded
    with the partial of the tiles before it (B5's one call over a shard
    gives this chain's bits).
    """
    if tile_n is not None and values.shape[0] > tile_n:
        img = init
        for a in range(0, values.shape[0], tile_n):
            img = projection_raster_ref(
                coords2[a:a + tile_n], levels[a:a + tile_n],
                values[a:a + tile_n], ok[a:a + tile_n],
                resolution=resolution, n_levels=n_levels, init=img)
        return img
    r = resolution
    k = r.bit_length() - 1
    dev = values.device
    lvl = levels.to(torch.int64)
    scale = level_scale(n_levels, dev).to(values.dtype)   # exact
    cells = level_cells(coords2, levels, resolution=r, n_levels=n_levels)
    bases = level_bases(n_levels, k)
    img = torch.zeros((r, r), dtype=values.dtype, device=dev) \
        if init is None else init
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
        contrib = values[sel[perm]] * scale[level]
        # (cell, pixel of the cell) blocks of the running image: a copy
        blocks = img.reshape(g, px, g, px).permute(0, 2, 1, 3) \
            .reshape(g * g, px * px).clone()
        for rk in range(int(rank.max()) + 1):
            m = rank == rk
            tgt = sorted_cell[m]
            blocks[tgt] = blocks[tgt] + contrib[m, None]
        img = blocks.reshape(g, g, px, px).permute(0, 2, 1, 3).reshape(r, r)
    return img


def level_hist_ref(values, levels, ok, edges, *, n_levels: int):
    """(L, B) int32 per-level histogram with ``np.histogram`` bins; the
    bins are decided in the wider of the values' and edges' dtypes."""
    bins = edges.shape[-1] - 1
    lvl = levels.to(torch.int64)
    # compare in the wider dtype, as the reference's promotion does: a
    # 0-dim float64 edge would otherwise round to float32 values' dtype
    common = torch.promote_types(values.dtype, edges.dtype)
    values, edges = values.to(common), edges.to(common)
    idx = torch.searchsorted(edges, values, right=True) - 1
    b = torch.where(values == edges[-1], bins - 1, idx)
    good = (ok & (values >= edges[0]) & (values <= edges[-1])
            & (lvl >= 0) & (lvl < n_levels))
    flat = (lvl * bins + b)[good]
    hist = torch.bincount(flat, minlength=n_levels * bins)
    return hist.to(torch.int32).reshape(n_levels, bins)


# ------------------------------------------------------------ codec twins

_FULL = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) of 32-bit word patterns."""
    return x.to(torch.int64) & _FULL


def i32(x: torch.Tensor) -> torch.Tensor:
    """The int32 tensor with the bit patterns of int64 words in
    [0, 2^32)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def clz32_ref(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of 32-bit words (32 for 0), int32: the reference's
    bit smear and SWAR popcount."""
    x = u32(x)
    for sh in (1, 2, 4, 8, 16):
        x = x | (x >> sh)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    pop = ((x * 0x01010101) & _FULL) >> 24
    return (32 - pop).to(torch.int32)


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x[0])
    for row in x:
        out = out | row
    return out


def group_residues_ref(pred_hi, pred_lo, son_hi, son_lo, zbits: int,
                       width: int):
    """Twin of B6: (S, G) int32 words -> residues ``son ^ pred`` (S, G)
    and the clamped shared leading-zero count nlz (G,) int32."""
    res_hi = son_hi ^ pred_hi
    res_lo = son_lo ^ pred_lo
    m_hi, m_lo = _or_rows(res_hi), _or_rows(res_lo)
    if width == 64:
        nlz = torch.where(m_hi != 0, clz32_ref(m_hi), 32 + clz32_ref(m_lo))
    elif width == 32:
        nlz = clz32_ref(m_lo)
    else:  # 16-bit payloads in the low word
        nlz = clz32_ref(m_lo) - 16
    return res_hi, res_lo, nlz.clamp(max=(1 << zbits) - 1).to(torch.int32)


def group_residues_block_ref(pred_hi, pred_lo, son_hi, son_lo, zbits: int,
                             width: int) -> torch.Tensor:
    """Twin of B6's one buffer (``codec.encode_block``): the residues of
    :func:`group_residues_ref` in stream order — (G, S, 2) lo/hi pairs at
    width 64, else the lo words (G, S) then the hi words (G, S) — then
    nlz, flat int32."""
    res_hi, res_lo, nlz = group_residues_ref(pred_hi, pred_lo, son_hi,
                                             son_lo, zbits, width)
    if width == 64:
        block = torch.stack([res_lo.T, res_hi.T], 2)
    else:
        block = torch.stack([res_lo.T, res_hi.T])
    return torch.cat([block.reshape(-1), nlz])


def decode_residues_ref(res_hi, res_lo, pred_hi, pred_lo):
    """Twin of B7: son words ``res ^ pred``."""
    return res_hi ^ pred_hi, res_lo ^ pred_lo


def bitpack_ref(bits: torch.Tensor) -> torch.Tensor:
    """Twin of B8: (N,) flags -> ceil(N/32) int32 words, bit i of word w
    set iff ``bits[32w + i] != 0``; bits past N are 0."""
    n = bits.shape[0]
    flat = torch.zeros(-(-n // 32) * 32, dtype=torch.int64,
                       device=bits.device)
    flat[:n] = bits != 0
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    return i32((flat.reshape(-1, 32) * weights).sum(1))


def bitunpack_ref(words: torch.Tensor, n: int) -> torch.Tensor:
    """Twin of B9: the first ``n`` flags of ``words``, uint8 {0, 1}."""
    shifts = torch.arange(32, device=words.device)
    return ((u32(words)[:, None] >> shifts) & 1).reshape(-1)[:n] \
        .to(torch.uint8)
