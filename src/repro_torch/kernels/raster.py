"""CUDA raster kernels B1-B5 for the in-transit device-reduce paths.

Wrappers around the hand-written kernels in ``csrc/raster.cu`` (see the
header there for the designs), the leaf-table geometry they consume and
the launch counters. Each wrapper takes the same arguments as its plain
twin in :mod:`.ref`: a CPU tensor runs the twin, a CUDA tensor launches
the kernel or raises — there is no fallback. The kernels are built at
first use by :mod:`.cudalib`.

Value dtypes on the card: B1 and B2 take float64 values (the device path
is float64 only, as the reference's); B3, B4 and B5 take float64 or
float32 values and launch that dtype's kernel (the mesh path's float32
tables), counted apart under ``<name>_f32``. Any other dtype raises.

B1, B2, B4 and B5 each make one C call from the raw columns; the leaf
table or CSR is built on the card, over scratch the module keeps per
(device, stream). B3 makes one C call and one launch into an output the
previous call zeroed, with its edges by value from the CPU. The mesh
path calls B4 and B5 once per shard (``kernels.ops``); B5 takes the
twins' ``tile_n`` so that the call keeps their tile chain's add order.
"""
from __future__ import annotations

import struct

import torch

from . import ref
from .cudalib import current_stream, dense, device_index, launch, on_cuda

#: kernel launches per wrapper; each wrapper adds one where it launches
LAUNCHES = {"slice_raster": 0, "projection_raster": 0, "level_hist": 0,
            "slice_raster_carry": 0, "projection_raster_carry": 0,
            "level_hist_f32": 0, "slice_raster_carry_f32": 0,
            "projection_raster_carry_f32": 0}

#: B3-B5's value dtypes on the card -> the C entries' suffix
_SUFFIX = {torch.float64: "_f64", torch.float32: "_f32"}

#: B1/B4's int64 key scratch per (device, raw stream, R): the (R, R)
#: pixel keys, the coarse levels' cell keys (:func:`slice_coarse_cells`)
#: and one slot for a block counter and the mask of keyed levels, all
#: zero between calls: both kernels' resolve clears every pixel key it
#: reads, and its last block the keyed cells, the mask and the counter.
#: Only calls on one stream share one, and the library holds the
#: interpreter lock through each call, so one call's paint and resolve
#: reach the stream with no other call's launches between them.
_SLICE_KEYS: dict = {}

#: largest slice rectangle (pixels) the paint kernel paints pixel by
#: pixel from its row's thread; a larger (coarse) leaf sets one key in
#: its level's cell grid, which the resolve reads per pixel
#: (``kSliceOwnArea`` in csrc/raster.cu)
SLICE_OWN_AREA = 16

#: B2/B5's CSR scratch per (device, raw stream, R, n_levels), shared by
#: the two on the same terms as ``_SLICE_KEYS``: ``[zeros, offsets,
#: rows]`` — the int32 cell counts and their per-chunk counts (all zero
#: between calls: the scan zeroes the counts it reads, the place step the
#: chunk counts), the int64 offsets, and ``ROW_WORDS`` int32 words per
#: table row (grown with N).
_PROJ_SCRATCH: dict = {}

#: B3's next output per (device, raw stream, L, B): an all-zero (L, B)
#: int32 tensor. A call takes it as its output, adds the counts into it
#: and, in the same launch, zeroes the fresh tensor it leaves here for the
#: next call on the stream, so no call memsets or waits for a last block.
#: A call takes the tensor out of the dict before it launches, so two
#: threads never fill one output.
_HIST_NEXT: dict = {}

#: most histogram edges the C entry takes from the CPU by value, as a
#: kernel parameter (``kParamEdges`` in csrc/raster.cu)
HIST_PARAM_EDGES = 257

#: cells per scan block of the CSR (``kScanChunk`` in csrc/raster.cu); the
#: count and offsets scratch are padded to a multiple of it
SCAN_CHUNK = 4096

#: most table rows one C call takes: the kernels index rows in int32
MAX_ROWS = 2 ** 31 - 1

#: int32 words of B2/B5's row scratch per table row: the ordered
#: contributions (a float64 each, at most), the key, the placed row and
#: the ordered row (first the arrival index in the cell)
ROW_WORDS = 5


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _suffix(name: str, values: torch.Tensor, dtypes=_SUFFIX) -> str:
    """The C entry suffix of ``values``' dtype for kernel ``name``; raises
    for a dtype the kernel has no instantiation of."""
    try:
        return dtypes[values.dtype]
    except KeyError:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name} on the card takes {names} values, got "
                        f"{values.dtype}") from None


def _count(name: str, suffix: str) -> None:
    LAUNCHES[name if suffix == "_f64" else name + "_f32"] += 1


def round_f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (ties to even), as a float:
    B4-f32's slice position, which then crosses to C exactly."""
    return struct.unpack("f", struct.pack("f", x))[0]


# ----------------------------------------------------------- leaf tables
#
# ``leaf_table``, ``plane_hit`` and ``_slice_table`` are the Python mirror
# of what B1/B4's paint kernel computes per row from the raw columns; the
# tests and ``chip_smoke.py`` hold the kernel and the reference to them.

def leaf_table(coords2: torch.Tensor, levels: torch.Tensor, *,
               resolution: int):
    """Integer pixel geometry of every node: (u0, v0, px), int32.

    Exact integer forms of the host reducers' ``floor(c * size * res)``
    and ``round(size * res)`` for a power-of-two ``resolution``.
    """
    k = resolution.bit_length() - 1
    lvl = levels.to(torch.int32)
    up = (k - lvl).clamp(min=0)
    dn = (lvl - k).clamp(min=0)
    c = coords2.to(torch.int32)
    u0 = (c[:, 0] << up) >> dn
    v0 = (c[:, 1] << up) >> dn
    px = (resolution >> lvl.clamp(0, 30)).clamp(min=1).to(torch.int32)
    return u0, v0, px


def plane_hit(c_axis: torch.Tensor, levels: torch.Tensor, position: float,
              n_levels: int) -> torch.Tensor:
    """Host-exact slice-plane test ``lo <= position < lo + size``; both
    bounds are exact dyadic rationals c / 2^l in float64."""
    size = ref.level_scale(n_levels, c_axis.device)[
        levels.to(torch.int64).clamp(0, n_levels - 1)]
    lo = c_axis.to(torch.float64) * size
    return (lo <= position) & (position < lo + size)


# ----------------------------------------------------------------- kernels

def _slice_table(coords2, c_axis, levels, ok, *, position: float,
                 resolution: int, n_levels: int):
    """B1/B4's leaf table at float64: (u0, v0, px, lvl, good),
    contiguous, where ``good`` folds validity, level range and the
    slice-plane test."""
    u0, v0, px = (t.contiguous() for t in
                  leaf_table(coords2, levels, resolution=resolution))
    lvl = levels.to(torch.int32).contiguous()
    good = (ok & (lvl >= 0) & (lvl < n_levels)
            & plane_hit(c_axis, lvl, position, n_levels)
            ).to(torch.uint8).contiguous()
    return u0, v0, px, lvl, good


def _seed(init, resolution: int, dtypes):
    """The carry seed as contiguous (R, R) tensors of ``dtypes``."""
    for t, dt in zip(init, dtypes):
        if t.shape != (resolution, resolution) or t.dtype != dt:
            raise ValueError(f"carry seed must be ({resolution}, "
                             f"{resolution}) {dt}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    return tuple(dense(t) for t in init)


def _slice_columns(name: str, coords2, c_axis, levels, values, ok):
    """B1/B4's raw columns for the card — int32 ``coords2`` (N, 2) and
    ``levels``, int32 ``c_axis`` (any stride), the values and bool or
    uint8 ``ok`` (N,) — with every column but ``c_axis`` contiguous;
    raises TypeError for anything else."""
    n = values.shape[0]
    if n > MAX_ROWS:
        raise ValueError(f"{name} of {n} rows exceeds the kernels' int32 "
                         f"row index")
    if not (coords2.dtype == c_axis.dtype == levels.dtype == torch.int32
            and ok.dtype in (torch.bool, torch.uint8)
            and coords2.shape == (n, 2)
            and c_axis.shape == levels.shape == ok.shape == values.shape):
        got = [(tuple(t.shape), t.dtype)
               for t in (coords2, c_axis, levels, values, ok)]
        raise TypeError(f"{name} on the card takes int32 coords2 (N, 2), "
                        f"int32 c_axis and levels (N,), float values (N,) "
                        f"and bool ok (N,); got {got}")
    return dense(coords2), dense(levels), dense(values), dense(ok)


def slice_coarse_levels(resolution: int) -> int:
    """Levels whose px² rectangle exceeds :data:`SLICE_OWN_AREA` at
    ``resolution``: the coarse levels, whose leaves the paint keys into
    cells (``coarse_levels`` in csrc/raster.cu)."""
    lvl = 0
    while (resolution >> lvl) ** 2 > SLICE_OWN_AREA:
        lvl += 1
    return lvl


def slice_coarse_cells(resolution: int) -> int:
    """Cells of the coarse levels' grids: sum of 4^l over them."""
    return ((1 << 2 * slice_coarse_levels(resolution)) - 1) // 3


def _slice_keys(dev: int, device: torch.device, resolution: int):
    """``(key, keys)``: the all-zero key scratch of ``_SLICE_KEYS`` for a
    call on CUDA device ``dev``'s current stream, made on first use:
    R² pixel keys, :func:`slice_coarse_cells` cell keys, one slot for the
    counter and the mask."""
    key = (dev, current_stream(dev), resolution)
    keys = _SLICE_KEYS.get(key)
    if keys is None:
        keys = _SLICE_KEYS[key] = torch.zeros(
            resolution * resolution + slice_coarse_cells(resolution) + 1,
            dtype=torch.int64, device=device)
    return key, keys


def slice_raster(coords2, c_axis, levels, values, ok, *, position: float,
                 resolution: int, n_levels: int) -> torch.Tensor:
    """B1: (R, R) float64 slice image (deepest covering leaf, NaN where
    none); same contract as :func:`.ref.slice_raster_ref`.

    On the card one C call paints from the raw columns (as
    :func:`slice_raster_carry` takes them, float64 values) over the kept
    key scratch; the call allocates the image and runs no other torch
    op."""
    dev = device_index(coords2, c_axis, levels, values, ok)
    if dev < 0:
        return ref.slice_raster_ref(coords2, c_axis, levels, values, ok,
                                    position=position, resolution=resolution,
                                    n_levels=n_levels)
    _suffix("slice_raster", values, {torch.float64: "_f64"})
    c2, lvl, val, okb = _slice_columns("slice_raster", coords2, c_axis,
                                       levels, values, ok)
    scratch, keys = _slice_keys(dev, values.device, resolution)
    img = torch.empty((resolution, resolution), dtype=torch.float64,
                      device=values.device)
    try:
        launch("raster_slice_f64", dev, c2.data_ptr(), c_axis.data_ptr(),
               c_axis.stride(0), lvl.data_ptr(), okb.data_ptr(),
               val.data_ptr(), val.shape[0], resolution, n_levels, position,
               keys.data_ptr(), img.data_ptr())
    except RuntimeError:
        _SLICE_KEYS.pop(scratch, None)    # may hold a paint, unresolved
        raise
    LAUNCHES["slice_raster"] += 1
    return img


def slice_raster_carry(coords2, c_axis, levels, values, ok, *,
                       position: float, resolution: int, n_levels: int,
                       init=None):
    """B4: the table painted over ``init=(img0, depth0)``; returns the
    ``(image, depth)`` pair (the values' dtype, int32). Same contract as
    :func:`.ref.slice_raster_depth_ref`; ``init=None`` seeds NaN / -1.
    The winner is the largest (level, row), so one call over a shard
    gives the bits of any chain of its tiles.

    On the card the kernel reads the raw columns — int32 ``coords2`` (N,
    2), ``c_axis`` (any stride) and ``levels``, float64 or float32
    ``values``, bool or uint8 ``ok`` — and makes the leaf table itself,
    so the tile sees no torch op but the two output allocations. The
    float32 kernel tests the slice plane in float32, ``position``
    rounded to float32 here.
    """
    if init is None:
        init = (torch.full((resolution, resolution), float("nan"),
                           dtype=values.dtype, device=values.device),
                torch.full((resolution, resolution), -1, dtype=torch.int32,
                           device=values.device))
    dev = device_index(coords2, c_axis, levels, values, ok, *init)
    if dev < 0:
        return ref.slice_raster_depth_ref(
            coords2, c_axis, levels, values, ok, position=position,
            resolution=resolution, n_levels=n_levels, init=init)
    fx = _suffix("slice_raster_carry", values)
    img0, depth0 = _seed(init, resolution, (values.dtype, torch.int32))
    c2, lvl, val, okb = _slice_columns("slice_raster_carry", coords2, c_axis,
                                       levels, values, ok)
    scratch, keys = _slice_keys(dev, values.device, resolution)
    img = torch.empty_like(img0)
    depth = torch.empty_like(depth0)
    try:
        launch("raster_slice_carry" + fx, dev, c2.data_ptr(),
               c_axis.data_ptr(), c_axis.stride(0), lvl.data_ptr(),
               okb.data_ptr(), val.data_ptr(), val.shape[0], resolution,
               n_levels, position if fx == "_f64" else round_f32(position),
               keys.data_ptr(), img0.data_ptr(), depth0.data_ptr(),
               img.data_ptr(), depth.data_ptr())
    except RuntimeError:
        _SLICE_KEYS.pop(scratch, None)    # may hold a paint, unresolved
        raise
    _count("slice_raster_carry", fx)
    return img, depth


def _projection_scratch(device: torch.device, resolution: int,
                        n_levels: int, n: int):
    """``(key, [zeros, offsets, rows])``: B2/B5's scratch for a call on
    CUDA ``device``, made on the first call per key and its rows grown to
    ``n``."""
    key = (device.index, current_stream(device.index), resolution, n_levels)
    scratch = _PROJ_SCRATCH.get(key)
    if scratch is None:
        total = ref.level_bases(n_levels, resolution.bit_length() - 1)[-1]
        cells = (total // SCAN_CHUNK + 1) * SCAN_CHUNK
        if cells >= 2 ** 31:
            raise ValueError(f"projection pyramid of {total} cells (R="
                             f"{resolution}, {n_levels} levels) exceeds "
                             f"the kernels' int32 cell index")
        scratch = _PROJ_SCRATCH[key] = [
            torch.zeros(cells + cells // SCAN_CHUNK, dtype=torch.int32,
                        device=device),
            torch.empty(cells, dtype=torch.int64, device=device), None]
    if scratch[2] is None or scratch[2].numel() < ROW_WORDS * n:
        scratch[2] = torch.empty(ROW_WORDS * max(n, 1), dtype=torch.int32,
                                 device=device)
    return key, scratch


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor, cast or copied only when it
    is not one already."""
    return dense(t) if t.dtype == dtype else t.to(dtype).contiguous()


def _projection(entry: str, dev: int, coords2, levels, values, ok,
                resolution: int, n_levels: int, img0=None,
                tile: int = 0) -> torch.Tensor:
    """One C call of B2 (``img0`` None) or B5 (``img0`` the (R, R) seed
    in the values' dtype, ``tile`` the chain's tile rows, 0 for none):
    the CSR is built on the card from the raw columns — int32 coords2
    (N, 2) and levels, the values in the entry's dtype, bool or uint8 ok
    — then projected; only the output is allocated, in the values'
    dtype."""
    n = values.shape[0]
    if coords2.shape != (n, 2) or not \
            (levels.shape == ok.shape == values.shape == (n,)):
        got = [tuple(t.shape) for t in (coords2, levels, values, ok)]
        raise ValueError(f"projection takes coords2 (N, 2) and levels, "
                         f"values, ok (N,); got {got}")
    if n > MAX_ROWS:
        raise ValueError(f"projection of {n} rows exceeds the kernels' "
                         f"int32 row index")
    # the casts' results stay referenced until the call has returned
    c2, lvl, val = (_as(coords2, torch.int32), _as(levels, torch.int32),
                    dense(values))
    okb = dense(ok) if ok.dtype in (torch.bool, torch.uint8) else \
        ok.to(torch.uint8).contiguous()
    key, (zeros, offsets, rows) = _projection_scratch(
        values.device, resolution, n_levels, n)
    img = torch.empty((resolution, resolution), dtype=values.dtype,
                      device=values.device)
    try:
        launch(entry, dev, c2.data_ptr(), lvl.data_ptr(), okb.data_ptr(),
               val.data_ptr(), n, resolution, n_levels, zeros.data_ptr(),
               offsets.data_ptr(), rows.data_ptr(),
               *(() if img0 is None else (img0.data_ptr(), tile)),
               img.data_ptr())
    except RuntimeError:
        _PROJ_SCRATCH.pop(key, None)       # its counts may not be zero
        raise
    return img


def projection_raster(coords2, levels, values, ok, *, resolution: int,
                      n_levels: int) -> torch.Tensor:
    """B2: (R, R) float64 column density; same contract as
    :func:`.ref.projection_raster_ref`. On the card one C call builds
    the (level, cell) CSR from the raw columns and projects."""
    dev = device_index(coords2, levels, values, ok)
    if dev < 0:
        return ref.projection_raster_ref(coords2, levels, values, ok,
                                         resolution=resolution,
                                         n_levels=n_levels)
    _suffix("projection_raster", values, {torch.float64: "_f64"})
    img = _projection("raster_projection_f64", dev, coords2, levels, values,
                      ok, resolution, n_levels)
    LAUNCHES["projection_raster"] += 1
    return img


def projection_raster_carry(coords2, levels, values, ok, *, resolution: int,
                            n_levels: int, init=None,
                            tile_n: int | None = None) -> torch.Tensor:
    """B5: the table's column density added over the seed ``init`` (in
    the values' dtype, zeros if None); same contract as
    :func:`.ref.projection_raster_ref` with ``init`` and ``tile_n``, and
    B2's one C call on the card, in float64 or float32.

    ``tile_n``: the bits of the table chained in ``tile_n``-row tiles
    (the twins' chain). On the card it is one call all the same: the
    per-pixel adds run in (level, row) order, which is the chain's
    (tile, level, row) order whenever the kept rows (ok, 0 <= level <
    n_levels) are level-sorted — every AMR tree's BFS table and every
    ``MeshTable`` shard; a pixel where it is not re-adds from its seed in
    the chain's order (``projection_kernel`` in csrc/raster.cu)."""
    if init is None:
        init = torch.zeros((resolution, resolution), dtype=values.dtype,
                           device=values.device)
    if tile_n is not None and tile_n < 1:
        raise ValueError(f"tile_n must be positive, got {tile_n}")
    dev = device_index(coords2, levels, values, ok, init)
    if dev < 0:
        return ref.projection_raster_ref(coords2, levels, values, ok,
                                         resolution=resolution,
                                         n_levels=n_levels, init=init,
                                         tile_n=tile_n)
    fx = _suffix("projection_raster_carry", values)
    (img0,) = _seed((init,), resolution, (values.dtype,))
    img = _projection("raster_projection_carry" + fx, dev, coords2, levels,
                      values, ok, resolution, n_levels, img0, tile_n or 0)
    _count("projection_raster_carry", fx)
    return img


def _hist_edges(dev: int, edges: torch.Tensor, device: torch.device):
    """``(edges, on_host)`` for a B3 call on CUDA device ``dev``: float64
    contiguous edges on the CPU (up to :data:`HIST_PARAM_EDGES`, which the
    C entry passes by value) or on ``device``; more CPU edges than that
    are copied to ``device``. Raises for edges on any other device."""
    if edges.device.type != "cpu" and edges.get_device() != dev:
        raise ValueError(f"level_hist takes its edges on the CPU or on the "
                         f"values' device ({device}), got {edges.device}")
    edges = _as(edges, torch.float64)
    if edges.device.type == "cpu":
        if edges.numel() <= HIST_PARAM_EDGES:
            return edges, 1
        edges = edges.to(device)
    return edges, 0


def level_hist(values, levels, ok, edges, *, n_levels: int) -> torch.Tensor:
    """B3: (L, B) int32 per-level histogram; same contract as
    :func:`.ref.level_hist_ref`. On the card float64 or float32 values,
    binned against float64 edges, which may lie on the CPU (up to
    :data:`HIST_PARAM_EDGES` cross by value: nothing is copied to the
    card) or on the values' device. One C call launches one kernel, which
    fills the zeroed output the previous call on the stream left in
    ``_HIST_NEXT`` and zeroes the one this call allocates for the next;
    the call runs no other torch op (the first call per stream and shape
    makes its output with ``torch.zeros``)."""
    dev = device_index(values, levels, ok)
    if dev < 0:
        on_cuda(values, edges)        # raises unless the edges are on the CPU
        return ref.level_hist_ref(values, levels, ok, edges,
                                  n_levels=n_levels)
    fx = _suffix("level_hist", values)
    bins = edges.shape[-1] - 1
    cells = n_levels * bins
    if cells >= 2 ** 31:
        raise ValueError(f"level_hist of {n_levels} levels x {bins} bins "
                         f"exceeds the kernel's int32 cell index")
    edg, on_host = _hist_edges(dev, edges, values.device)
    # bool ``ok`` is read as its uint8 bytes: no cast kernel
    val, lvl = dense(values), _as(levels, torch.int32)
    okb = dense(ok) if ok.dtype in (torch.bool, torch.uint8) else \
        ok.to(torch.uint8).contiguous()
    key = (dev, current_stream(dev), n_levels, bins)
    hist = _HIST_NEXT.pop(key, None)
    if hist is None:
        hist = torch.zeros((n_levels, bins), dtype=torch.int32,
                           device=values.device)
    nxt = torch.empty((n_levels, bins), dtype=torch.int32,
                      device=values.device)
    launch("raster_level_hist" + fx, dev, val.data_ptr(), lvl.data_ptr(),
           okb.data_ptr(), edg.data_ptr(), on_host, val.shape[0], n_levels,
           bins, hist.data_ptr(), nxt.data_ptr())
    _HIST_NEXT[key] = nxt
    _count("level_hist", fx)
    return hist
