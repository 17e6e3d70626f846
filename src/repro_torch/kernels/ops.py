"""Entry points over the CUDA kernels: device reduction and the codec.

Same names and signatures as ``repro.kernels.ops``' entry points.

Raster (device reduction): each takes flat BFS node arrays — coords
(N, 3) int, levels (N,) int, values (N,) float64, ok (N,) bool (leaf ∧
owner ∧ not-padding) — plus the reducer parameters, and returns the
reduced object with bits identical to the host numpy reducers. The
partial entry points also take float32 values (the mesh path's float32
tables) and keep them float32 throughout, bit-equal to the reference's
float32 partials.
``resolution`` must be a power of two (integer pixel geometry;
``insitu.device`` takes the host reducer otherwise).

Codec (paper §2.3 father–son XOR delta, and bitfields): 32-bit words
are ``torch.int32`` tensors holding the uint32 bit patterns (``uint32``
inputs are taken through ``.view(torch.int32)``); 64-bit payloads travel
as (hi, lo) word pairs in the reference's (S, G) layout, sons down,
groups across. ``compress_bits`` writes the host codec's
(``core.fpdelta.encode``) code and payload words, word for word.

Backends: ``cuda`` runs the hand-written kernels (``kernels/raster``,
``kernels/codec``) and needs CUDA tensors; ``ref`` runs the plain torch
twins (``kernels/ref``) on any device; ``auto``/None calls the kernel
wrappers, which launch the kernel for CUDA tensors and run the twin for
CPU tensors.
"""
from __future__ import annotations

import torch

from ..core import bitstream as bs
from . import codec, raster, ref

BACKENDS = ("cuda", "ref")

#: the reference kernels' lane block: ``tile_n`` must be a multiple of it
BLOCK_N = 512


def _pick(backend: str | None, x: torch.Tensor, kernel, twin):
    """``twin`` for an explicit ``ref``, else the ``kernel`` wrapper."""
    if backend not in (None, "auto", *BACKENDS):
        raise ValueError(f"unknown backend {backend!r}; "
                         f"use one of {BACKENDS} or 'auto'")
    if backend == "cuda" and not x.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; "
                         "use backend='ref' on the CPU")
    return twin if backend == "ref" else kernel


def _axes_uv(axis: int) -> tuple[int, int]:
    ax_u, ax_v = (a for a in range(3) if a != axis)
    return ax_u, ax_v


def _assert_pow2(resolution: int) -> None:
    if resolution <= 0 or resolution & (resolution - 1):
        raise ValueError(
            f"raster kernels need a power-of-two resolution, got "
            f"{resolution} (use the host reducer for arbitrary sizes)")


def plane_coords(coords: torch.Tensor, axis: int) -> torch.Tensor:
    """(N, 2) int32 in-plane coords: ``coords`` without the ``axis``
    column, in ascending axis order (the kernels' ``coords2``)."""
    ax_u, ax_v = _axes_uv(axis)
    return torch.stack([coords[:, ax_u], coords[:, ax_v]], 1).to(torch.int32)


def raster_slice(coords, levels, values, ok, *, axis: int, position: float,
                 resolution: int, n_levels: int, backend: str | None = None):
    """Axis-aligned slice image (deepest covering leaf, NaN elsewhere)."""
    fn = _pick(backend, values, raster.slice_raster, ref.slice_raster_ref)
    _assert_pow2(resolution)
    return fn(plane_coords(coords, axis), coords[:, axis],
              levels.to(torch.int32), values, ok, position=position,
              resolution=resolution, n_levels=n_levels)


def raster_projection(coords, levels, values, ok, *, axis: int,
                      resolution: int, n_levels: int,
                      backend: str | None = None):
    """Column density: per-leaf value · path length summed along ``axis``."""
    fn = _pick(backend, values, raster.projection_raster,
               ref.projection_raster_ref)
    _assert_pow2(resolution)
    return fn(plane_coords(coords, axis), levels.to(torch.int32), values, ok,
              resolution=resolution, n_levels=n_levels)


def _level_hist(backend, values, levels, ok, edges, n_levels: int):
    """B3 or, for ``backend="ref"``, its twin, which takes its edges on the
    values' device (the kernel's wrapper also takes them on the CPU)."""
    fn = _pick(backend, values, raster.level_hist, ref.level_hist_ref)
    if fn is ref.level_hist_ref:
        edges = edges.to(values.device)
    return fn(values, levels.to(torch.int32), ok, edges, n_levels=n_levels)


def raster_level_hist(values, levels, ok, edges, *, n_levels: int,
                      backend: str | None = None):
    """(n_levels, bins) int64 per-level histogram over ``edges`` (float64,
    on the CPU or on the values' device)."""
    return _level_hist(backend, values, levels, ok, edges,
                       n_levels).to(torch.int64)


# ------------------------------------------- partial (sharded/tiled) rasters

def raster_slice_partial(coords, levels, values, ok, *, axis: int,
                         position: float, resolution: int, n_levels: int,
                         backend: str | None = None, block_n: int = BLOCK_N,
                         tile_n: int | None = None):
    """Partial slice raster: ``(image, depth)`` for a leaf subset.

    ``depth`` is the painting leaf's level (-1 where uncovered), the
    mesh merge's depth-resolve key. Over the whole table the image is
    :func:`raster_slice`'s, bit for bit.

    On the card B4 paints the whole subset in one call (see
    :func:`_run_shard`): its winner is the largest (level, row), which is
    the tile chain's rule, so ``tile_n`` changes no bit; the twins chain
    ``tile_n``-row tiles.
    """
    fn = _pick(backend, values, raster.slice_raster_carry,
               ref.slice_raster_depth_ref)
    _assert_pow2(resolution)

    def tile(c2, ca, lv, val, okk, img, depth):
        return fn(c2, ca, lv, val, okk, position=position,
                  resolution=resolution, n_levels=n_levels,
                  init=(img, depth))

    dev = values.device
    seed = (torch.full((resolution, resolution), float("nan"),
                       dtype=values.dtype, device=dev),
            torch.full((resolution, resolution), -1, dtype=torch.int32,
                       device=dev))
    run = _run_shard if fn is raster.slice_raster_carry and values.is_cuda \
        else _run_tiles
    # int32 coords keep their strided axis column (B4 reads it in place)
    return run(tile, (plane_coords(coords, axis),
                      coords[:, axis].to(torch.int32),
                      levels.to(torch.int32), values, ok), seed,
               tile_n=tile_n, block_n=block_n)


def raster_projection_partial(coords, levels, values, ok, *, axis: int,
                              resolution: int, n_levels: int,
                              backend: str | None = None,
                              block_n: int = BLOCK_N,
                              tile_n: int | None = None):
    """Partial projection raster: a leaf subset's column-density image.

    On the card B5 projects the whole subset in one call (see
    :func:`_run_shard`) and keeps the ``tile_n``-row chain's add order
    per pixel, so its bits are the twins' chain's for any table. The
    call adds in (level, row) order, which is the chain's when the kept
    rows (ok, 0 <= level < n_levels) are level-sorted, as every AMR
    tree's BFS table and every ``MeshTable`` shard is; a pixel where it
    is not re-adds in the chain's order on the card.
    """
    fn = _pick(backend, values, raster.projection_raster_carry,
               ref.projection_raster_ref)
    _assert_pow2(resolution)
    run = _run_shard if fn is raster.projection_raster_carry and \
        values.is_cuda else _run_tiles

    # the one call keeps the chain's order from ``tile_n``; a twin call
    # of ``_run_tiles`` is one tile already
    def tile(c2, lv, val, okk, img):
        return (fn(c2, lv, val, okk, resolution=resolution,
                   n_levels=n_levels, init=img, tile_n=tile_n),)

    seed = (torch.zeros((resolution, resolution), dtype=values.dtype,
                        device=values.device),)
    return run(tile, (plane_coords(coords, axis), levels.to(torch.int32),
                      values, ok), seed, tile_n=tile_n, block_n=block_n)[0]


def raster_level_hist_partial(values, levels, ok, edges, *, n_levels: int,
                              backend: str | None = None):
    """Partial per-level histogram: (L, B) int32 counts for a subset.

    Integer counts are order-free, so partials merge by a plain sum. No
    ``tile_n``: the kernel streams the table with an O(L·B) working set.
    """
    return _level_hist(backend, values, levels, ok, edges, n_levels)


def _check_tile(n: int, tile_n: int | None, block_n: int) -> bool:
    """Whether ``n`` rows make several ``tile_n``-row tiles; raises for a
    ``tile_n`` that is not a multiple of ``block_n`` where it would."""
    if tile_n is None or n <= tile_n:
        return False
    if tile_n % block_n:
        raise ValueError(f"tile_n={tile_n} not a multiple of "
                         f"block_n={block_n}")
    return True


def _run_tiles(tile_fn, arrays, seed, *, tile_n: int | None, block_n: int):
    """The twins' chain: drive ``tile_fn`` over the table once, or tile by
    tile in BFS order with the carry threaded through; the last tile is
    padded with ``ok=False`` rows so every tile has ``tile_n`` rows.
    ``tile_n`` tiles only the twins (``backend="ref"`` or CPU tensors): on
    the card a shard is one call (:func:`_run_shard`)."""
    if not _check_tile(arrays[0].shape[0], tile_n, block_n):
        return tile_fn(*arrays, *seed)
    n = arrays[0].shape[0]
    carry = tuple(seed)
    for start in range(0, n, tile_n):
        cut = [a[start:start + tile_n] for a in arrays]
        short = tile_n - cut[0].shape[0]
        if short:
            cut = [torch.cat([a, a.new_zeros((short, *a.shape[1:]))])
                   for a in cut]
        carry = tuple(tile_fn(*cut, *carry))
    return carry


def _run_shard(call_fn, arrays, seed, *, tile_n: int | None, block_n: int):
    """The kernels' route: ``call_fn`` over the whole table in one call.

    Only the kernels' int32 row index cuts it: a table of more than
    ``raster.MAX_ROWS`` rows goes in calls of whole ``tile_n``-row tiles,
    chained through the carry (the calls keep the chain's order, so the
    bits stay the twins'); without ``tile_n`` the call raises there.
    Nothing pads the table, and a failed launch raises.
    """
    n = arrays[0].shape[0]
    _check_tile(n, tile_n, block_n)
    step = raster.MAX_ROWS
    if tile_n is None or n <= step:
        return tuple(call_fn(*arrays, *seed))
    step -= step % tile_n
    carry = tuple(seed)
    for start in range(0, n, step):
        carry = tuple(call_fn(*(a[start:start + step] for a in arrays),
                              *carry))
    return carry


# ------------------------------------------------------------------ codec

def _words(x) -> torch.Tensor:
    """``x`` as int32 words: int32 as is, uint32 reinterpreted."""
    x = torch.as_tensor(x)
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    if x.dtype != torch.int32:
        raise TypeError(f"codec words must be int32 or uint32, got {x.dtype}")
    return x


def encode_groups_bits(pred_hi, pred_lo, son_hi, son_lo, *, zbits: int = 4,
                       width: int = 64, backend: str | None = None):
    """Residues + group nlz from (S, G) words: returns (S, G) int32
    residues ``son ^ pred`` (hi, lo) and the (G,) int32 shared
    leading-zero counts clamped to ``2**zbits - 1``."""
    args = [_words(a) for a in (pred_hi, pred_lo, son_hi, son_lo)]
    fn = _pick(backend, args[0], codec.encode_groups, ref.group_residues_ref)
    return fn(*args, zbits, width)


def decode_groups_bits(res_hi, res_lo, pred_hi, pred_lo, *,
                       backend: str | None = None):
    """Son words ``res ^ pred`` (hi, lo) of (S, G) residues."""
    args = [_words(a) for a in (res_hi, res_lo, pred_hi, pred_lo)]
    fn = _pick(backend, args[0], codec.decode_groups, ref.decode_residues_ref)
    return fn(*args)


def _payload_lens(nlz: torch.Tensor, s: int, width: int) -> torch.Tensor:
    """Bits of each payload entry in stream order: group-major, then
    son-major, and at width 64 the son's lo word before its hi word."""
    nb = (width - nlz.to(torch.int64))[None, :].expand(s, -1)     # (S, G)
    if width == 64:
        lens = torch.stack([nb.clamp(max=32), (nb - 32).clamp(min=0)], 1)
        return lens.reshape(2 * s, -1).T.reshape(-1)
    return nb.clamp(max=width).T.reshape(-1)


def compress_bits(pred_hi, pred_lo, son_hi, son_lo, *, zbits: int = 4,
                  width: int = 64, backend: str | None = None):
    """Encode (S, G) words: B6 (``codec.encode_block``, whose one buffer
    holds the residues in stream order), then pack the codes and payload
    streams.

    Returns ``(code_words, payload_words, code_bits, payload_bits)``:
    int32 word arrays sized at the reference's upper bounds and the int64
    bit counts; the words up to ``ceil(bits / 32)`` are the host codec's.
    """
    args = [_words(a) for a in (pred_hi, pred_lo, son_hi, son_lo)]
    fn = _pick(backend, args[0], codec.encode_block,
               ref.group_residues_block_ref)
    block = fn(*args, zbits, width)
    s, g = args[3].shape
    nlz = block[2 * s * g:]
    code_words, code_bits = bs.pack_bits(
        nlz, torch.full_like(nlz, zbits),
        num_words=max(1, -(-g * zbits // 32)))
    # the block holds the payload values in stream order (B6's layout);
    # at widths 32 and 16 the lo words come first
    vals = block[:(2 if width == 64 else 1) * s * g]
    payload_words, payload_bits = bs.pack_bits(
        vals, _payload_lens(nlz, s, width),
        num_words=max(1, -(-g * s * width // 32)))
    return ref.i32(code_words), ref.i32(payload_words), code_bits, payload_bits


def decompress_bits(code_words, payload_words, pred_hi, pred_lo, *,
                    zbits: int = 4, width: int = 64,
                    backend: str | None = None):
    """Inverse of :func:`compress_bits` given the (S, G) predictor words:
    unpack the codes and the residues, then B7. Returns (son_hi, son_lo)."""
    pred_hi, pred_lo = _words(pred_hi), _words(pred_lo)
    s, g = pred_lo.shape
    dev = pred_lo.device
    nlz = bs.unpack_bits(_words(code_words),
                         torch.arange(g, device=dev) * zbits,
                         torch.full((g,), zbits, device=dev))
    lens = _payload_lens(nlz, s, width)
    flat = ref.i32(bs.unpack_bits(_words(payload_words),
                                  torch.cumsum(lens, 0) - lens, lens))
    if width == 64:
        pairs = flat.reshape(g, s, 2)
        res_lo, res_hi = pairs[..., 0].T, pairs[..., 1].T
    else:
        res_lo = flat.reshape(g, s).T
        res_hi = torch.zeros_like(res_lo)
    return decode_groups_bits(res_hi, res_lo, pred_hi, pred_lo,
                              backend=backend)


def bitfield_pack(bits, *, backend: str | None = None) -> torch.Tensor:
    """(N,) flags (nonzero = set) -> ceil(N/32) int32 words; bit i of
    word w is flag 32w + i."""
    bits = torch.as_tensor(bits).reshape(-1)
    if bits.dtype not in (torch.uint8, torch.bool):
        bits = bits != 0
    fn = _pick(backend, bits, codec.bitpack, ref.bitpack_ref)
    return fn(bits)


def bitfield_unpack(words, n: int, *,
                    backend: str | None = None) -> torch.Tensor:
    """The first ``n`` flags of ``words``, uint8 {0, 1}."""
    words = _words(words).reshape(-1)
    fn = _pick(backend, words, codec.bitunpack, ref.bitunpack_ref)
    return fn(words, n)


# ------------------------------------------------ float <-> word conveniences

def f32_bits(x) -> torch.Tensor:
    """float32 bit patterns (int32) of ``x``; wider floats round to
    nearest even. A float64 NaN keeps its sign and top payload bits,
    quieted (the x86 conversion, which the reference gives on the CPU),
    on any device."""
    x = torch.as_tensor(x)
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    x = x.to(torch.float64)
    b = x.view(torch.int64)
    nan = ((b >> 32) & 0x80000000) | 0x7FC00000 | ((b >> 29) & 0x7FFFFF)
    return ref.i32(torch.where(torch.isnan(x), nan,
                               ref.u32(x.to(torch.float32).view(torch.int32))))


def bits_f32(w) -> torch.Tensor:
    return _words(w).view(torch.float32)


def bf16_bits(x) -> torch.Tensor:
    """bfloat16 bit patterns of ``x`` widened to int32 (high 16 bits 0).

    Other floats round to float32 (:func:`f32_bits`), then to nearest
    even bfloat16; NaN becomes 0x7FC0, or 0xFFC0 with the sign bit, as
    the reference's conversion gives.
    """
    x = torch.as_tensor(x)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    b = ref.u32(f32_bits(x))
    rne = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    nan = torch.where(b >= 0x80000000, 0xFFC0, 0x7FC0)
    return torch.where((b & 0x7FFFFFFF) > 0x7F800000, nan, rne) \
        .to(torch.int32)


def bits_bf16(w) -> torch.Tensor:
    """The bfloat16 tensor whose bits are the low 16 bits of ``w``."""
    low = ref.u32(_words(w)) & 0xFFFF
    return torch.where(low >= 1 << 15, low - (1 << 16), low) \
        .to(torch.int16).view(torch.bfloat16)


def f64_bits(x) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 words of float64 ``x`` (the host codec's
    ``bitstream.f64_to_pair``)."""
    x = torch.as_tensor(x, dtype=torch.float64).contiguous()
    w = x.view(torch.int32).reshape(*x.shape, 2)      # little-endian words
    return w[..., 1], w[..., 0]
