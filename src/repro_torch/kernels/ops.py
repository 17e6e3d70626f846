"""Device-reduction entry points over the raster kernels.

Same names and signatures as ``repro.kernels.ops``' raster entry points.
Each takes flat BFS node arrays — coords (N, 3) int, levels (N,) int,
values (N,) float64, ok (N,) bool (leaf ∧ owner ∧ not-padding) — plus
the reducer parameters, and returns the reduced object with bits
identical to the host numpy reducers. ``resolution`` must be a power of
two (integer pixel geometry; ``insitu.device`` takes the host reducer
otherwise).

Backends: ``cuda`` runs the hand-written kernels (``kernels/raster``)
and needs CUDA tensors; ``ref`` runs the plain torch twins
(``kernels/ref``) on any device; ``auto``/None calls the
``kernels/raster`` wrappers, which launch the kernel for CUDA tensors
and run the twin for CPU tensors.
"""
from __future__ import annotations

import torch

from . import raster, ref

BACKENDS = ("cuda", "ref")

#: the reference kernels' lane block: ``tile_n`` must be a multiple of it
BLOCK_N = 512


def _pick(backend: str | None, x: torch.Tensor, kernel, twin):
    """``twin`` for an explicit ``ref``, else the ``kernel`` wrapper."""
    if backend not in (None, "auto", *BACKENDS):
        raise ValueError(f"unknown raster backend {backend!r}; "
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


def raster_level_hist(values, levels, ok, edges, *, n_levels: int,
                      backend: str | None = None):
    """(n_levels, bins) int64 per-level histogram over ``edges``."""
    fn = _pick(backend, values, raster.level_hist, ref.level_hist_ref)
    hist = fn(values, levels.to(torch.int32), ok, edges, n_levels=n_levels)
    return hist.to(torch.int64)


# ------------------------------------------- partial (sharded/tiled) rasters

def raster_slice_partial(coords, levels, values, ok, *, axis: int,
                         position: float, resolution: int, n_levels: int,
                         backend: str | None = None, block_n: int = BLOCK_N,
                         tile_n: int | None = None):
    """Partial slice raster: ``(image, depth)`` for a leaf subset.

    ``depth`` is the painting leaf's level (-1 where uncovered), the
    mesh merge's depth-resolve key. Over the whole table the image is
    :func:`raster_slice`'s, bit for bit.
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
    return _run_tiles(tile, (plane_coords(coords, axis), coords[:, axis],
                             levels.to(torch.int32), values, ok), seed,
                      tile_n=tile_n, block_n=block_n)


def raster_projection_partial(coords, levels, values, ok, *, axis: int,
                              resolution: int, n_levels: int,
                              backend: str | None = None,
                              block_n: int = BLOCK_N,
                              tile_n: int | None = None):
    """Partial projection raster: a leaf subset's column-density image."""
    fn = _pick(backend, values, raster.projection_raster_carry,
               ref.projection_raster_ref)
    _assert_pow2(resolution)

    def tile(c2, lv, val, okk, img):
        return (fn(c2, lv, val, okk, resolution=resolution,
                   n_levels=n_levels, init=img),)

    seed = (torch.zeros((resolution, resolution), dtype=values.dtype,
                        device=values.device),)
    return _run_tiles(tile, (plane_coords(coords, axis),
                             levels.to(torch.int32), values, ok), seed,
                      tile_n=tile_n, block_n=block_n)[0]


def raster_level_hist_partial(values, levels, ok, edges, *, n_levels: int,
                              backend: str | None = None):
    """Partial per-level histogram: (L, B) int32 counts for a subset.

    Integer counts are order-free, so partials merge by a plain sum. No
    ``tile_n``: the kernel streams the table with an O(L·B) working set.
    """
    fn = _pick(backend, values, raster.level_hist, ref.level_hist_ref)
    return fn(values, levels.to(torch.int32), ok, edges, n_levels=n_levels)


def _run_tiles(tile_fn, arrays, seed, *, tile_n: int | None, block_n: int):
    """Drive ``tile_fn`` over the table once, or tile by tile in BFS
    order with the carry threaded through; the last tile is padded with
    ``ok=False`` rows so every tile has ``tile_n`` rows."""
    n = arrays[0].shape[0]
    if tile_n is None or n <= tile_n:
        return tile_fn(*arrays, *seed)
    if tile_n % block_n:
        raise ValueError(f"tile_n={tile_n} not a multiple of "
                         f"block_n={block_n}")
    carry = tuple(seed)
    for start in range(0, n, tile_n):
        cut = [a[start:start + tile_n] for a in arrays]
        short = tile_n - cut[0].shape[0]
        if short:
            cut = [torch.cat([a, a.new_zeros((short, *a.shape[1:]))])
                   for a in cut]
        carry = tuple(tile_fn(*cut, *carry))
    return carry
