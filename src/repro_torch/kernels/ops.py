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
