"""CUDA raster kernels B1-B3 for the in-transit device-reduce path.

Wrappers around the hand-written kernels in ``csrc/raster.cu`` (see the
header there for the designs), the leaf-table geometry they consume and
the launch counters. Each wrapper takes the same arguments as its plain
twin in :mod:`.ref`: a CPU tensor runs the twin, a CUDA tensor launches
the kernel or raises — there is no fallback.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` (a
plain C interface, loaded with ``ctypes``), named by a hash of the
source so an edited kernel is rebuilt. The library goes to
``$REPRO_TORCH_BUILD_DIR`` if set, else ``build/repro_torch/`` of the
source checkout this module runs from, else ``repro_torch`` under the
user's cache directory (an installed copy).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "raster.cu"
CHECKOUT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel launches per wrapper; each wrapper adds one where it launches
LAUNCHES = {"slice_raster": 0, "projection_raster": 0, "level_hist": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the raster kernels "
                       "are built from source at first use")


def build_dir() -> Path:
    """Where the compiled library goes (see the module docstring)."""
    if os.environ.get("REPRO_TORCH_BUILD_DIR"):
        return Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    if (CHECKOUT / "pyproject.toml").is_file() and \
            (CHECKOUT / "src" / "repro_torch").is_dir():
        return CHECKOUT / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


def build() -> Path:
    """Compile ``csrc/raster.cu`` (once per source hash); returns the .so."""
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    out_dir = build_dir()
    out = out_dir / f"libraster-{digest}.so"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.raster_slice_f64.argtypes = [p, p, p, p, p, p, i64, i32, p,
                                             p, p]
            lib.raster_projection_f64.argtypes = [p, p, p, i32, i32, i32,
                                                  p, p]
            lib.raster_level_hist_f64.argtypes = [p, p, p, p, i64, i32, i32,
                                                  p, p]
            for fn in (lib.raster_slice_f64, lib.raster_projection_f64,
                       lib.raster_level_hist_f64):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU ones; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"raster kernels need all inputs on one CUDA device "
                     f"or all on the CPU; got {sorted(map(str, kinds))}")


# ----------------------------------------------------------- leaf tables

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


def _in_range(levels: torch.Tensor, n_levels: int) -> torch.Tensor:
    return (levels >= 0) & (levels < n_levels)


# ----------------------------------------------------------------- kernels

def slice_raster(coords2, c_axis, levels, values, ok, *, position: float,
                 resolution: int, n_levels: int) -> torch.Tensor:
    """B1: (R, R) float64 slice image (deepest covering leaf, NaN where
    none); same contract as :func:`.ref.slice_raster_ref`."""
    if not _on_cuda(coords2, c_axis, levels, values, ok):
        return ref.slice_raster_ref(coords2, c_axis, levels, values, ok,
                                    position=position, resolution=resolution,
                                    n_levels=n_levels)
    dev = values.device
    lib = _load()
    u0, v0, px = (t.contiguous() for t in
                  leaf_table(coords2, levels, resolution=resolution))
    lvl = levels.to(torch.int32).contiguous()
    good = (ok & _in_range(lvl, n_levels)
            & plane_hit(c_axis, lvl, position, n_levels)
            ).to(torch.uint8).contiguous()
    val = values.to(torch.float64).contiguous()
    keys = torch.empty((resolution, resolution), dtype=torch.int64,
                       device=dev)
    img = torch.empty((resolution, resolution), dtype=torch.float64,
                      device=dev)
    with torch.cuda.device(dev):
        _check(lib.raster_slice_f64(
            _ptr(u0), _ptr(v0), _ptr(px), _ptr(lvl), _ptr(good), _ptr(val),
            val.shape[0], resolution, _ptr(keys), _ptr(img), _stream(dev)),
            "slice_raster")
    LAUNCHES["slice_raster"] += 1
    return img


def projection_csr(coords2, levels, ok, *, resolution: int, n_levels: int):
    """Valid leaves grouped by (level, cell) in row order: ``(order,
    offsets)`` with ``order`` int32 rows and ``offsets`` the int64 CSR
    over the pyramid cells of :func:`.ref.level_cells`."""
    k = resolution.bit_length() - 1
    total = ref.level_bases(n_levels, k)[-1]
    lvl = levels.to(torch.int64)
    valid = ok & _in_range(lvl, n_levels)
    key = torch.where(valid, ref.level_cells(coords2, levels,
                                             resolution=resolution,
                                             n_levels=n_levels),
                      torch.full_like(lvl, total))
    sorted_key, perm = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(total + 1, dtype=torch.int64,
                                 device=key.device))
    return perm.to(torch.int32), offsets


def projection_raster(coords2, levels, values, ok, *, resolution: int,
                      n_levels: int) -> torch.Tensor:
    """B2: (R, R) float64 column density; same contract as
    :func:`.ref.projection_raster_ref`."""
    if not _on_cuda(coords2, levels, values, ok):
        return ref.projection_raster_ref(coords2, levels, values, ok,
                                         resolution=resolution,
                                         n_levels=n_levels)
    dev = values.device
    lib = _load()
    order, offsets = projection_csr(coords2, levels, ok,
                                    resolution=resolution, n_levels=n_levels)
    val = values.to(torch.float64).contiguous()
    img = torch.empty((resolution, resolution), dtype=torch.float64,
                      device=dev)
    with torch.cuda.device(dev):
        _check(lib.raster_projection_f64(
            _ptr(val), _ptr(order), _ptr(offsets), resolution,
            resolution.bit_length() - 1, n_levels, _ptr(img), _stream(dev)),
            "projection_raster")
    LAUNCHES["projection_raster"] += 1
    return img


def level_hist(values, levels, ok, edges, *, n_levels: int) -> torch.Tensor:
    """B3: (L, B) int32 per-level histogram; same contract as
    :func:`.ref.level_hist_ref`."""
    if not _on_cuda(values, levels, ok, edges):
        return ref.level_hist_ref(values, levels, ok, edges,
                                  n_levels=n_levels)
    dev = values.device
    lib = _load()
    bins = edges.shape[-1] - 1
    val = values.to(torch.float64).contiguous()
    lvl = levels.to(torch.int32).contiguous()
    okb = ok.to(torch.uint8).contiguous()
    edg = edges.to(torch.float64).contiguous()
    hist = torch.empty((n_levels, bins), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _check(lib.raster_level_hist_f64(
            _ptr(val), _ptr(lvl), _ptr(okb), _ptr(edg), val.shape[0],
            n_levels, bins, _ptr(hist), _stream(dev)), "level_hist")
    LAUNCHES["level_hist"] += 1
    return hist
