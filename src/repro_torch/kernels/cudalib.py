"""Build and load the port's CUDA kernels; the helpers their wrappers share.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together) and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The
library is named by a hash over all the sources, so an edited kernel is
rebuilt. It goes to ``$REPRO_TORCH_BUILD_DIR`` if set, else
``build/repro_torch/`` of the source checkout this module runs from,
else ``repro_torch`` under the user's cache directory (an installed
copy).

Every wrapper launches through :func:`launch`, whose per-call cost is
the ctypes call itself: the function handles are looked up once when the
library loads, pointers travel as plain ints (``data_ptr()``), the stream
as the raw ``cudaStream_t`` int, and the C entry, not a Python context
manager, makes the tensors' device current for the launch and restores
the caller's device before it returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
CHECKOUT = Path(__file__).resolve().parents[3]
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_p, _i32, _i64, _f32, _f64 = (ctypes.c_void_p, ctypes.c_int32,
                             ctypes.c_int64, ctypes.c_float, ctypes.c_double)
#: the library's C functions and their argument types; every entry ends
#: with the device index and the stream and returns the launch's
#: cudaError_t as an int
SIGNATURES = {
    # csrc/raster.cu
    "raster_slice_f64": [_p, _p, _i64, _p, _p, _p, _i64, _i32, _i32, _f64,
                         _p, _p, _i32, _p],
    "raster_projection_f64": [_p, _p, _p, _p, _i64, _i32, _i32, _p, _p, _p,
                              _p, _i32, _p],
    "raster_level_hist_f64": [_p, _p, _p, _p, _i32, _i64, _i32, _i32, _p,
                              _p, _i32, _p],
    "raster_slice_carry_f64": [_p, _p, _i64, _p, _p, _p, _i64, _i32, _i32,
                               _f64, _p, _p, _p, _p, _p, _i32, _p],
    "raster_projection_carry_f64": [_p, _p, _p, _p, _i64, _i32, _i32, _p,
                                    _p, _p, _p, _i64, _p, _i32, _p],
    "raster_slice_carry_f32": [_p, _p, _i64, _p, _p, _p, _i64, _i32, _i32,
                               _f32, _p, _p, _p, _p, _p, _i32, _p],
    "raster_projection_carry_f32": [_p, _p, _p, _p, _i64, _i32, _i32, _p,
                                    _p, _p, _p, _i64, _p, _i32, _p],
    "raster_level_hist_f32": [_p, _p, _p, _p, _i32, _i64, _i32, _i32, _p,
                              _p, _i32, _p],
    # csrc/codec.cu
    "codec_encode_groups": [_p, _p, _p, _p, _i32, _i64, _i32, _i32, _p,
                            _i32, _p],
    "codec_decode_groups": [_p, _p, _p, _p, _i64, _p, _p, _i32, _p],
    "codec_bitpack": [_p, _i64, _p, _i32, _p],
    "codec_bitunpack": [_p, _i64, _p, _i32, _p],
}

_lib = None
_lib_lock = threading.Lock()
#: name -> the loaded library's function, filled once by :func:`lib`
_FNS: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
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


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_name() -> str:
    """``librepro_torch-<hash>.so``, the hash over the name and bytes of
    every source and header (``csrc/*.cu``, ``csrc/*.cuh``)."""
    digest = hashlib.sha1()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return f"librepro_torch-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one library (once per source
    hash); returns the .so."""
    out_dir = build_dir()
    out = out_dir / library_name()
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix=".build-", dir=out_dir))
    try:
        srcs = sources()
        objs = [work / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src}:\n{log}" for src, p, log in
                  zip(srcs, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        tmp = work / out.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {out.name}:\n"
                               f"{link.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library with every function of :data:`SIGNATURES`
    declared (built first if needed)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                # PyDLL: each call holds the interpreter lock, so its
                # launches reach the stream as one group (raster.py's B4
                # and B2/B5 scratch relies on it); a call lasts
                # microseconds
                loaded = ctypes.PyDLL(str(build()))
                for name, argtypes in SIGNATURES.items():
                    fn = getattr(loaded, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    _FNS[name] = fn
                _lib = loaded
    return _lib


def current_stream(device: int) -> int:
    """The raw ``cudaStream_t`` of CUDA device ``device``'s current
    stream, by the call torch's own generated kernels use: it builds no
    ``torch.cuda.Stream`` object, which costs more than the rest of a
    launch (PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(device)


def launch(name: str, device: int, *args) -> None:
    """Call the library's entry ``name`` with ``args`` (ints, pointers as
    ``data_ptr()``, and floats, in :data:`SIGNATURES`' order), then the
    device index and that device's current stream; raises if the entry
    returns a CUDA error."""
    fn = _FNS.get(name)
    if fn is None:
        lib()
        fn = _FNS[name]
    err = fn(*args, device, current_stream(device))
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def device_index(*tensors: torch.Tensor) -> int:
    """The index of the one CUDA device all ``tensors`` lie on, or -1 when
    all lie on the CPU; raises on a mix (see :func:`on_cuda`)."""
    dev = tensors[0].get_device()
    if dev >= 0:
        for t in tensors:
            if t.get_device() != dev:
                break
        else:
            return dev
    on_cuda(*tensors)
    return -1


def dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when contiguous, else a contiguous copy."""
    return t if t.is_contiguous() else t.contiguous()


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU ones; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"the kernels need all inputs on one CUDA device or "
                     f"all on the CPU; got {sorted(map(str, kinds))}")
