"""On-device reduction: device staging + device reducers (DESIGN.md §14).

The host engine's staging copies every snapshot to host memory *before*
any reduction — a full-resolution device→host transfer per staged step,
exactly the bottleneck the paper's in-transit architecture exists to
remove. This module keeps the snapshot on the GPU end to end:

  * :class:`DeviceStagingArea` — the bounded-ring/backpressure staging
    area with **device-resident** buffer sets: a pushed tensor is cloned
    device to device, a host array is uploaded once; nothing crosses
    back to the host until a reducer has shrunk it.
  * a **device-reducer registry** (:func:`register_device_impl`) mapping
    the reducer classes to device implementations built on the CUDA
    raster kernels (``kernels/raster``, selected through
    ``kernels.ops``): axis-aligned slice, projection with owner masking,
    per-level histogram, plus the LOD cut as a device prefix slice. The
    reduced objects are bit-identical to the host reducers.
  * :class:`DeviceDAGRunner` — executes the engine's ReducerDAG with
    device implementations where registered and a **per-reducer host
    fallback** everywhere else (the full snapshot is materialized on
    host at most once per step, and only if some reducer needs it),
    while accounting every device→host byte (``stats``).

Wired in through ``InTransitEngine(device_reduce=True, device=...)``:
the thread backend stages into :class:`DeviceStagingArea` and lanes run
the DAG through the runner. Everything stays float64 (Hopper has native
f64). ``device="cpu"`` runs the same path on CPU tensors through the
kernels' plain torch twins.

Device impl factories return ``None`` for configs the kernels do not
cover — non-power-of-two resolutions (the kernels' pixel geometry is
exact integer arithmetic). Reducers chained on an upstream ``source``
run on host but read only that upstream's already-transferred output,
so they never force a snapshot materialization.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..obs.trace import TRACER
from .reducers import (LevelHistogramReducer, LODCutReducer,
                       ProjectionReducer, ReducerDAG, SliceReducer)
from .staging import Snapshot, StagingArea, host_array

#: leaf-table padding bucket: tables grow and shrink in whole buckets
#: as the AMR tree changes size every step
PAD_BUCKET = 4096


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def _padded(n: int) -> int:
    return -(-n // PAD_BUCKET) * PAD_BUCKET


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def resolve_device(device=None) -> torch.device:
    """The device the device-reduce path runs on.

    ``None`` means the GPU; without one, this raises rather than carry on
    quietly on the CPU — pass ``device="cpu"`` to ask for the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device reduction needs a CUDA device and none is available; "
            "pass device='cpu' to run the device-reduce path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(arrays: dict, device) -> dict[str, torch.Tensor]:
    """A snapshot (numpy arrays or tensors) as tensors on ``device``.

    Always a copy, never a view of the input, so the producer may reuse
    or mutate its arrays as soon as this returns; on a GPU the copies
    are complete on return.
    """
    dev = torch.device(device)
    out = {}
    for name, src in arrays.items():
        if isinstance(src, torch.Tensor):
            out[name] = src.detach().to(dev, copy=True)
        else:
            out[name] = torch.tensor(np.asarray(src), device=dev)
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return out


# ------------------------------------------------------- device staging

class _DeviceBufferSet:
    """Device-resident twin of the host ``_BufferSet``.

    A tensor push is restaged through a **device→device clone** — it
    never crosses to the host, but it must not be a bare reference: the
    producer may overwrite or free its tensor while the snapshot is
    still queued. Device restages count as buffer reuses (no host
    crossing), host uploads as allocs. :func:`to_device` finishes the
    copies before returning, which keeps the ``push`` contract that
    compute may mutate its arrays the moment push returns.
    """

    def __init__(self, device: torch.device):
        self.device = device

    def fill(self, arrays: dict):
        out = to_device(arrays, self.device)
        reuses = sum(isinstance(v, torch.Tensor) and v.device == self.device
                     for v in arrays.values())
        nbytes = sum(_nbytes(v) for v in out.values())
        # not retained: the Snapshot owns the only reference, so
        # release() really frees the device memory
        return out, reuses, len(out) - reuses, nbytes


class DeviceStagingArea(StagingArea):
    """StagingArea whose staged snapshots live on ``device``.

    Same bounded queue, policies, stats and ``on_evict`` contract as the
    host area (it *is* the host area — only the buffer residency
    changes); ``Snapshot.arrays`` values are torch tensors.
    """

    def __init__(self, *, device=None, **kw):
        self.device = resolve_device(device)
        self.BUFFER_SET = functools.partial(_DeviceBufferSet, self.device)
        super().__init__(**kw)


# ------------------------------------------------------------- prep

class DeviceTree:
    """Per-snapshot device view shared by all device reducer impls.

    Lazily derives the flat rasterization inputs from the staged BFS
    tree tensors — per-node levels (from ``level_offsets``, which never
    leaves the device), the owned-leaf validity mask, int32 coords —
    padded to :data:`PAD_BUCKET`. Padding rows carry ``ok=False``.
    """

    def __init__(self, arrays: dict, n_domains: int, count_to_host=None):
        self.arrays = arrays
        self.n_domains = n_domains
        self.count_to_host = count_to_host or (lambda nbytes: None)
        self.n_levels = int(arrays["level_offsets"].shape[0]) - 1
        self._geom = None
        self._fields: dict = {}

    @staticmethod
    def _pad(x: torch.Tensor, fill) -> torch.Tensor:
        n = x.shape[0]
        pad = _padded(n) - n
        if pad == 0:
            return x
        tail = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    def _prep(self):
        if self._geom is None:
            refine = self.arrays["refine"]
            n = int(refine.shape[0])
            offsets = self.arrays["level_offsets"]
            rows = torch.arange(n, dtype=offsets.dtype, device=offsets.device)
            levels = (torch.searchsorted(offsets, rows, right=True)
                      .to(torch.int32) - 1)
            ok = ~refine
            if self.n_domains > 1:   # partitioned: owned leaves count once
                ok = ok & self.arrays["owner"]
            coords = self.arrays["coords"].to(torch.int32)
            self._geom = (self._pad(coords, 0), self._pad(levels, 0),
                          self._pad(ok, False))
        return self._geom

    @property
    def coords(self):
        return self._prep()[0]

    @property
    def levels(self):
        return self._prep()[1]

    @property
    def ok(self):
        """Valid-leaf mask: leaf ∧ (owner when partitioned) ∧ ¬padding."""
        return self._prep()[2]

    def field(self, name: str):
        if name not in self._fields:
            self._fields[name] = self._pad(self.arrays[f"field:{name}"], 0)
        return self._fields[name]


# ----------------------------------------------------- impl registry

#: reducer class -> factory(reducer) -> impl(DeviceTree) -> dict | None
DEVICE_IMPLS: dict[type, object] = {}


def register_device_impl(reducer_cls: type):
    """Register (or replace) the device factory for one reducer class.

    The factory receives the reducer *instance* and returns either a
    callable ``impl(device_tree) -> dict of arrays`` or ``None`` when
    this configuration must fall back to the host implementation.
    """
    def deco(factory):
        DEVICE_IMPLS[reducer_cls] = factory
        return factory
    return deco


def device_impl_for(reducer):
    """Resolve one reducer instance to its device impl (or None)."""
    factory = DEVICE_IMPLS.get(type(reducer))
    return factory(reducer) if factory is not None else None


@register_device_impl(SliceReducer)
def _slice_impl(r: SliceReducer):
    if r.source is not None or not _pow2(r.resolution):
        return None

    def run(dt: DeviceTree):
        from ..kernels import ops
        img = ops.raster_slice(dt.coords, dt.levels, dt.field(r.field),
                               dt.ok, axis=r.axis, position=r.position,
                               resolution=r.resolution,
                               n_levels=dt.n_levels)
        return {"image": img}
    return run


@register_device_impl(ProjectionReducer)
def _projection_impl(r: ProjectionReducer):
    if r.source is not None or not _pow2(r.resolution):
        return None

    def run(dt: DeviceTree):
        from ..kernels import ops
        img = ops.raster_projection(dt.coords, dt.levels, dt.field(r.field),
                                    dt.ok, axis=r.axis,
                                    resolution=r.resolution,
                                    n_levels=dt.n_levels)
        return {"image": img}
    return run


@register_device_impl(LODCutReducer)
def _lod_impl(r: LODCutReducer):
    """Device-side LOD cut: slice the BFS prefix, demote the new floor.

    ``keep = levels <= max_level`` is a *prefix* of the level-major BFS
    arrays, so the host path's ``subset_tree`` selection is an identity
    re-index over the first ``offsets[max_level+1]`` rows: the cut is a
    device-side slice plus a ``refine=False`` stamp on the new deepest
    level (the host's ``force_leaf`` demotion). Only ``level_offsets``
    (a few dozen bytes, counted as meta) crosses to the host to size
    the slices; the cut tree itself crosses only as the reducer output.
    """
    def run(dt: DeviceTree):
        offs = host_array(dt.arrays["level_offsets"]).astype(np.int64)
        dt.count_to_host(offs.nbytes)
        if len(offs) - 1 <= r.max_level + 1:
            return dict(dt.arrays)          # already at/below the cut
        n_keep = int(offs[r.max_level + 1])
        new_offs = offs[:r.max_level + 2].copy()
        # trim now-empty deepest levels, exactly like subset_tree
        n_lv = len(new_offs) - 1
        while n_lv > 1 and new_offs[n_lv] == new_offs[n_lv - 1]:
            n_lv -= 1
        refine = dt.arrays["refine"][:n_keep].clone()
        refine[int(offs[r.max_level]):n_keep] = False
        out = {"refine": refine, "level_offsets": new_offs[:n_lv + 1]}
        for k, v in dt.arrays.items():
            if k not in out and k != "level_offsets":
                out[k] = v[:n_keep]
        return out
    return run


@register_device_impl(LevelHistogramReducer)
def _hist_impl(r: LevelHistogramReducer):
    def run(dt: DeviceTree):
        from ..kernels import ops
        v = dt.field(r.field)
        if r.lo is None or r.hi is None:
            # auto bounds: one device min/max pair, a single 16-byte pull
            # instead of the whole field
            inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
            mm = torch.stack([torch.where(dt.ok, v, inf).min(),
                              torch.where(dt.ok, v, -inf).max()]).cpu()
            lo = float(mm[0]) if r.lo is None else r.lo
            hi = float(mm[1]) if r.hi is None else r.hi
            dt.count_to_host(16)
        else:
            lo, hi = r.lo, r.hi
        if hi <= lo:
            hi = lo + 1.0
        edges = np.linspace(lo, hi, r.bins + 1)
        hist = ops.raster_level_hist(
            v, dt.levels, dt.ok, torch.from_numpy(edges).to(v.device),
            n_levels=min(dt.n_levels, r.max_levels))
        return {"hist": hist, "edges": edges}
    return run


# ------------------------------------------------------------ runner

class DeviceRunStats:
    """Device→host transfer accounting for the device-reduce path."""

    def __init__(self):
        self.snapshots = 0                 # snapshots run through the DAG
        self.device_objects = 0            # reduced objects computed on device
        self.bytes_reduced_to_host = 0     # transferred reduced outputs
        self.bytes_meta_to_host = 0        # scalar pulls (auto hist bounds)
        self.fallback_snapshots = 0        # snapshots materialized on host
        self.bytes_fallback_to_host = 0    # full-snapshot fallback transfers
        self.fallback_runs: dict[str, int] = {}   # per-reducer host runs

    def as_dict(self) -> dict:
        return {"snapshots": self.snapshots,
                "device_objects": self.device_objects,
                "bytes_reduced_to_host": self.bytes_reduced_to_host,
                "bytes_meta_to_host": self.bytes_meta_to_host,
                "fallback_snapshots": self.fallback_snapshots,
                "bytes_fallback_to_host": self.bytes_fallback_to_host,
                "fallback_runs": dict(self.fallback_runs),
                "bytes_to_host": (self.bytes_reduced_to_host
                                  + self.bytes_meta_to_host
                                  + self.bytes_fallback_to_host)}


class DeviceDAGRunner:
    """Execute a ReducerDAG with device impls + per-reducer host fallback.

    Drop-in for ``ReducerDAG.run`` on the engine's lane side: same kind
    filtering, dependency skipping and output shape. Reducers with a
    registered device impl reduce on the device and transfer only their
    outputs; the rest see a host snapshot materialized at most once per
    step (and tensor reducers consume the device tensors directly).
    Thread-safe — engine lanes may share one runner.
    """

    def __init__(self, dag: ReducerDAG):
        self.dag = dag
        self.impls = {r.name: device_impl_for(r) for r in dag}
        self.stats = DeviceRunStats()
        self._lock = threading.Lock()

    def device_reducers(self) -> list[str]:
        """Names of DAG reducers that will run on device."""
        return [n for n, impl in self.impls.items() if impl is not None]

    def _count_meta(self, nbytes: int) -> None:
        with self._lock:
            self.stats.bytes_meta_to_host += nbytes

    def _make_view(self, snap: Snapshot):
        """Per-snapshot view handed to the registered impls."""
        return DeviceTree(snap.arrays, snap.n_domains, self._count_meta)

    def run(self, snap: Snapshot) -> dict[str, dict[str, np.ndarray]]:
        outputs: dict[str, dict[str, np.ndarray]] = {}
        dt = host_snap = None
        for r in self.dag.order:
            if snap.kind not in r.kinds:
                continue
            if any(d not in outputs for d in r.deps):
                continue
            impl = self.impls.get(r.name)
            if impl is not None:
                if dt is None:
                    dt = self._make_view(snap)
                moved = 0
                out = {}
                # spans nest under the lane's open "reduce" span; the
                # .cpu() is where the async device work lands
                with TRACER.span("device.transfer",
                                 args={"reducer": r.name}) as sp:
                    for k, v in impl(dt).items():
                        if isinstance(v, torch.Tensor):
                            moved += _nbytes(v)
                            v = host_array(v)
                        out[k] = v
                    sp.set(nbytes=moved)
                with self._lock:
                    self.stats.device_objects += 1
                    self.stats.bytes_reduced_to_host += moved
            elif getattr(r, "device_ready", False):
                # tensor reducers (norms/spectra) consume device tensors
                # directly; their outputs are already reduced host arrays
                out = r.reduce(snap, outputs)
                with self._lock:
                    self.stats.device_objects += 1
                    self.stats.bytes_reduced_to_host += sum(
                        np.asarray(v).nbytes for v in out.values())
            elif getattr(r, "source", None):
                # source-chained reducers only read their upstream's
                # (already transferred) output — run them on host
                # without materializing the snapshot
                out = r.reduce(snap, outputs)
                with self._lock:
                    self.stats.fallback_runs[r.name] = \
                        self.stats.fallback_runs.get(r.name, 0) + 1
            else:
                if host_snap is None:
                    host_arrays, moved = {}, 0
                    with TRACER.span("device.transfer",
                                     args={"reducer": r.name,
                                           "fallback": True}) as sp:
                        for k, v in snap.arrays.items():
                            if isinstance(v, torch.Tensor):
                                moved += _nbytes(v)
                            host_arrays[k] = host_array(v)
                        sp.set(nbytes=moved)
                    host_snap = Snapshot(
                        step=snap.step, kind=snap.kind,
                        arrays=host_arrays, meta=snap.meta,
                        domain=snap.domain, n_domains=snap.n_domains)
                    with self._lock:
                        self.stats.fallback_snapshots += 1
                        self.stats.bytes_fallback_to_host += moved
                out = r.reduce(host_snap, outputs)
                with self._lock:
                    self.stats.fallback_runs[r.name] = \
                        self.stats.fallback_runs.get(r.name, 0) + 1
            if out:
                outputs[r.name] = out
        with self._lock:
            self.stats.snapshots += 1
        return outputs
