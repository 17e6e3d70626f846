"""Sharded multi-device reduction: per-shard partial rasters + merge.

The single-device path (``insitu.device``) funnels the whole reduction
DAG through one device — the paper's single-funnel bottleneck one layer
down. This module partitions each snapshot's *leaf table* over a list
of torch devices with the same Hilbert split the multi-domain writer
uses (``partition.leaf_shards``), rasterizes every shard on its own
device into a partial (``kernels.ops`` ``*_partial``, through the carry
kernels B4/B5 and the histogram kernel B3), and merges the partials on
the first device with the exact semantics of the read-side merge
strategies (``hercule.api``):

  ===========  ======================  ==================================
  reducer      read-side strategy      merge on ``devices[0]``
  ===========  ======================  ==================================
  slice        ``tile`` (paint)        depth-resolve: deepest leaf wins,
                                       lowest shard on ties (ascending
                                       fold, a shard wins only where its
                                       depth is strictly greater)
  projection   ``sum`` (ascending)     ascending fold ``acc + part`` —
                                       the same float adds in the same
                                       order as ``_merge_sum``
  level-hist   ``hist`` (int sum)      integer sum (order-free)
  ===========  ======================  ==================================

One process drives every device, as one ``shard_map`` program does: the
shards' kernels are enqueued device by device, and each partial is
brought to ``devices[0]`` with ``.to()`` (a no-op on the same device).
Not ``torch.distributed``: NCCL cannot put two ranks on one GPU, and a
mesh of several shards on one card (``[torch.device("cuda:0")] * 4``)
is how a one-card machine runs the multi-shard path — the counterpart
of the reference's forced host devices. No device holds more than its
own shard of the leaf rows (padded to the common bucket) plus its
partial; :class:`MeshRunStats` accounts for both.

Bit-parity contract: per-shard rows are the global BFS-ordered leaves of
one Hilbert segment — exactly the leaves the multi-domain writer assigns
to domain ``g`` — so shard partials are bitwise the per-domain host
outputs; slice (at ``resolution >= 2**max_level``, where painting is
collision-free), histogram and LOD cut are bit-identical to the host
reducers, and the projection is bit-identical to the read-side
ascending-domain fold (within 1e-12 of the single-writer host image).

``MeshDAGRunner(dtype="float32")`` is the reference's tolerance-parity
variant: the field tables are cast to float32 at build (half the field
upload) and B3-B5 run their float32 kernels, so the images are float32,
bit-equal to the reference's float32 mesh runner; against the float64
host reducers the slice holds to rtol 1e-6 and the projection to 1e-4,
and the histogram is exact on the cast values (DESIGN.md "f32 policy").

On the card each shard is one call of each carry kernel (B4, B5), and
``tile_n`` tiles only the twins (``backend="ref"`` and CPU tables): they
chain a shard longer than ``tile_n`` rows in BFS-ordered tiles, and the
one call gives that chain's bits (a shard's rows are BFS-ascending
leaves, so its kept rows are level-sorted; ``kernels.ops``).

Select with ``InTransitEngine(device_reduce="mesh", mesh_devices=...)``
or ``python -m repro_torch.launch.insitu --device-mesh N [--device D]``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from .device import (DeviceDAGRunner, DeviceRunStats, _nbytes, _padded,
                     _pow2, resolve_device)
from .partition import leaf_shards
from .reducers import (LevelHistogramReducer, LODCutReducer,
                       ProjectionReducer, ReducerDAG, SliceReducer)
from .staging import Snapshot

__all__ = ["MeshDAGRunner", "MeshRunStats", "MeshTable",
           "register_mesh_impl", "mesh_impl_for", "mesh_devices",
           "MESH_TILE"]

#: rows of the twins' tiles over a shard (a multiple of ``ops.BLOCK_N``);
#: on the card a shard is one kernel call whatever its rows
MESH_TILE = 16384


def mesh_devices(devices=None) -> list[torch.device]:
    """The mesh's devices, one per shard.

    An int N (None or 0: all) takes the first N CUDA devices and raises
    when there are fewer. A sequence of devices may repeat one device:
    ``[torch.device("cpu")] * 4`` runs four shards on the CPU.
    """
    if devices is None or isinstance(devices, int):
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = avail if devices in (None, 0) else int(devices)
        if not 1 <= n <= avail:
            raise ValueError(
                f"device mesh of {n} requested but only {avail} CUDA "
                f"device(s) available (to place several shards on one "
                f"device, pass devices as a sequence, e.g. "
                f"[torch.device('cuda:0')] * {max(n, 1)} or "
                f"[torch.device('cpu')] * {max(n, 1)})")
        return [torch.device("cuda", i) for i in range(n)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("a device mesh needs at least one device")
    return devs


# ----------------------------------------------------------- leaf tables

class MeshTable:
    """Per-snapshot sharded leaf table (the mesh twin of ``DeviceTree``).

    Built from the staged host BFS tree arrays: owned leaves are split
    into Hilbert-contiguous shards (:func:`partition.leaf_shards`), each
    shard's rows keep ascending BFS order and are padded to the common
    bucket multiple, and shard ``g``'s table is uploaded to
    ``devices[g]`` only. Padding rows carry ``ok=False``. Fields upload
    lazily per reducer; ``dtype`` casts them at table build (float32
    halves their upload); ``on_upload`` counts the host→device bytes.
    """

    def __init__(self, arrays: dict, n_domains: int, devices, *,
                 backend: str | None = None, dtype=None,
                 tile_n: int = MESH_TILE, on_upload=None):
        self.arrays = arrays
        self.devices = list(devices)
        self.backend = backend
        self.dtype = None if dtype is None else np.dtype(dtype)
        self.tile_n = tile_n
        self.on_upload = on_upload or (lambda nbytes: None)
        self.n_shards = len(self.devices)
        self._offsets = np.asarray(arrays["level_offsets"])
        self.n_levels = int(self._offsets.shape[0]) - 1
        leaves = np.flatnonzero(~np.asarray(arrays["refine"]))
        shard = leaf_shards(arrays, self.n_shards)
        if n_domains > 1:            # partitioned: owned leaves count once
            owned = np.asarray(arrays["owner"])[leaves]
            leaves, shard = leaves[owned], shard[owned]
        self._rows = [leaves[shard == g] for g in range(self.n_shards)]
        counts = [int(r.shape[0]) for r in self._rows]
        self.total_rows = int(leaves.shape[0])
        self.peak_rows = max(counts) if counts else 0
        self.rows_padded = _padded(max(self.peak_rows, 1))
        self._geom = None
        self._fields: dict = {}

    @property
    def leaf_frac(self) -> float:
        """Largest per-device share of the (unpadded) leaf rows."""
        return self.peak_rows / max(self.total_rows, 1)

    def _shard(self, per_row, dtype, fill, trailing=()):
        """One padded table per shard, each on its own device."""
        out = []
        for rows, dev in zip(self._rows, self.devices):
            host = np.full((self.rows_padded, *trailing), fill, dtype)
            host[:rows.shape[0]] = per_row(rows)
            out.append(torch.from_numpy(host).to(dev))
        self.on_upload(sum(_nbytes(t) for t in out))
        return out

    def _prep(self):
        if self._geom is None:
            coords = np.asarray(self.arrays["coords"]).astype(np.int32)
            self._geom = (
                self._shard(lambda rows: coords[rows], np.int32, 0,
                            trailing=(3,)),
                self._shard(lambda rows: np.searchsorted(
                    self._offsets, rows, side="right").astype(np.int32) - 1,
                    np.int32, 0),
                self._shard(lambda rows: True, bool, False))
        return self._geom

    @property
    def coords(self):
        return self._prep()[0]

    @property
    def levels(self):
        return self._prep()[1]

    @property
    def ok(self):
        """Per-shard valid-row masks: padding rows carry ``ok=False``."""
        return self._prep()[2]

    def _values(self, name: str) -> np.ndarray:
        """Field ``name``'s host values, cast to ``dtype`` if one is set."""
        v = np.asarray(self.arrays[f"field:{name}"])
        return v if self.dtype is None else v.astype(self.dtype)

    def field(self, name: str):
        if name not in self._fields:
            v = self._values(name)
            self._fields[name] = self._shard(lambda rows: v[rows], v.dtype, 0)
        return self._fields[name]

    def field_bounds(self, name: str) -> tuple[float, float]:
        """Host min/max over the owned leaf values.

        min/max are order-free, so this is bitwise the host reducer's
        auto bounds, and it costs no device pull (mesh snapshots stage
        on the host). Float32 tables bound the cast values, so the edges
        match what the kernel bins.
        """
        v = self._values(name)
        vals = [v[rows] for rows in self._rows if rows.size]
        if not vals:
            return 0.0, 1.0
        allv = np.concatenate(vals)
        return float(allv.min()), float(allv.max())

    def shards(self, name: str):
        """Per shard: (coords, levels, field ``name``, ok)."""
        return zip(self.coords, self.levels, self.field(name), self.ok)


# ----------------------------------------------------------------- merges

def _depth_resolve(parts, dev):
    """Slice merge: deepest leaf wins; equal depth → lowest shard.

    An ascending fold where a shard takes a pixel only if its depth is
    strictly greater: the (depth, -shard) lexicographic max, the same
    winner as the reference's XOR butterfly and its all_gather+argmax.
    """
    img, depth = (t.to(dev) for t in parts[0])
    for p_img, p_depth in parts[1:]:
        p_img, p_depth = p_img.to(dev), p_depth.to(dev)
        take = p_depth > depth
        img = torch.where(take, p_img, img)
        depth = torch.where(take, p_depth, depth)
    return img, depth


def _ordered_sum(parts, dev):
    """Projection merge: the read-side ``_merge_sum`` ascending fold, so
    every float add happens in the host merge's sequence."""
    acc = parts[0].to(dev)
    for part in parts[1:]:
        acc = acc + part.to(dev)
    return acc


# ----------------------------------------------------- impl registry

#: reducer class -> factory(reducer) -> impl(MeshTable) -> dict | None
MESH_IMPLS: dict[type, object] = {}


def register_mesh_impl(reducer_cls: type):
    """Register (or replace) the mesh factory for one reducer class.

    Mirrors :func:`device.register_device_impl`: the factory receives
    the reducer *instance* and returns ``impl(mesh_table) -> dict`` or
    ``None`` when this configuration must fall back to the host path.
    """
    def deco(factory):
        MESH_IMPLS[reducer_cls] = factory
        return factory
    return deco


def mesh_impl_for(reducer):
    """Resolve one reducer instance to its mesh impl (or None)."""
    factory = MESH_IMPLS.get(type(reducer))
    return factory(reducer) if factory is not None else None


@register_mesh_impl(SliceReducer)
def _slice_mesh(r: SliceReducer):
    if r.source is not None or not _pow2(r.resolution):
        return None

    def run(mt: MeshTable):
        parts = [ops.raster_slice_partial(
            c, lv, v, ok, axis=r.axis, position=r.position,
            resolution=r.resolution, n_levels=mt.n_levels,
            backend=mt.backend, tile_n=mt.tile_n)
            for c, lv, v, ok in mt.shards(r.field)]
        img, _ = _depth_resolve(parts, mt.devices[0])
        return {"image": img}
    return run


@register_mesh_impl(ProjectionReducer)
def _projection_mesh(r: ProjectionReducer):
    if r.source is not None or not _pow2(r.resolution):
        return None

    def run(mt: MeshTable):
        parts = [ops.raster_projection_partial(
            c, lv, v, ok, axis=r.axis, resolution=r.resolution,
            n_levels=mt.n_levels, backend=mt.backend, tile_n=mt.tile_n)
            for c, lv, v, ok in mt.shards(r.field)]
        return {"image": _ordered_sum(parts, mt.devices[0])}
    return run


@register_mesh_impl(LODCutReducer)
def _lod_mesh(r: LODCutReducer):
    """LOD cut on the mesh path: a numpy BFS prefix slice.

    Mesh snapshots stage on the host, so the cut needs no device: the
    same prefix slice + deepest-level demotion as ``device._lod_impl``,
    on the host arrays. Registered so the default CLI DAG reports zero
    fallbacks on the mesh path too.
    """
    def run(mt: MeshTable):
        offs = np.asarray(mt.arrays["level_offsets"]).astype(np.int64)
        if len(offs) - 1 <= r.max_level + 1:
            return {k: np.asarray(v) for k, v in mt.arrays.items()}
        n_keep = int(offs[r.max_level + 1])
        new_offs = offs[:r.max_level + 2].copy()
        # trim now-empty deepest levels, exactly like subset_tree
        n_lv = len(new_offs) - 1
        while n_lv > 1 and new_offs[n_lv] == new_offs[n_lv - 1]:
            n_lv -= 1
        refine = np.array(np.asarray(mt.arrays["refine"])[:n_keep])
        refine[int(offs[r.max_level]):n_keep] = False
        out = {"refine": refine, "level_offsets": new_offs[:n_lv + 1]}
        for k, v in mt.arrays.items():
            if k not in out and k != "level_offsets":
                out[k] = np.asarray(v)[:n_keep]
        return out
    return run


@register_mesh_impl(LevelHistogramReducer)
def _hist_mesh(r: LevelHistogramReducer):
    def run(mt: MeshTable):
        if r.lo is None or r.hi is None:
            lo, hi = mt.field_bounds(r.field)
            lo = lo if r.lo is None else r.lo
            hi = hi if r.hi is None else r.hi
        else:
            lo, hi = r.lo, r.hi
        if hi <= lo:
            hi = lo + 1.0
        edges = np.linspace(lo, hi, r.bins + 1)
        n_levels = min(mt.n_levels, r.max_levels)
        # host edges, passed by value to every shard's B3: no upload
        host_edges = torch.from_numpy(edges)
        parts = [ops.raster_level_hist_partial(
            v, lv, ok, host_edges, n_levels=n_levels, backend=mt.backend)
            for _, lv, v, ok in mt.shards(r.field)]
        hist = parts[0].to(mt.devices[0], torch.int64)
        for part in parts[1:]:
            hist = hist + part.to(mt.devices[0], torch.int64)
        return {"hist": hist, "edges": edges}
    return run


# ------------------------------------------------------------ runner

class MeshRunStats(DeviceRunStats):
    """Transfer + residency accounting for the mesh path.

    Extends the device counters with the sharded layout's proof
    obligations: the largest per-device share of the leaf rows
    (``peak_leaf_frac``, ≈ 1/S for a balanced Hilbert split), the
    per-device table upload and the per-device partial footprint.
    """

    def __init__(self):
        super().__init__()
        self.mesh_devices = 0
        self.leaf_rows = 0                    # cumulative sharded rows
        self.peak_leaf_frac = 0.0             # max per-device row share
        self.bytes_tables_to_device = 0       # total sharded uploads
        self.peak_device_table_bytes = 0      # one shard's padded rows
        self.peak_device_partial_bytes = 0    # one partial image / hist

    def as_dict(self) -> dict:
        d = super().as_dict()
        d.update(mesh_devices=self.mesh_devices,
                 leaf_rows=self.leaf_rows,
                 peak_leaf_frac=self.peak_leaf_frac,
                 bytes_tables_to_device=self.bytes_tables_to_device,
                 peak_device_table_bytes=self.peak_device_table_bytes,
                 peak_device_partial_bytes=self.peak_device_partial_bytes)
        return d


def _float_dtype(dtype):
    """``dtype`` as numpy float64 or float32, else None."""
    try:
        dt = np.dtype(dtype)
    except TypeError:
        return None
    return dt if dt in (np.float64, np.float32) else None


class MeshDAGRunner(DeviceDAGRunner):
    """DeviceDAGRunner whose impls shard every snapshot over devices.

    Third path for the engine (``device_reduce="mesh"``): same DAG
    order, per-reducer fallback and output contract as the single-device
    runner, but snapshots stage on the *host*, each leaf table is
    Hilbert-sharded over ``devices`` (see :func:`mesh_devices`), and
    host fallbacks cost no device traffic. ``dtype="float32"`` selects
    the tolerance-parity table variant (None or "float64": the fields'
    own dtype).
    """

    def __init__(self, dag: ReducerDAG, *, devices=None,
                 backend: str | None = None, dtype=None,
                 tile_n: int = MESH_TILE):
        if dtype is not None and _float_dtype(dtype) is None:
            raise ValueError(f"mesh tables are float64 or float32, got "
                             f"dtype={dtype!r}")
        self.dtype = dtype
        self.devices = mesh_devices(devices)
        self.tile_n = tile_n
        super().__init__(dag, backend=backend)
        self.impls = {r.name: mesh_impl_for(r) for r in dag}
        self.stats = MeshRunStats()
        self.stats.mesh_devices = len(self.devices)

    def _note_upload(self, nbytes: int) -> None:
        with self._lock:
            self.stats.bytes_tables_to_device += nbytes
            per_dev = nbytes // max(self.stats.mesh_devices, 1)
            self.stats.peak_device_table_bytes = max(
                self.stats.peak_device_table_bytes, per_dev)

    def _make_view(self, snap: Snapshot):
        mt = MeshTable(snap.arrays, snap.n_domains, self.devices,
                       backend=self.backend, dtype=self.dtype,
                       tile_n=self.tile_n, on_upload=self._note_upload)
        with self._lock:
            self.stats.leaf_rows += mt.total_rows
            self.stats.peak_leaf_frac = max(self.stats.peak_leaf_frac,
                                            mt.leaf_frac)
        return mt

    def run(self, snap: Snapshot):
        outputs = super().run(snap)
        # the merge device holds each reduced object while it merges;
        # the largest single output bounds the per-device partial
        peak = 0
        for out in outputs.values():
            peak = max(peak, sum(np.asarray(v).nbytes
                                 for v in out.values()))
        with self._lock:
            self.stats.peak_device_partial_bytes = max(
                self.stats.peak_device_partial_bytes, peak)
        return outputs
