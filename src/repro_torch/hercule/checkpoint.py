"""HProt checkpoint/restart for sharded PyTorch train states.

The paper's HProt flow, mapped to ML (DESIGN.md §2):

  * **contributor** = one device's shard of the train state; domain id =
    the shard's position in its device list. NCF contributors share a
    physical file (metadata-server relief at 1000+ nodes).
  * **raw coarse-grained blocks** — each shard is appended untransformed
    (the paper's second, successful granularity strategy: "big blocks of
    untransformed raw data", no pre-processing on the write path).
  * **ownership pruning** — replicated shards (same global slice on many
    devices) are written once by their owner, the lowest domain; the
    ownership map is the paper's ownership array analogue.
  * **contexts** = checkpoint steps, appended into the same physical files
    until rollover (multiple time steps per file, exactly Hercule).
  * **async** — the device->host snapshot is synchronous, file I/O happens
    on a background thread; the next save barriers on the previous write
    ("different output frequencies" between compute and I/O flows).
  * **elastic restore** — the index stores global shape + shard slices, so
    restore works onto any device layout; only the slices each target
    shard needs are read (no full-tensor host materialization).
  * optional lossless compression per tensor: ``delta`` (previous context
    as predictor — temporal father–son), ``pyramid`` (8-way mean pyramid),
    or ``auto`` (smallest of raw/delta/pyramid, per tensor, per save).

A state is a tree of ``dict`` (keys walked in sorted order), ``list`` and
``tuple`` whose leaves are tensors, :class:`ShardedTensor`\\ s, numpy
arrays or Python scalars; ``None`` is an empty subtree. Leaf names are
``jax.tree_util.keystr``'s (``['params']['w']``, ``[0]``), so a state and
its reference-package twin write the same records in the same order,
byte for byte. A sharded leaf is a :class:`ShardedTensor` (global shape,
dtype, ``(domain, slices, local tensor)`` per shard); a restore template
leaf is a :class:`ShardSpec` (the same without data, a device per shard),
a tensor (restored whole onto its device; a ``meta`` tensor onto the
GPU), or anything else (restored as a numpy array).

bfloat16 is carried on the host as ``uint16`` bits beside the dtype name
``"bfloat16"`` (``core.pyramid.host_bits``); only the torch boundary
views it as ``torch.bfloat16``. Record dtypes are numpy's names.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from ..core import pyramid as pyr
from ..core.pyramid import dtype_name
from ..insitu.device import resolve_device
from . import api, codecs
from .database import HerculeDB

_SENTINEL = object()


def _device(device) -> torch.device:
    """``device`` resolved; ``None`` is the GPU, and raises without one."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for a checkpoint tensor given no device (a "
            "meta template, or state_from_numpy(device=None)); pass a "
            "device, e.g. torch.device('cpu')")
    return resolve_device(device)


# ------------------------------------------------------------ leaf walk

def _map_leaves(fn, tree, path: str = ""):
    """``tree`` with every leaf replaced by ``fn(keystr, leaf)``, in
    ``jax.tree_util``'s order (dict keys sorted; ``None`` is empty)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], f"{path}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            raise TypeError(
                f"namedtuple {type(tree).__name__} at {path or 'the root'}: "
                f"only dict, list and tuple nodes are walked")
        return type(tree)(_map_leaves(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaf_paths(tree) -> list[tuple[str, object]]:
    """(keystr, leaf) of every leaf, in ``jax.tree_util``'s order."""
    out: list = []
    _map_leaves(lambda path, leaf: out.append((path, leaf)), tree)
    return out


def leaf_name(path: str) -> str:
    """Flatten a leaf's keystr to a dotted record name ('params.w').

    Shared by the HDep analysis dump and the in-transit engine so both
    flows emit identical names for the same parameter.
    """
    return path.strip("'[]").replace("']['", ".")


# ------------------------------------------------------- sharded leaves

def _full_slices(shape) -> tuple:
    return tuple(slice(0, d) for d in shape)


def _row_slices(shape: tuple, n: int) -> list[tuple]:
    """Dim 0 split in ``n`` equal blocks, as ``PartitionSpec("d")``."""
    if not shape or shape[0] % n:
        raise ValueError(f"cannot split shape {tuple(shape)} by rows over "
                         f"{n} devices: dim 0 must be a multiple of {n}")
    c = shape[0] // n
    return [(slice(i * c, (i + 1) * c),) + _full_slices(shape[1:])
            for i in range(n)]


@dataclasses.dataclass
class ShardSpec:
    """A sharded leaf's layout without its data (a restore template).

    ``layout`` holds ``(domain, slices, device)`` per shard; ``slices``
    is a tuple of ``slice`` per dimension of ``global_shape``.
    """
    global_shape: tuple
    dtype: torch.dtype
    layout: list

    @property
    def shape(self) -> tuple:
        return tuple(self.global_shape)

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    @classmethod
    def rows(cls, shape, dtype, devices) -> "ShardSpec":
        """Dim 0 split over ``devices`` (domains 0..N-1 in list order)."""
        devs = [resolve_device(d) for d in devices]
        return cls(tuple(shape), dtype,
                   [(i, sl, dev) for i, (sl, dev) in
                    enumerate(zip(_row_slices(tuple(shape), len(devs)),
                                  devs))])

    @classmethod
    def replicated(cls, shape, dtype, devices) -> "ShardSpec":
        """The whole leaf on every device of ``devices``."""
        full = _full_slices(tuple(shape))
        return cls(tuple(shape), dtype,
                   [(i, full, resolve_device(d))
                    for i, d in enumerate(devices)])


@dataclasses.dataclass
class ShardedTensor:
    """One leaf split over devices: ``(domain, slices, local tensor)``
    per shard, the stand-in for a sharded ``jax.Array``."""
    global_shape: tuple
    dtype: torch.dtype
    shards: list

    @property
    def shape(self) -> tuple:
        return tuple(self.global_shape)

    @property
    def ndim(self) -> int:
        return len(self.global_shape)

    def spec(self) -> ShardSpec:
        return ShardSpec(self.shape, self.dtype,
                         [(d, sl, t.device) for d, sl, t in self.shards])

    def full(self, device=None) -> torch.Tensor:
        """The whole leaf as one tensor (on the first shard's device)."""
        dev = self.shards[0][2].device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for _, sl, t in self.shards:
            out[sl] = t.to(dev)
        return out


def _place(t: torch.Tensor, spec: ShardSpec) -> ShardedTensor:
    if tuple(t.shape) != spec.shape:
        raise ValueError(f"tensor of shape {tuple(t.shape)} for a layout "
                         f"of shape {spec.shape}")
    return ShardedTensor(spec.shape, t.dtype,
                         [(d, sl, t[sl].to(dev, copy=True).contiguous())
                          for d, sl, dev in spec.layout])


def shard_rows(t: torch.Tensor, devices) -> ShardedTensor:
    """``t`` split by rows over ``devices``, as ``PartitionSpec("d")``:
    ``[cuda:0] * 4`` or ``[cpu] * 4`` give domains 0-3."""
    return _place(t, ShardSpec.rows(t.shape, t.dtype, devices))


def replicate(t: torch.Tensor, devices) -> ShardedTensor:
    """A copy of ``t`` on every device (written once, by domain 0)."""
    return _place(t, ShardSpec.replicated(t.shape, t.dtype, devices))


def _owned(leaf) -> list[tuple[int, tuple, object]]:
    """(domain, index-slices, data) per *owned* shard (replicas pruned).

    A tensor is one shard over its whole extent (a single-device array);
    anything else is one host array with no slices.
    """
    if isinstance(leaf, ShardedTensor):
        seen, out = set(), []
        for domain, index, t in sorted(leaf.shards, key=lambda s: s[0]):
            key = tuple((s.start, s.stop, s.step) for s in index)
            if key in seen:
                continue  # ghost replica — ownership pruning
            seen.add(key)
            out.append((domain, index, t))
        return out
    if isinstance(leaf, torch.Tensor):
        return [(0, _full_slices(leaf.shape), leaf)]
    return [(0, (), np.asarray(leaf))]


def _global_shape(leaf, data) -> tuple:
    if isinstance(leaf, (ShardedTensor, torch.Tensor)):
        return tuple(leaf.shape)
    return tuple(data.shape)


def _slices_json(index: tuple, shape: tuple) -> list[list[int]]:
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else sl.start
        stop = dim if sl.stop is None else sl.stop
        out.append([int(start), int(stop)])
    return out


def host_copy(data) -> tuple[np.ndarray, str]:
    """A host copy of one shard (tensor or array) and its dtype name;
    bfloat16 as ``uint16`` bits. Never a view of ``data``."""
    if isinstance(data, torch.Tensor):
        data = data.detach().to("cpu", copy=True)
    else:
        data = np.array(data, copy=True)
    return pyr.host_bits(data)


def to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A host array of dtype name ``dtype`` as a tensor on ``device``."""
    if not arr.flags.c_contiguous:
        arr = arr.copy()   # (np.ascontiguousarray would make a 0-d 1-d)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


# ------------------------------------------------------- state crossing

def state_from_numpy(tree, device=None, *, replicate_names=()):
    """A tree of numpy arrays (the reference's state) as tensors.

    ``device`` is one device (``None``: the GPU, raising without one), or
    a list of devices: then every leaf of one dimension or more is split
    by rows over them (:func:`shard_rows`), but those whose
    :func:`leaf_name` is in ``replicate_names``, which are replicated;
    0-d leaves go whole to the first. A bfloat16 array (numpy names an
    ``ml_dtypes`` array "bfloat16") crosses as its bits.
    """
    devs = [resolve_device(d) for d in device] \
        if isinstance(device, (list, tuple)) else None
    one = _device(device) if devs is None else devs[0]

    def conv(path, leaf):
        arr, name = pyr.host_bits(np.array(leaf, copy=True))
        t = to_tensor(arr, name, "cpu")
        if devs is None or t.ndim == 0:
            return t.to(one)
        if leaf_name(path) in replicate_names:
            return replicate(t, devs)
        return shard_rows(t, devs)
    return _map_leaves(conv, tree)


def state_to_numpy(state):
    """The port's state as a tree of numpy arrays of the same names:
    sharded leaves assembled whole, bfloat16 as ``uint16`` bits
    (``.view(ml_dtypes.bfloat16)`` gives the reference's arrays)."""
    def conv(path, leaf):
        if isinstance(leaf, ShardedTensor):
            leaf = leaf.full(torch.device("cpu"))
        return host_copy(leaf)[0]
    return _map_leaves(conv, state)


# ------------------------------------------------------------- restore

def _template_leaf(leaf, recs, read_region):
    """One restored leaf shaped as its template ``leaf``."""
    gshape = tuple(recs[0].meta["global_shape"])
    dtype = recs[0].dtype
    if isinstance(leaf, (ShardSpec, torch.Tensor)) and \
            dtype_name(leaf.dtype) != dtype:
        raise TypeError(f"template dtype {leaf.dtype} for a stored "
                        f"{dtype} tensor")
    if isinstance(leaf, ShardSpec):
        if leaf.shape != gshape:
            raise ValueError(f"template shape {leaf.shape} for a stored "
                             f"tensor of shape {gshape}")
        shards = []
        for domain, index, device in leaf.layout:
            tslices = [slice(0 if s.start is None else s.start,
                             dim if s.stop is None else s.stop)
                       for s, dim in zip(index, gshape)]
            shards.append((domain, index, to_tensor(
                read_region(tslices), dtype, resolve_device(device))))
        return ShardedTensor(gshape, leaf.dtype, shards)
    full = read_region([slice(0, d) for d in gshape]) if gshape else \
        read_region(())
    if isinstance(leaf, torch.Tensor):
        dev = _device(None) if leaf.device.type == "meta" \
            else leaf.device
        return to_tensor(full, dtype, dev)
    return full


def restore_tree(template, view, kind, name_of, *, reader=None):
    """``template`` with every leaf read from ``view`` (elastic): each
    target shard decodes only the source records that overlap it."""
    def restore_leaf(path, leaf):
        name = name_of(path)
        recs = kind.shards(view, name)
        if not recs:
            raise KeyError(f"checkpoint {view.step} missing tensor {name!r}")

        def read_region(target_slices):
            # only the source shards overlapping the target region are
            # decoded (elastic), in parallel on the db's read pool
            return kind.read_region(view, name, target_slices,
                                    reader=reader)
        return _template_leaf(leaf, recs, read_region)
    return _map_leaves(restore_leaf, template)


# ------------------------------------------------------------- manager

_FLOATY = ("float32", "float64", "bfloat16")


class CheckpointManager:
    """Hercule HProt-backed checkpoint manager."""

    def __init__(self, root: str, *, ncf: int = 8,
                 max_file_bytes: int = 2 << 30, mode: str = "raw",
                 async_write: bool = True, io_threads: int = 4):
        assert mode in ("raw", "delta", "pyramid", "auto")
        self.db = HerculeDB.create(root, kind="hprot", ncf=ncf,
                                   max_file_bytes=max_file_bytes,
                                   io_threads=io_threads)
        self.mode = mode
        self.async_write = async_write
        self._prev: dict[tuple[str, int], np.ndarray] = {}
        self._prev_step: int | None = None
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: list[BaseException] = []
        self._thread = None
        if async_write:
            self._thread = threading.Thread(target=self._worker,
                                            name="hprot-writer", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- save
    def save(self, step: int, state, *, attrs: dict | None = None,
             wait: bool = False, fence=None) -> None:
        """Snapshot ``state`` (sync) and write it (async by default).
        ``fence``, if given, is called before the context commits."""
        self.check_errors()
        snapshot = []
        for name, leaf in _leaf_paths(state):
            for domain, index, data in _owned(leaf):
                host, dtype = host_copy(data)   # synchronous copy down
                gshape = _global_shape(leaf, host)
                snapshot.append((name, domain, _slices_json(index, gshape),
                                 gshape, host, dtype))
        job = (step, snapshot, dict(attrs or {}), fence)
        if self.async_write:
            self._q.put(job)  # blocks if previous write still in flight
        else:
            self._write(job)
        if wait:
            self.wait()

    def _worker(self):
        while True:
            job = self._q.get()
            if job is _SENTINEL:
                return
            try:
                self._write(job)
            except BaseException as e:  # surfaced on next save/wait
                self._err.append(e)
            finally:
                self._q.task_done()

    def _encode(self, name: str, domain: int, data: np.ndarray, dtype: str):
        """Pick codec per tensor shard; returns (codec, payload, meta)."""
        candidates = []
        floaty = dtype in _FLOATY and data.size >= 64
        prev = self._prev.get((name, domain))
        mode = self.mode
        if floaty and mode in ("delta", "auto") and prev is not None \
                and prev.shape == data.shape:
            dc = pyr.encode_delta(data, prev, dtype=dtype)
            candidates.append(("fpdelta-delta", codecs.encode_delta(dc),
                              {"pred_step": self._prev_step, "pad": dc.pad}))
        if floaty and mode in ("pyramid", "auto"):
            pc = pyr.encode_pyramid(data, dtype=dtype)
            candidates.append(("fpdelta-pyramid", codecs.encode_pyramid(pc),
                              {"pad": pc.pad}))
        raw = ("raw", np.ascontiguousarray(data).tobytes(), {})
        if mode == "raw" or not candidates:
            return raw
        best = min(candidates, key=lambda c: len(c[1]))
        return best if len(best[1]) < len(raw[1]) else raw

    def _write(self, job):
        step, snapshot, attrs, fence = job
        ctx = self.db.begin_context(step)
        # group-parallel writes: one closure per contributor group
        bygroup: dict[int, list] = {}
        for entry in snapshot:
            bygroup.setdefault(self.db.group_of(entry[1]), []).append(entry)

        def write_group(items):
            for name, domain, slices, gshape, data, dtype in items:
                codec, payload, meta = self._encode(name, domain, data,
                                                    dtype)
                ctx.write_bytes(domain, name, payload, dtype=dtype,
                                shape=data.shape, codec=codec,
                                meta={**meta, "slices": slices,
                                      "global_shape": list(gshape)})
        for items in bygroup.values():
            ctx.submit(write_group, items)
        if fence is not None:
            fence()
        ctx.finalize(attrs={**attrs, "mode": self.mode})
        # retain snapshot as the next delta predictor
        if self.mode in ("delta", "auto"):
            self._prev = {(n, d): data for n, d, _, _, data, _ in snapshot}
            self._prev_step = step

    # ------------------------------------------------------------- sync
    def wait(self) -> None:
        if self.async_write:
            self._q.join()
        self.check_errors()

    def check_errors(self) -> None:
        if self._err:
            raise RuntimeError("async checkpoint write failed") from self._err[0]

    def close(self) -> None:
        if self.async_write and self._thread is not None:
            self._q.join()
            self._q.put(_SENTINEL)
            self._thread.join()
        self.db.close()

    # ---------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        return self.db.latest_context()

    def restore(self, template, step: int | None = None):
        """Restore into ``template`` (a state tree of tensors,
        :class:`ShardSpec`\\ s or arrays).

        Elastic: works for any target layout. For each target shard only
        the overlapping source records are read and decoded.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no complete checkpoint context found")
        view = self.db.view(step)
        return restore_tree(template, view, api.CKPT_SHARD,
                            lambda path: path), view.attrs
