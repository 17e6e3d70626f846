"""Multi-pod dry-run: per-device memory and roofline of every cell.

For every (arch x shape) cell, place the cell's abstract inputs
(``launch.specs``) on the production mesh by the cell's rules
(``launch.rules``, ``sharding``) as ``meta`` DTensors, run the real step
function (train_step / prefill / decode_step) over them once under
``sharding.use_rules``, and persist the roofline terms (at an H100's
rates, ``launch.roofline``) to JSON.

    python -m repro_torch.launch.dryrun --arch internlm2_20b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out dryrun_results
    python -m repro_torch.launch.dryrun --all --subprocesses

The mesh lives in one process: a ``fake`` process group of 256 or 512
ranks (``torch.testing._internal.distributed.fake_pg``) whose
collectives move nothing, over a ``cpu`` ``DeviceMesh``; every tensor is
``meta``, so no byte is allocated and no device is needed. The group is
made and torn down by :func:`run_cell` (in a ``finally``), and refused
if the process already has one: a fake group must not share a process
with a real one.

Two dispatch modes see the per-device program, the local ops that
DTensor runs on each rank's shard (each returns ``NotImplemented`` on a
DTensor op, so DTensor runs first and its local ops come back to them,
and skips the ops of DTensor's shape propagation, which no rank runs):
  * ``FlopCounterMode``'s formulas give the flops per device, by the
    dtype of each product's inputs;
  * every op's inputs read once and outputs written once give the bytes
    per device. It is the unfused count: XLA's ``bytes accessed`` counts
    the fused program, where an elementwise chain reads its input and
    writes its output once, so the two differ, this one higher; views
    move nothing and collectives count under their own term;
  * each ``_c10d_functional`` collective gives a record (op, its
    per-device result bytes, group size). DTensor on a ``cpu`` mesh
    rewrites a shard-to-shard all-to-all as an all-gather and a chunk
    (gloo has no all-to-all); the dry-run routes it to the all-to-all op
    the program asked for (``_dtensor.shard_dim_alltoall``, whose meta
    kernel moves nothing), and counts that.

Memory: argument bytes are exact, the local shard bytes of every input.
Peak bytes are the most bytes the local tensors hold at once over the
step, the arguments included (the byte counter keeps every storage a
local op makes live until its last reference goes); temp bytes are peak
less argument bytes, as the reference defines them. The count is of
eager allocations, as the caching allocator's ``max_memory_allocated``
counts them (no fusion, no allocator rounding). It is the same on
``meta`` storages as on real ones. ``torch.distributed._tools.
mem_tracker.MemTracker`` is not used: on torch 2.11 it loses the
``meta`` storages.

The port's layer loop is Python, so every layer's ops run and count:
the reference's depth probes and extrapolation (``_depth_variant``,
``extrapolated_cost``, ``raw_loop_once``), which correct XLA's count of
a loop body once, have no counterpart. ``trace_s`` (the one run's
seconds) replaces the reference's ``lower_s`` and ``compile_s``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import sharding as shlib
from ..configs import SHAPES, get_config
from ..configs.registry import ARCHS, cells
from . import roofline as rl
from .mesh import make_production_mesh, make_test_mesh
from .rules import rules_for
from .specs import build_callable, cell_shape, input_specs

_C10D = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _is_fake_op(types) -> bool:
    """An op of DTensor's sharding propagation, which runs under a fake
    mode to learn output shapes (its factories at the global shape): no
    rank runs it."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensor
    return active_fake_mode() is not None or any(
        issubclass(t, FakeTensor) for t in types)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _group_size(func, args, kwargs) -> int:
    """The group size of a functional collective: its ``group_size``
    argument, else the size of its named group."""
    import torch.distributed.distributed_c10d as c10d
    for a, v in zip(func._schema.arguments, args):
        if a.name == "group_size":
            return int(v)
    name = kwargs.get("group_name", args[-1])
    return c10d._resolve_process_group(name).size()


class LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` of the ops each rank runs: DTensor ops pass
    through (``NotImplemented``), their local ops are counted, and
    ``by_dtype`` sums them by the dtype of the op's first tensor input
    (the rate the card runs them at)."""

    def __init__(self):
        super().__init__(display=False)
        self.by_dtype: dict[str, int] = {}

    def __enter__(self):
        from torch.utils.flop_counter import _FlopCounterMode
        counter = self

        class _Local(_FlopCounterMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if _is_dtensor_op(types):
                    return NotImplemented
                if _is_fake_op(types):
                    return func(*args, **(kwargs or {}))
                before = counter.get_total_flops()
                out = super().__torch_dispatch__(func, types, args, kwargs)
                added = counter.get_total_flops() - before
                if added:
                    dt = next(str(a.dtype).removeprefix("torch.")
                              for a in args if isinstance(a, torch.Tensor))
                    counter.by_dtype[dt] = counter.by_dtype.get(dt, 0) + added
                return out

        self.flop_counts.clear()
        self.by_dtype.clear()
        self.mod_tracker.__enter__()
        self.mode = _Local(self)
        self.mode.__enter__()
        return self


class LocalCounter(TorchDispatchMode):
    """Bytes each rank's ops read and write, its collectives, and the
    most bytes its tensors hold at once (``peak``): every storage a
    local op makes is live until its last reference goes (a finalizer
    on the storage), the arguments (:meth:`hold`) from the start."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives: list[tuple[str, int, int]] = []
        self.live: dict[int, int] = {}
        self.now = self.peak = 0

    def hold(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            if id(st) not in self.live:
                self.live[id(st)] = st.nbytes()
                self.now += st.nbytes()
                weakref.finalize(st, self._drop, id(st))
        self.peak = max(self.peak, self.now)

    def _drop(self, key: int) -> None:
        self.now -= self.live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _is_fake_op(types):
            return out
        self.hold(t for t in (out if isinstance(out, (list, tuple))
                              else (out,)) if isinstance(t, torch.Tensor))
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "_dtensor") and name in _C10D:
            self.collectives.append(
                (_C10D[name], _nbytes(out), _group_size(func, args, kwargs)))
        elif ns not in ("_c10d_functional", "c10d") and not any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns):
            self.bytes += _nbytes(list(args) + list(kwargs.values())) \
                + _nbytes(out)
        return out


@contextlib.contextmanager
def _alltoall_as_asked():
    """DTensor's shard-to-shard all-to-all as the op itself on a ``cpu``
    mesh (see the module docstring); meta tensors only."""
    from torch.distributed._functional_collectives import _resolve_group_name
    from torch.distributed.tensor import placement_types

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = mesh.get_group(mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, _resolve_group_name(group))
    prev = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = shard_dim_alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = prev


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks (this
    process is rank 0), torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "the dry-run makes its own fake process group and this process "
            "already has one; run it in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def local_bytes(tree) -> int:
    """Per-device bytes of a tree of DTensors and plain tensors."""
    from torch.distributed.tensor import DTensor
    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x)
               for x in _leaves(tree))


def place_inputs(kwargs: dict, axes: dict, rules: dict, mesh) -> dict:
    """The cell's ``meta`` inputs as DTensors placed by their axes; a
    host scalar (decode's ``pos``) stays as it is."""
    out = {}
    for k, v in kwargs.items():
        if isinstance(v, torch.Tensor) and v.device.type != "meta":
            out[k] = v
        else:
            out[k] = shlib.tree_distribute(v, axes[k], rules, mesh)
    return out


def cell_inputs(arch: str, shape: str, rules: dict, mesh, *, cfg=None,
                batch=None, seq=None) -> tuple:
    """(kind, the cell's inputs placed on ``mesh``)."""
    kind, kwargs, axes = input_specs(arch, shape, cfg=cfg, batch=batch,
                                     seq=seq)
    return kind, place_inputs(kwargs, axes, rules, mesh)


def model_flops(cfg, cell: dict) -> float:
    n = cfg.active_param_count()
    tokens = {"train": cell["batch"] * cell["seq"],
              "prefill": cell["batch"] * cell["seq"],
              "decode": cell["batch"]}[cell["kind"]]
    mult = 6 if cell["kind"] == "train" else 2
    return float(mult) * n * tokens


def mesh_label(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "x".join(str(n) for n in mesh_shape)
    return "multi" if multi_pod else "single"


def trace_cell(fn, kwargs: dict, rules: dict, mesh) -> dict:
    """Run ``fn(**kwargs)`` once under ``use_rules`` with the counters;
    the per-device record :func:`roofline.roofline` takes, and the
    step's peak bytes (arguments included)."""
    from torch.distributed.tensor import DTensor
    flops = LocalFlopCounter()
    counter = LocalCounter()
    counter.hold(x.to_local() if isinstance(x, DTensor) else x
                 for v in kwargs.values() for x in _leaves(v))
    with _alltoall_as_asked(), shlib.use_rules(rules, mesh), flops, \
            counter:
        fn(**kwargs)
    return {"flops": dict(flops.by_dtype), "bytes": counter.bytes,
            "collectives": counter.collectives, "peak_bytes": counter.peak}


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             rules_override: dict | None = None, verbose: bool = True,
             cfg=None, mesh_shape=None, batch=None, seq=None) -> dict:
    """One cell's roofline terms. ``mesh_shape`` (2 or 3 dims, named
    ("data", "model") or ("pod", "data", "model")) replaces the
    production mesh; ``cfg``, ``batch`` and ``seq`` the cell's config
    and shape."""
    cfg = cfg or get_config(arch)
    cell = cell_shape(shape, batch, seq)
    if mesh_shape is not None:
        mesh_shape = tuple(mesh_shape)
        names = ("pod", "data", "model")[-len(mesh_shape):]
        multi_pod = "pod" in names
    world = math.prod(mesh_shape) if mesh_shape else (512 if multi_pod
                                                      else 256)
    rules = rules_for(arch, shape, multi_pod=multi_pod,
                      override=rules_override)
    with fake_group(world):
        mesh = make_test_mesh(mesh_shape, names, "cpu") if mesh_shape \
            else make_production_mesh(multi_pod=multi_pod)
        kind, placed = cell_inputs(arch, shape, rules, mesh, cfg=cfg,
                                   batch=batch, seq=seq)
        fn = build_callable(arch, shape, cfg=cfg, seq=seq)
        arg_bytes = sum(local_bytes(v) for v in placed.values())
        t0 = time.perf_counter()
        record = trace_cell(fn, placed, rules, mesh)
        trace_s = time.perf_counter() - t0
    peak = record.pop("peak_bytes")
    record["memory"] = {"argument_bytes": arg_bytes,
                        "temp_bytes": peak - arg_bytes, "peak_bytes": peak}
    mf = model_flops(cfg, cell)
    terms = rl.roofline(record, world, mf)
    terms.update(arch=arch, shape=shape, kind=kind,
                 mesh=mesh_label(multi_pod, mesh_shape),
                 trace_s=round(trace_s, 2), params=cfg.param_count(),
                 active_params=cfg.active_param_count())
    if verbose:
        coll = {k: v["count"] for k, v in terms["collectives"].items()
                if v["count"]}
        print(f"== {arch} x {shape} mesh={terms['mesh']} ({kind}) traced in "
              f"{trace_s:.1f}s: argument bytes/device {arg_bytes}, peak "
              f"{peak}, "
              f"flops/device {terms['flops_per_device']:.4e}, bytes/device "
              f"{terms['bytes_per_device']:.4e}, collectives {coll}")
        print(f"   roofline (H100): compute {terms['compute_s']*1e3:.3f} ms "
              f"| memory {terms['memory_s']*1e3:.3f} ms | collective "
              f"{terms['collective_s']*1e3:.3f} ms -> dominant: "
              f"{terms['dominant']}, bound "
              f"{terms['step_time_lower_bound_s']*1e3:.3f} ms")
    return terms


def _tag(arch, shape, multi_pod, mesh_shape=None) -> str:
    return f"{arch}__{shape}__{mesh_label(multi_pod, mesh_shape)}"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCHS)
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--mesh", choices=["single", "multi", "both"],
                   default="single")
    p.add_argument("--mesh-shape", default=None,
                   help="e.g. 1,1 or 2,2,2: a mesh of that shape in place "
                        "of the production one")
    p.add_argument("--batch", type=int, default=None,
                   help="the cell's batch in place of the shape's")
    p.add_argument("--seq", type=int, default=None,
                   help="the cell's sequence in place of the shape's")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="dryrun_results")
    p.add_argument("--subprocesses", action="store_true",
                   help="one subprocess per cell")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    mesh_shape = tuple(int(n) for n in args.mesh_shape.split(",")) \
        if args.mesh_shape else None
    if mesh_shape:
        meshes = [None]

    if args.all:
        todo = [(c["arch"], c["shape"]) for c in cells()]
        failures = []
        for arch, shape in todo:
            for mp in meshes:
                tag = _tag(arch, shape, mp, mesh_shape)
                out_file = os.path.join(args.out, tag + ".json")
                if os.path.exists(out_file):
                    print(f"skip {tag} (cached)")
                    continue
                if args.subprocesses:
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape,
                           "--mesh", "multi" if mp else "single",
                           "--out", args.out]
                    if mesh_shape:
                        cmd += ["--mesh-shape", args.mesh_shape]
                    if subprocess.run(cmd).returncode != 0:
                        failures.append(tag)
                else:
                    try:
                        terms = run_cell(arch, shape, bool(mp),
                                         mesh_shape=mesh_shape)
                        with open(out_file, "w") as f:
                            json.dump(terms, f, indent=1)
                    except Exception as e:  # noqa: BLE001
                        print(f"FAIL {tag}: {type(e).__name__}: {e}")
                        failures.append(tag)
        print(f"done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        p.error("--arch/--shape or --all required")
    for mp in meshes:
        terms = run_cell(args.arch, args.shape, bool(mp),
                         mesh_shape=mesh_shape, batch=args.batch,
                         seq=args.seq)
        tag = _tag(args.arch, args.shape, mp, mesh_shape)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(terms, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
