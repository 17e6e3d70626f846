"""The port's dry-run (``repro_torch.launch.{specs,dryrun,roofline,mesh}``)
against the reference's: per-device argument bytes of every cell on both
production meshes (the reference's from its ``input_specs``, axes and
``resolve_spec`` on a stand-in mesh, no compile), the axes trees, the
collective model, and the five families of the reference's small-mesh
dry-run traced through the port. Fake process groups are torn down in a
``finally`` (``dryrun.fake_group``)."""
import contextlib
import textwrap

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import sharding as ref_sharding
from repro.configs import get_config as ref_config
from repro.configs.registry import cells
from repro.launch import roofline as ref_roofline
from repro.launch import rules as ref_rules
from repro.launch import specs as ref_specs
from repro.models import serving as ref_serving
from repro.models.transformer import LM as RefLM
from repro.train import step as ref_step
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import dryrun, roofline, rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_callable, input_specs
from repro_torch.models import serving
from repro_torch.models.transformer import LM
from repro_torch.train import step

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _leaves(tree, axes):
    """(leaf, axes) pairs of matching trees (a leaf's axes is a tuple)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], axes[k])]
    return [(tree, axes)]


def ref_argument_bytes(arch: str, shape: str, multi_pod: bool) -> int:
    """The reference's per-device argument bytes of a cell: every input's
    local shard under its spec on the production mesh."""
    sizes = MESHES[multi_pod]
    r = ref_rules.rules_for(arch, shape, multi_pod=multi_pod)
    _, kwargs, axes = ref_specs.input_specs(arch, shape)
    total = 0
    for k in kwargs:
        for s, a in _leaves(kwargs[k], axes[k]):
            spec = ref_sharding.resolve_spec(tuple(s.shape), tuple(a), r,
                                             _FakeMesh(sizes))
            n = 1
            for dim, part in zip(s.shape, spec):
                names = () if part is None else (
                    (part,) if isinstance(part, str) else tuple(part))
                n *= dim // int(np.prod([sizes[x] for x in names]))
            total += n * np.dtype(s.dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_argument_bytes_equal_reference_every_cell(multi_pod):
    todo = [(c["arch"], c["shape"]) for c in cells()]
    assert len(todo) == 33
    with dryrun.fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, shape in todo:
            r = rules.rules_for(arch, shape, multi_pod=multi_pod)
            _, placed = dryrun.cell_inputs(arch, shape, r, mesh)
            got = sum(dryrun.local_bytes(v) for v in placed.values())
            assert got == ref_argument_bytes(arch, shape, multi_pod), \
                (arch, shape)


def _ref_tree(tree):
    """A reference axes tree with its tuples as tuples (jax keeps them)."""
    if isinstance(tree, dict):
        return {k: _ref_tree(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_equal_reference(arch):
    lm = LM(get_config(arch), device="meta")
    ref = RefLM(ref_config(arch))
    assert lm.param_axes() == _ref_tree(ref.param_axes())
    assert step.state_axes(lm) == _ref_tree(ref_step.state_axes(ref))
    ref_cache, ref_axes = ref_serving.cache_specs(ref, 4, 64)
    assert serving.cache_axes(lm) == _ref_tree(ref_axes)
    # the meta model's cache and parameters are the reference's shapes
    cache = serving.cache_specs(lm, 4, 64)
    for (t, _), (s, _) in zip(_leaves(cache, serving.cache_axes(lm)),
                              _leaves(ref_cache, ref_axes)):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape)
        assert str(t.dtype).split(".")[-1] == str(s.dtype)
    for (t, _), (s, _) in zip(
            _leaves(lm.abstract_params(), lm.param_axes()),
            _leaves(ref.abstract_params(), ref.param_axes())):
        assert tuple(t.shape) == tuple(s.shape)
        assert t.dtype == torch.float32 and t.device.type == "meta"


# the reference's test_dryrun_machinery_small_mesh cells, with its
# snippet's shrunken shapes
_SMALL = {"train_4k": (8, 128), "decode_32k": (8, 64)}


@pytest.mark.parametrize("arch,shape", [
    ("internlm2_20b", "train_4k"),
    ("mixtral_8x22b", "decode_32k"),
    ("mamba2_1_3b", "decode_32k"),
    ("whisper_medium", "train_4k"),
    ("recurrentgemma_2b", "decode_32k"),
])
def test_dryrun_machinery_small_mesh(arch, shape):
    """Every family traced on a fake (pod, data, model) = (2, 2, 2) mesh
    at its smoke config: flops, a collective table, argument bytes."""
    b, s = _SMALL[shape]
    terms = dryrun.run_cell(arch, shape, True, cfg=get_smoke_config(arch),
                            mesh_shape=(2, 2, 2), batch=b, seq=s,
                            verbose=False)
    assert terms["chips"] == 8 and terms["mesh"] == "2x2x2"
    assert terms["flops_per_device"] > 0
    assert terms["flops_global"] == 8 * terms["flops_per_device"]
    assert terms["bytes_per_device"] > 0
    assert set(terms["collectives"]) == set(roofline.COLLECTIVES)
    assert sum(v["count"] for v in terms["collectives"].values()) > 0
    mem = terms["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    for key in ("compute_s", "memory_s", "collective_s",
                "step_time_lower_bound_s", "model_flops",
                "useful_flops_ratio", "mfu_upper_bound", "trace_s",
                "params", "active_params", "dominant", "kind"):
        assert key in terms
    assert terms["step_time_lower_bound_s"] == max(
        terms["compute_s"], terms["memory_s"], terms["collective_s"])


def test_one_device_mesh_flops_equal_the_plain_step():
    """On a (1, 1, 1) mesh the traced flops are FlopCounterMode's over
    the plain step on the same meta inputs."""
    arch, shape = "stablelm_1_6b", "train_4k"
    cfg = get_smoke_config(arch)
    terms = dryrun.run_cell(arch, shape, True, cfg=cfg,
                            mesh_shape=(1, 1, 1), batch=4, seq=64,
                            verbose=False)
    _, kwargs, _ = input_specs(arch, shape, cfg=cfg, batch=4, seq=64)
    with FlopCounterMode(display=False) as fc:
        build_callable(arch, shape, cfg=cfg)(**kwargs)
    assert terms["flops_per_device"] == fc.get_total_flops() > 0
    # the plain smoke step's products: float32 (layers.dot's copies, the
    # logits) and bf16
    assert set(terms["flops_by_dtype"]) == {"bfloat16", "float32"}


def test_collective_stats_equal_reference():
    rng = np.random.default_rng(0)
    ops = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute"]
    records, lines = [], []
    for i in range(40):
        op = ops[int(rng.integers(0, len(ops)))]
        n = int(rng.choice([2, 4, 16, 32]))
        words = int(rng.integers(1, 1 << 20))
        records.append((op, 4 * words, n))
        lines.append(f"%c.{i} = f32[{words}]{{0}} {op}(f32[{words}]{{0}} "
                     f"%x.{i}), replica_groups=[{512 // n},{n}]<=[512]")
    want = ref_roofline.collective_stats("\n".join(lines), 512)
    got = roofline.collective_stats(records, 512)
    for op in ops:
        assert got[op]["count"] == want[op]["count"]
        assert got[op]["bytes"] == want[op]["bytes"]
        assert got[op]["seconds"] == pytest.approx(want[op]["seconds"],
                                                   rel=1e-12)
    assert got["total_bytes"] == want["total_bytes"]
    # the reference's own parsing case
    hlo = textwrap.dedent("""\
      %ar = f32[128,256]{1,0} all-reduce(f32[128,256]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%sum
    """)
    ref = ref_roofline.collective_stats(hlo, 16)
    port = roofline.collective_stats([("all-reduce", 128 * 256 * 4, 4)], 16)
    assert port["all-reduce"] == ref["all-reduce"]


def test_h100_constants_and_roofline_keys():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.PEAK_FLOPS_BY_DTYPE["bfloat16"] == 989e12
    assert roofline.PEAK_FLOPS_BY_DTYPE["float32"] == 67e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9
    rec = {"flops": {"bfloat16": 2e12, "float32": 1e11}, "bytes": 1e9,
           "memory": {"argument_bytes": 1},
           "collectives": [("all-gather", 10**9, 16)]}
    t = roofline.roofline(rec, 16, model_flops=16e12)
    assert t["flops_per_device"] == 2.1e12
    assert t["compute_s"] == 2e12 / 989e12 + 1e11 / 67e12
    assert t["collective_s"] == pytest.approx(1e9 * 15 / 16 / 50e9)
    assert t["dominant"] == "collective_s"
    assert t["useful_flops_ratio"] == 16e12 / (2.1e12 * 16)


def test_production_mesh_requires_512_devices():
    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True)   # no process group here


def test_dryrun_refuses_a_process_with_a_group():
    with dryrun.fake_group(1):
        with pytest.raises(RuntimeError, match="process of its own"):
            with dryrun.fake_group(256):
                pass


@pytest.mark.parametrize("arch,shape", [("stablelm_1_6b", "train_4k"),
                                        ("mixtral_8x22b", "prefill_32k"),
                                        ("recurrentgemma_2b", "decode_32k")])
def test_meta_peak_equals_the_same_step_on_cpu_tensors(arch, shape):
    """The traced peak over ``meta`` storages is what ``MemTracker``
    counts when the same placed step runs on real CPU tensors (zeros of
    the cell's shapes), the arguments tracked from the start: equal on
    torch 2.13; on 2.11 ``MemTracker`` reads 16,384 bytes (0.55 %) more
    for the mixtral cell, hence 1e-2."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding
    from repro_torch.launch.mesh import make_test_mesh
    cfg = get_smoke_config(arch)
    b, s = _SMALL.get(shape, (4, 64))
    terms = dryrun.run_cell(arch, shape, True, cfg=cfg,
                            mesh_shape=(1, 1, 1), batch=b, seq=s,
                            verbose=False)

    def zeros(x):
        if isinstance(x, dict):
            return {k: zeros(v) for k, v in x.items()}
        if isinstance(x, DTensor):
            return DTensor.from_local(
                torch.zeros(x.to_local().shape, dtype=x.dtype),
                x.device_mesh, x.placements, run_check=False, shape=x.shape,
                stride=x.stride())
        return x
    r = rules.rules_for(arch, shape, multi_pod=True)
    with dryrun.fake_group(1):
        mesh = make_test_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
        _, placed = dryrun.cell_inputs(arch, shape, r, mesh, cfg=cfg,
                                       batch=b, seq=s)
        placed = zeros(placed)
        fn = build_callable(arch, shape, cfg=cfg, seq=s)
        mem = MemTracker()
        mem.track_external(*(x.to_local() if isinstance(x, DTensor) else x
                             for v in placed.values()
                             for x in dryrun._leaves(v)))
        with sharding.use_rules(r, mesh), mem:
            fn(**placed)
    want = sum(d["Total"] for d in mem.get_tracker_snapshot("peak").values())
    got = terms["memory"]
    print(arch, shape, "meta peak", got["peak_bytes"], "cpu peak", want)
    assert got["argument_bytes"] == sum(dryrun.local_bytes(v)
                                        for v in placed.values())
    assert got["peak_bytes"] == pytest.approx(want, rel=1e-2)


class _Largest(torch.utils._python_dispatch.TorchDispatchMode):
    """The largest output, in bytes, of the local ops each rank runs."""

    def __init__(self):
        super().__init__()
        self.bytes, self.op = 0, None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dryrun._is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not dryrun._is_fake_op(types) and dryrun._nbytes(out) > self.bytes:
            self.bytes, self.op = dryrun._nbytes(out), func
        return out


@pytest.mark.parametrize("mesh_shape", [(4, 1), (1, 4), (2, 2)])
def test_split_loss_and_cache_stay_local(mesh_shape):
    """No rank makes a tensor at the global shape: on a mesh that splits
    the batch or the vocabulary, the loss and its grads (a 32,768-token
    vocabulary, so the logits are the step's largest tensor) make none
    larger than a rank's logits, and a prefill's cache none larger than
    a rank's piece of it. (DTensor's own gather made its backward's
    zeros at the global shape, its logsumexp gathered the vocabulary,
    and the cache was once made whole before it was cut.)"""
    import dataclasses

    from repro_torch import sharding
    from repro_torch.launch.mesh import make_test_mesh
    arch = "stablelm_1_6b"
    cfg = dataclasses.replace(get_smoke_config(arch), vocab_size=32768)
    b, s = 2 * mesh_shape[0], 256
    with dryrun.fake_group(4):
        mesh = make_test_mesh(mesh_shape, ("data", "model"), "cpu")
        r = rules.rules_for(arch, "train_4k", multi_pod=False)
        _, placed = dryrun.cell_inputs(arch, "train_4k", r, mesh, cfg=cfg,
                                       batch=b, seq=s)
        lm = LM(cfg, device="meta")
        params, batch = placed["state"]["params"], placed["batch"]
        big = _Largest()
        with sharding.use_rules(r, mesh), big:
            step.loss_and_grads(lm, params, batch)
        local_logits = 4 * (b // mesh_shape[0]) * s * (
            cfg.vocab_size // mesh_shape[1])
        assert big.bytes <= local_logits, (big.op, big.bytes, local_logits)

        r = rules.rules_for(arch, "decode_32k", multi_pod=False)
        big = _Largest()
        with sharding.use_rules(r, mesh), big:
            cache = serving.cache_specs(lm, b, s)
        piece = max(dryrun.local_bytes(x) for x in dryrun._leaves(cache))
        assert big.bytes == piece, (big.op, big.bytes, piece)


class _Scoped(_Largest):
    """:class:`_Largest` of the local ops run inside ``fn`` only (by
    wrapping the module attribute ``fn`` names), and of ``aten.cos`` and
    ``aten.sin`` only when ``trig`` is set."""

    def __init__(self, trig=False):
        super().__init__()
        self.on, self.trig = False, trig

    def wrap(self, monkeypatch, module, name):
        fn = getattr(module, name)

        def scoped(*args, **kwargs):
            self.on = True
            try:
                return fn(*args, **kwargs)
            finally:
                self.on = False
        monkeypatch.setattr(module, name, scoped)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dryrun._is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        mine = self.on or (self.trig and func in (torch.ops.aten.cos.default,
                                                  torch.ops.aten.sin.default))
        if mine and not dryrun._is_fake_op(types) and \
                dryrun._nbytes(out) > self.bytes:
            self.bytes, self.op = dryrun._nbytes(out), func
        return out


def _traced(arch, shape, mesh_shape, cfg, b, s, mode):
    """Run the cell's step once on a fake group of ``mesh_shape`` under
    the dispatch mode ``mode``, DTensor's all-to-alls as the dry-run
    counts them."""
    import math

    from repro_torch import sharding
    from repro_torch.launch.mesh import make_test_mesh
    names = ("pod", "data", "model")[-len(mesh_shape):]
    with dryrun.fake_group(math.prod(mesh_shape)):
        mesh = make_test_mesh(mesh_shape, names, "cpu")
        r = rules.rules_for(arch, shape, multi_pod=len(mesh_shape) == 3)
        _, placed = dryrun.cell_inputs(arch, shape, r, mesh, cfg=cfg,
                                       batch=b, seq=s)
        fn = build_callable(arch, shape, cfg=cfg, seq=s)
        with dryrun._alltoall_as_asked(), sharding.use_rules(r, mesh), mode:
            fn(**placed)
    return mode.bytes, mode.op


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_rope_tables_cover_a_ranks_rows(shape):
    """C5: the positions split like the tokens, so on a (2, 2, 2) mesh
    no rank makes a cos/sin table for more than its own batch rows
    (train and prefill; they were made at the global batch on every
    rank)."""
    cfg = get_smoke_config("stablelm_1_6b")
    b, s = 8, 64
    got, op = _traced("stablelm_1_6b", shape, (2, 2, 2), cfg, b, s,
                      _Scoped(trig=True))
    half = cfg.hd // 2
    rows = b // 4                       # batch over ("pod", "data")
    assert 0 < got <= rows * s * half * 4, (op, got)


def test_moe_combine_stays_at_a_ranks_groups(monkeypatch):
    """C6: four dispatch groups on a (2, 4, 1) mesh, where the batch's
    ("pod", "data") split does not divide them: each rank takes one
    group, as on a (4, 1) mesh, so no local tensor of the MoE layer is
    larger there (the prefix rule put two groups on each rank, and
    DTensor gathered the whole batch to refold it)."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"),
                              moe_groups=4)
    from repro_torch.models import moe
    sizes = []
    for mesh_shape in [(4, 1), (2, 4, 1)]:
        mode = _Scoped()
        mode.wrap(monkeypatch, moe, "moe_mlp")
        sizes.append(_traced("granite_moe_1b_a400m", "prefill_32k",
                             mesh_shape, cfg, 8, 256, mode))
        monkeypatch.undo()
    (single, _), (multi, op) = sizes
    assert 0 < multi <= single, (op, multi, single)


def test_rglru_scan_splits_over_every_mesh_dim(monkeypatch):
    """C6: on a (2, 2, 2) mesh with four batch rows, each rank scans an
    eighth of the RG-LRU's (b, s, width) float32 pairs: the block's own
    layout splits the batch over ("pod", "data") and the width over
    "model", the seq dim whole (it was a quarter: "model" left whole)."""
    from repro_torch.models import rglru
    cfg = get_smoke_config("recurrentgemma_2b")
    b, s = 4, 64
    mode = _Scoped()
    mode.wrap(monkeypatch, rglru, "linear_scan")
    got, op = _traced("recurrentgemma_2b", "train_4k", (2, 2, 2), cfg, b, s,
                      mode)
    assert 0 < got <= b * s * cfg.lru_width * 4 // 8, (op, got)


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 4)])
def test_rglru_block_leaves_no_redistribution_to_dtensor(monkeypatch,
                                                         mesh_shape):
    """C7: inside the RG-LRU block (its forward, in train_4k's step of
    the smoke model) DTensor chooses no redistribution: no op's
    operands are moved by DTensor's dispatch (``_dispatch``'s
    ``redistribute_local_tensor``, where its planner picks the
    all-to-alls, all-gathers and all-reduces), and no shard-to-shard
    all-to-all runs. Every move is one the port names (``per_rank``'s
    layouts, ``reduce_to``), so torch 2.11 and 2.13 plan the block
    alike; left to DTensor, 2.11 reduced the gate products to whole rows
    and 2.13 split their batch."""
    from torch.distributed.tensor import _dispatch, placement_types

    from repro_torch.models import rglru
    inside, calls, moved = [False], [0], []
    block = rglru.rglru_block

    def scoped(*args, **kwargs):
        inside[0] = True
        calls[0] += 1
        try:
            return block(*args, **kwargs)
        finally:
            inside[0] = False

    def watch(name, fn):
        def run(local, current, target, *args, **kwargs):
            if inside[0] and (name != "dispatch" or
                              current.placements != target.placements):
                moved.append((name, current.placements, target.placements))
            return fn(local, current, target, *args, **kwargs)
        return run
    monkeypatch.setattr(rglru, "rglru_block", scoped)
    monkeypatch.setattr(_dispatch, "redistribute_local_tensor",
                        watch("dispatch", _dispatch.redistribute_local_tensor))
    asked = dryrun._alltoall_as_asked

    @contextlib.contextmanager
    def counting():
        # inside the dry-run's own all-to-all, which it installs there
        with asked():
            alltoall = placement_types.shard_dim_alltoall

            def counted(*args, **kwargs):
                if inside[0]:
                    moved.append(("shard_dim_alltoall", args[1:3]))
                return alltoall(*args, **kwargs)
            placement_types.shard_dim_alltoall = counted
            try:
                yield
            finally:
                placement_types.shard_dim_alltoall = alltoall
    monkeypatch.setattr(dryrun, "_alltoall_as_asked", counting)
    cfg = get_smoke_config("recurrentgemma_2b")
    _traced("recurrentgemma_2b", "train_4k", mesh_shape, cfg, 8, 64,
            _Largest())
    pattern = cfg.block_pattern
    rec = [pattern[i % len(pattern)] for i in range(cfg.n_layers)].count(
        "rec")
    assert calls[0] == rec, (calls[0], rec)
    assert not moved, moved
