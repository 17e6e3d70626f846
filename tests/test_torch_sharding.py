"""The port's sharding layer (``repro_torch.sharding``,
``launch.rules``) against the reference's: spec resolution, rule tables,
DTensor local shapes on a fake (2, 16, 16) mesh, and ``constrain``
outside ``use_rules``. Fake process groups are torn down in a
``finally`` (``dryrun.fake_group``): xdist's ``loadfile`` shares a
worker's process between files."""
import itertools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # fall back to fixed-example replay (tests/_hypothesis_fallback.py)
    from _hypothesis_fallback import given, settings, strategies as st

from repro import sharding as ref_sharding
from repro.configs import get_config as ref_config
from repro.launch import rules as ref_rules
from repro.models.transformer import LM as RefLM
from repro_torch import sharding
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun, rules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers
from repro_torch.models.transformer import LM, tree_leaves

from lm_cases import inputs

CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def test_resolve_spec_divisibility():
    mesh = _FakeMesh({"data": 16, "model": 16})
    r = sharding.merge_rules()
    # kv_heads=8 not divisible by model=16 -> replicated
    spec = sharding.resolve_spec((1024, 8, 128),
                                 ("fsdp", "kv_heads", "head_dim"), r, mesh)
    assert spec == ("data", None, None)
    # heads=48 divisible by 16 -> sharded
    spec = sharding.resolve_spec((1024, 48, 128),
                                 ("fsdp", "heads", "head_dim"), r, mesh)
    assert spec[1] == "model"


def test_resolve_spec_multi_axis_batch():
    mesh = _FakeMesh({"pod": 2, "data": 16, "model": 16})
    r = sharding.merge_rules()
    spec = sharding.resolve_spec((256, 4096), ("batch", "seq"), r, mesh)
    assert spec[0] == ("pod", "data")
    # batch=1 (long_500k) -> replicated
    spec = sharding.resolve_spec((1, 524288), ("batch", "seq"), r, mesh)
    assert spec[0] is None


def test_no_axis_reuse_within_tensor():
    mesh = _FakeMesh({"data": 16, "model": 16})
    r = sharding.merge_rules({"experts": "model", "mlp": "model"})
    spec = sharding.resolve_spec((32, 1024, 512),
                                 ("experts", "fsdp", "mlp"), r, mesh)
    used = [a for part in spec for a in
            ((part,) if isinstance(part, str) else (part or ()))]
    assert len(used) == len(set(used))


_AXES = ("pod", "data", "model", "seq")     # "seq" is in no mesh here


def random_case(seed: int):
    """A random mesh (some of pod/data/model, sizes 1-8), rules mapping
    logical names to None, an axis name (maybe absent from the mesh) or
    a tuple of them, and a tensor of 1-4 dims with logical axes."""
    rng = np.random.default_rng(seed)
    names = [a for a in _AXES[:3] if rng.random() < 0.7] or ["data"]
    mesh = _FakeMesh({a: int(rng.choice([1, 2, 3, 4, 8])) for a in names})
    logical = [f"l{i}" for i in range(5)]
    r = {}
    for name in logical:
        k = int(rng.integers(0, 4))
        pick = list(rng.choice(_AXES, size=max(k, 1), replace=False))
        r[name] = None if k == 0 else (pick[0] if k == 1 else tuple(pick))
    ndim = int(rng.integers(1, 5))
    shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 12, 16, 24, 48]))
                  for _ in range(ndim))
    axes = tuple(None if rng.random() < 0.2 else str(rng.choice(logical))
                 for _ in range(ndim))
    return shape, axes, r, mesh


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_resolve_spec_equals_reference(seed):
    shape, axes, r, mesh = random_case(seed)
    want = tuple(ref_sharding.resolve_spec(shape, axes, r, mesh))
    assert sharding.resolve_spec(shape, axes, r, mesh) == want


def test_default_rules_and_merge_equal_reference():
    assert sharding.DEFAULT_RULES == ref_sharding.DEFAULT_RULES
    o = {"seq": "model", "fsdp": ("data", "pod")}
    assert sharding.merge_rules(o, None, {"x": None}) == \
        ref_sharding.merge_rules(o, None, {"x": None})


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_for_equals_reference(multi_pod):
    for arch, shape in itertools.product(ARCHS, SHAPES):
        assert rules.rules_for(arch, shape, multi_pod=multi_pod) == \
            ref_rules.rules_for(arch, shape, multi_pod=multi_pod), \
            (arch, shape)
    o = {"seq": "model"}
    assert rules.rules_for("nemotron_4_340b", "train_4k", multi_pod=True,
                           override=o) == ref_rules.rules_for(
        "nemotron_4_340b", "train_4k", multi_pod=True, override=o)


def test_placements_give_the_reference_local_shapes():
    """Every parameter of the ten archs at full config, placed as a meta
    DTensor on a fake (2, 16, 16) mesh: its local shape is the one the
    reference's spec implies (dim / product of its mesh axes)."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    with dryrun.fake_group(512):
        mesh = make_production_mesh(multi_pod=True)
        assert sharding.mesh_sizes(mesh) == sizes
        for arch in ARCHS:
            r = rules.rules_for(arch, "train_4k", multi_pod=True)
            ref_axes = dict(tree_leaves(RefLM(ref_config(arch)).param_axes()))
            lm = LM(get_config(arch), device="meta")
            placed = sharding.tree_distribute(lm.abstract_params(),
                                              lm.param_axes(), r, mesh)
            place = dict(tree_leaves(sharding.tree_placements(
                lm.abstract_params(), lm.param_axes(), r, mesh)))
            for path, t in tree_leaves(placed):
                spec = ref_sharding.resolve_spec(
                    tuple(t.shape), ref_axes[path], r, _FakeMesh(sizes))
                want = tuple(
                    n // int(np.prod([sizes[a] for a in (
                        () if p is None else (p,) if isinstance(p, str)
                        else p)])) for n, p in zip(t.shape, spec))
                assert tuple(t.to_local().shape) == want, (arch, path)
                assert t.placements == place[path], (arch, path)
                assert t.to_local().device.type == "meta"


def test_placements_shard_in_mesh_order_and_skip_size_one_dims():
    from torch.distributed.tensor import Replicate, Shard
    with dryrun.fake_group(8):
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh((2, 4, 1), ("pod", "data", "model"), "cpu")
        assert sharding.placements((("data", "pod"), "model", None),
                                   mesh) == (Shard(0), Shard(0), Replicate())
        assert sharding.placements((None, "data"), mesh) == \
            (Replicate(), Shard(1), Replicate())


def test_constrain_is_identity_outside_use_rules():
    x = torch.ones(4, 8)
    assert sharding.active() is None
    assert sharding.constrain(x, "batch", "embed") is x
    with dryrun.fake_group(1):
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh((1, 1), ("data", "model"), "cpu")
        with sharding.use_rules(sharding.merge_rules(), mesh):
            assert sharding.active()[1] is mesh
            # a plain tensor inside use_rules is left as it is
            assert sharding.constrain(x, "batch", "embed") is x
        assert sharding.active() is None


@pytest.mark.parametrize("arch", ARCHS)
def test_constrain_leaves_the_forward_bitwise(arch, monkeypatch):
    """The smoke forward with every ``constrain`` call site live (outside
    ``use_rules``) against the same forward with them cut out."""
    cfg = get_smoke_config(arch)
    lm = LM(cfg, device=CPU)
    lm.init(torch.Generator().manual_seed(0))
    tokens, extras = inputs(cfg, 2, 16)
    tokens = torch.from_numpy(tokens)
    extras = {k: torch.from_numpy(v) for k, v in extras.items()}
    with torch.no_grad():
        want, want_aux = lm(tokens, extras)
        monkeypatch.setattr(sharding, "constrain", lambda x, *axes: x)
        got, got_aux = lm(tokens, extras)
    assert torch.equal(got, want) and torch.equal(got_aux, want_aux)


def test_wcast_and_trees():
    specs = {"a": layers.ParamSpec((4, 6), ("fsdp", "mlp")),
             "b": {"c": layers.ParamSpec((3,), ("embed",))}}
    assert layers.axes_tree(specs) == {"a": ("fsdp", "mlp"),
                                       "b": {"c": ("embed",)}}
    shapes = layers.shapes_tree(specs, torch.bfloat16)
    assert shapes["a"].device.type == "meta"
    assert shapes["a"].shape == (4, 6) and shapes["b"]["c"].shape == (3,)
    assert shapes["a"].dtype == torch.bfloat16
    w = torch.randn(4, 6)
    assert torch.equal(layers.wcast(w, torch.bfloat16, "fsdp", "mlp"),
                       w.to(torch.bfloat16))


def _mesh_step_against_plain(arch: str, device, backend: str):
    """Three AdamW steps of the smoke config on a (1, 1) mesh of a real
    group of one rank, state placed by ``rules_for``, against the plain
    step from the same init: losses and parameters bitwise."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train import optim, step
    cfg = get_smoke_config(arch)

    def fresh():
        lm = LM(cfg, device=device)
        return lm, step.init_state(
            lm, torch.Generator(device=device).manual_seed(3))
    tokens = torch.from_numpy(inputs(cfg, 2, 32)[0]).long().to(device)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    lm, state = fresh()
    train = step.make_train_step(lm, optim.OptConfig(warmup_steps=1))
    want = []
    for _ in range(3):
        state, m = train(state, batch)
        want.append(m["loss"].clone())
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh(device.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        r = rules.rules_for(arch, "train_4k", multi_pod=False)
        lm2, state2 = fresh()
        placed = sharding.tree_distribute(state2, step.state_axes(lm2), r,
                                          mesh)
        pbatch = {k: sharding.distribute(v, ("batch", "seq"), r, mesh)
                  for k, v in batch.items()}
        train2 = step.make_train_step(lm2, optim.OptConfig(warmup_steps=1))
        got = []
        for _ in range(3):
            with sharding.use_rules(r, mesh):
                placed, m = train2(placed, pbatch)
            got.append(m["loss"].full_tensor().clone())
        assert [float(x) for x in got] == [float(x) for x in want]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        for (path, a), (_, b) in zip(tree_leaves(state["params"]),
                                     tree_leaves(placed["params"])):
            assert torch.equal(a, b.full_tensor()), path
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "granite_moe_1b_a400m",
                                  "nemotron_4_340b", "mamba2_1_3b"])
def test_one_rank_mesh_step_bitwise_plain_step_cpu(arch):
    # nemotron's smoke config takes two microbatches; mamba2 runs the
    # SSD einsums
    _mesh_step_against_plain(arch, CPU, "gloo")


@pytest.mark.gpu
def test_one_rank_nccl_mesh_step_bitwise_plain_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _mesh_step_against_plain("stablelm_1_6b", torch.device("cuda", 0),
                             "nccl")


# one rank of a (2, 2) ("data", "model") gloo mesh: the sharded einsum
# and three AdamW steps of smoke configs at float32 compute, against the
# plain ones on the same rank
_RANK = """
import contextlib, dataclasses, json, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import sharding
from repro_torch.configs import get_smoke_config
from repro_torch.launch.rules import rules_for
from repro_torch.models import serving
from repro_torch.models.transformer import LM, tree_leaves
from repro_torch.train import optim, step

def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x

def worst(a, b):
    # the leaf of the largest |a - b| / |b| (norms), as (err, path)
    return max((float((a[k] - b[k]).norm() / max(float(b[k].norm()), 1e-30)),
                k) for k in b)

rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
try:
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = sharding.merge_rules()
    g = torch.Generator().manual_seed(0)
    cases = [
        ("bqhd,bkhd->bhqk", (4, 8, 4, 16), ("batch", "seq", "heads", None),
         (4, 8, 4, 16), ("batch", "seq", "heads", None)),
        ("bsd,dhk->bshk", (4, 8, 16), ("batch", "seq", "embed"),
         (16, 4, 8), ("fsdp", "heads", "head_dim")),
        ("bshk,hkd->bsd", (4, 8, 4, 8), ("batch", "seq", "heads", None),
         (4, 8, 16), ("heads", "head_dim", "fsdp")),
        ("...d,df->...f", (4, 8, 16), ("batch", "seq", "embed"),
         (16, 6), ("fsdp", "mlp")),
        ("ecd,edf->ecf", (4, 6, 16), ("experts", None, "expert_in"),
         (4, 16, 8), ("experts", "expert_in", "expert_mlp")),
        ("bcqn,bchpn->bcqhp", (4, 2, 8, 6), ("batch", None, None, None),
         (4, 2, 4, 3, 6), ("batch", None, "heads", None, None)),
    ]
    out = {"einsum": 0.0}
    with sharding.use_rules(rules, mesh):
        for eq, sa, aa, sb, ab in cases:
            a, b = torch.randn(sa, generator=g), torch.randn(sb, generator=g)
            got = sharding.einsum(eq, sharding.distribute(a, aa, rules, mesh),
                                  sharding.distribute(b, ab, rules, mesh))
            err = (got.full_tensor() - torch.einsum(eq, a, b)).abs().max()
            out["einsum"] = max(out["einsum"], float(err))
    for arch in sys.argv[3].split(","):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        gen = torch.Generator().manual_seed(5)
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
        if cfg.family == "encdec":
            batch["frames"] = torch.randn((4, cfg.n_frames, cfg.d_model),
                                          generator=gen)
            axes["frames"] = ("batch", "frames", "embed")
        runs, grads, params1 = [], [], []
        for placed in (False, True):
            lm = LM(cfg, device="cpu")
            st = step.init_state(lm, torch.Generator().manual_seed(3))
            train = step.make_train_step(lm, optim.OptConfig(warmup_steps=1))
            r = rules_for(arch, "train_4k", multi_pod=False)
            b = batch
            if placed:
                st = sharding.tree_distribute(st, step.state_axes(lm), r, mesh)
                b = {k: sharding.distribute(v, axes[k], r, mesh)
                     for k, v in batch.items()}
            with sharding.use_rules(r, mesh) if placed else \
                    contextlib.nullcontext():
                _, g = step.loss_and_grads(lm, st["params"], b)
            grads.append({k: full(v) for k, v in tree_leaves(g)})
            losses, norms = [], []
            for i in range(3):
                if placed:
                    with sharding.use_rules(r, mesh):
                        st, m = train(st, b)
                    m = {k: full(v) for k, v in m.items()}
                else:
                    st, m = train(st, b)
                if i == 0:
                    params1.append({k: full(v).clone()
                                    for k, v in tree_leaves(st["params"])})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            runs.append((losses, norms))
        out[arch] = runs
        out["grads " + arch] = worst(grads[1], grads[0])
        out["params " + arch] = worst(params1[1], params1[0])
    for arch in sys.argv[4].split(","):
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        lm = LM(cfg, device="cpu")
        params = lm.init(torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (4, 14), generator=gen)
        extras = {}
        if cfg.family == "encdec":
            extras["frames"] = torch.randn((4, cfg.n_frames, cfg.d_model),
                                           generator=gen)
        r = rules_for(arch, "decode_32k", multi_pod=False)
        logits = []
        for placed in (False, True):
            p, t, ex = params, toks, extras
            if placed:
                p = sharding.tree_distribute(params, lm.param_axes(), r, mesh)
                t = sharding.distribute(toks, ("batch", "seq"), r, mesh)
                ex = {k: sharding.distribute(v, ("batch", "frames", "embed"),
                                             r, mesh) for k, v in ex.items()}
            with sharding.use_rules(r, mesh) if placed else \
                    contextlib.nullcontext():
                # a 10-token prompt: past recurrentgemma's smoke window
                # of 8 (the ring), short of the others' 16-slot cache
                lg, cache = serving.prefill(lm, p, t[:, :10], extras=ex,
                                            max_seq=16)
                seen = [lg]
                for i in range(10, 14):
                    lg, cache = serving.decode_step(lm, p, t[:, i], i, cache)
                    seen.append(lg)
            logits.append([getattr(x, "full_tensor", lambda x=x: x)()
                           for x in seen])
        out["decode " + arch] = max(
            float((a - b).abs().max() / b.abs().max())
            for a, b in zip(logits[1], logits[0]))
    if rank == 0:
        print("RESULT " + json.dumps(out))
finally:
    dist.destroy_process_group()
"""


def test_four_rank_mesh_matches_the_plain_step():
    """On four gloo ranks, a (2, 2) mesh (every placement a real split):
    the sharded einsum against ``torch.einsum``; prefill and decode of
    three families with the cache split as decode_32k splits it, within
    5e-4 of the largest logit; and three AdamW steps of
    four families at float32 compute against the plain steps: the same
    sums in other orders, so the first loss within 1e-6 relative; every
    leaf of the first step's grads and of the parameters after it within
    1e-3 (relative norms); the
    first grad norm and the later losses within 2e-3 (the plain float32
    grads of these smoke models are themselves up to 1.1e-3 from
    float64, at whisper's encoder norm, and AdamW's first update turns
    such noise into a +-lr step; whisper's later grad norms, 68 -> 17 ->
    75-80, swing with it, so they are printed, not held)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    archs = "stablelm_1_6b,granite_moe_1b_a400m,mamba2_1_3b,whisper_medium"
    decode = "stablelm_1_6b,recurrentgemma_2b,whisper_medium"
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port,
                               archs, decode], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    line = [x for x in outs[0][0].splitlines() if x.startswith("RESULT ")]
    out = json.loads(line[0][len("RESULT "):])
    assert out["einsum"] < 1e-5
    for arch in archs.split(","):
        (plain_l, plain_n), (mesh_l, mesh_n) = out[arch]
        print(arch, "losses", mesh_l, plain_l, "grad norms", mesh_n, plain_n,
              "worst leaf: grads", out["grads " + arch], "params after "
              "step 1", out["params " + arch])
        assert np.allclose(mesh_l[0], plain_l[0], rtol=1e-6, atol=0), arch
        assert np.allclose(mesh_l, plain_l, rtol=2e-3, atol=0), arch
        assert np.allclose(mesh_n[0], plain_n[0], rtol=2e-3, atol=0), arch
        # leaf by leaf, as relative norms: the first step's grads (a leaf
        # off by a constant factor moves neither the losses nor AdamW's
        # scale-free update) and the parameters after it; the worst seen
        # is 2.0e-4 and 1.3e-4, at whisper's layer-norm biases
        assert out["grads " + arch][0] < 1e-3, (arch, out["grads " + arch])
        assert out["params " + arch][0] < 1e-3, (arch, out["params " + arch])
    for arch in decode.split(","):
        # prefill and four decode steps with the cache's kv_seq split over
        # "model" (decode_32k's rule) against the plain ones: the plain
        # float32 decode of whisper's smoke model is itself up to 2.0e-4
        # from float64 on these inputs; a misplaced cache slot moves the
        # logits by 0.6-1.7
        assert out["decode " + arch] < 5e-4, (arch, out["decode " + arch])
