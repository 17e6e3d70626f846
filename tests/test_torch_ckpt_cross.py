"""HProt contexts across the two packages, both ways, bit for bit.

The same seeded train state (float32 and bfloat16 leaves under dict,
list and tuple nodes, one replicated vector, an int32 scalar) is saved
4-way sharded by each package: by the reference in a subprocess with
eight forced host devices (its sharded leaves live on the first four),
by the port on ``[cpu] * 4``. Each package then restores the other's
contexts onto 1, 2 and 8 shards: the sync manager in modes raw, delta,
pyramid and auto, and the async manager with ``delta_every=2`` across a
full rebase. For the same state the two packages write equal record
tables (name, domain, dtype, shape, codec, meta, nbytes, file, offset),
equal payload bytes and equal data files.
"""
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.ckpt import AsyncCheckpointManager
from repro_torch.hercule.checkpoint import (CheckpointManager, ShardSpec,
                                            leaf_name, state_from_numpy,
                                            state_to_numpy)
from repro_torch.hercule.database import HerculeDB

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
CPU = torch.device("cpu")
MODES = ("raw", "delta", "pyramid", "auto")
DBS = MODES + ("async",)
STEPS = {m: (1, 2) for m in MODES} | {"async": (1, 2, 3, 4, 5)}
REPLICATED = {"params.ln"}
LAYOUTS = (1, 2, 8)


def np_state(step: int) -> dict:
    """The reference-shaped state of ``step``: temporally correlated, so
    delta records pay; bfloat16 as ``ml_dtypes`` arrays."""
    rng = np.random.default_rng(20)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    emb = rng.standard_normal((16, 40)).astype(np.float32)
    ln = rng.standard_normal(24).astype(np.float32)
    # smooth, so its mean pyramid predicts it (pyramid records pay)
    pos = np.sin(np.arange(256 * 64, dtype=np.float32) / 900.0
                 ).reshape(256, 64)
    g = 1.0 + step / 100.0
    return {"params": {"w": w * g,
                       "emb": (emb * g).astype(ml_dtypes.bfloat16),
                       "ln": ln * g, "pos": pos * np.float32(g),
                       "pos16": (pos * g).astype(ml_dtypes.bfloat16)},
            "opt": [{"mu": w * np.float32(0.01 * step)},
                    ((emb * 1e-3 * step).astype(ml_dtypes.bfloat16),
                     np.abs(w[:8]) * np.float32(1e-4 * step))],
            "step": np.int32(step)}


def leaves(tree, path=""):
    """(keystr, leaf) in sorted-dict order, as ``jax.tree_util``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def assert_state(got_np: dict, step: int, ctx: str) -> None:
    want = dict(leaves(np_state(step)))
    got = dict(leaves(got_np))
    assert sorted(got) == sorted(want), ctx
    for name, w in want.items():
        g, w = bits(got[name]), bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (ctx, name)
        assert g.tobytes() == w.tobytes(), f"{ctx} {name}"


def port_template(n: int):
    """The state's layout on ``[cpu] * n`` (0-d leaves whole)."""
    def spec(path, x):
        x = bits(x)
        dt = torch.bfloat16 if np.asarray(x).dtype == np.uint16 \
            else torch.from_numpy(np.asarray(x)).dtype
        if np.ndim(x) == 0:
            return torch.empty((), dtype=dt)
        if leaf_name(path) in REPLICATED:
            return ShardSpec.replicated(np.shape(x), dt, [CPU] * n)
        return ShardSpec.rows(np.shape(x), dt, [CPU] * n)
    return _map(spec, np_state(0))


def whole_template():
    return _map(lambda p, x: torch.empty(np.shape(x), dtype=(
        torch.bfloat16 if bits(x).dtype == np.uint16
        else torch.from_numpy(np.asarray(x)).dtype)), np_state(0))


def _map(fn, tree, path=""):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], f"{path}[{k!r}]") for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def port_write(root: str) -> None:
    for mode in MODES:
        m = CheckpointManager(os.path.join(root, "pt", mode), ncf=2,
                              mode=mode, async_write=False)
        for s in STEPS[mode]:
            m.save(s, state_from_numpy(np_state(s), [CPU] * 4,
                                       replicate_names=REPLICATED))
        m.close()
    m = AsyncCheckpointManager(os.path.join(root, "pt", "async"), ncf=2,
                               delta_every=2)
    for s in STEPS["async"]:
        m.save(s, state_from_numpy(np_state(s), [CPU] * 4,
                                   replicate_names=REPLICATED))
    m.wait()
    m.close()


_REFERENCE = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [{src!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.sharding import SingleDeviceSharding
from repro.ckpt import AsyncCheckpointManager
from repro.hercule.checkpoint import CheckpointManager, leaf_name
from test_torch_ckpt_cross import (DBS, LAYOUTS, MODES, REPLICATED, STEPS,
                                   assert_state, np_state)

root = {root!r}
devs = jax.devices()

def sharding(path, x, n):
    if np.ndim(x) == 0:
        return SingleDeviceSharding(devs[0])
    mesh = Mesh(np.array(devs[:n]), ("d",))
    rep = leaf_name(path) in REPLICATED
    return NamedSharding(mesh, P() if rep else P("d"))

def jax_state(step):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jax.device_put(jnp.asarray(x), sharding(p, x, 4)),
        np_state(step))

def template(n):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype,
                                          sharding=sharding(p, x, n)),
        np_state(0))

def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)

for mode in MODES:
    m = CheckpointManager(os.path.join(root, "ref", mode), ncf=2,
                          mode=mode, async_write=False)
    for s in STEPS[mode]:
        m.save(s, jax_state(s))
    m.close()
m = AsyncCheckpointManager(os.path.join(root, "ref", "async"), ncf=2,
                           delta_every=2)
for s in STEPS["async"]:
    m.save(s, jax_state(s))
m.wait()
m.close()

results = {{}}
for db in DBS:
    path = os.path.join(root, "pt", db)
    m = AsyncCheckpointManager(path, ncf=2) if db == "async" else \\
        CheckpointManager(path, ncf=2, async_write=False)
    for s in STEPS[db]:
        for n in LAYOUTS:
            got, attrs = m.restore(template(n), step=s)
            leaf = got["params"]["w"]
            assert len(leaf.sharding.device_set) == n, leaf.sharding
            assert_state(to_np(got), s, f"reference restore {{db}} step "
                         f"{{s}} onto {{n}}")
            results[f"{{db}}/{{s}}/{{n}}"] = attrs["mode"]
    m.close()
print("RESULTS " + json.dumps(results))
"""


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """Both packages' databases, and the reference's restores of the
    port's (checked in its own process; their modes come back)."""
    root = str(tmp_path_factory.mktemp("ckpt_cross"))
    port_write(root)
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE.format(src=SRC, tests=TESTS,
                                                 root=root)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULTS "))
    return root, json.loads(line[len("RESULTS "):])


@pytest.mark.parametrize("db", DBS)
def test_reference_restores_port(cross, db):
    """The reference restores every port context bitwise onto 1, 2 and 8
    devices (the assertions ran in its process)."""
    _, results = cross
    want = {f"{db}/{s}/{n}" for s in STEPS[db] for n in LAYOUTS}
    assert want <= set(results)
    if db == "async":
        assert [results[f"async/{s}/1"] for s in STEPS[db]] == \
            ["full", "delta", "delta", "full", "delta"]


@pytest.mark.parametrize("db", DBS)
def test_port_restores_reference(cross, db):
    """The port restores every reference context bitwise onto 1, 2 and
    8 CPU shards and whole."""
    root, _ = cross
    path = os.path.join(root, "ref", db)
    m = AsyncCheckpointManager(path, ncf=2) if db == "async" else \
        CheckpointManager(path, ncf=2, async_write=False)
    try:
        for s in STEPS[db]:
            for n in LAYOUTS:
                got, _ = m.restore(port_template(n), step=s)
                assert len(got["params"]["w"].shards) == n
                assert_state(state_to_numpy(got), s,
                             f"port restore {db} step {s} onto {n}")
            got, attrs = m.restore(whole_template(), step=s)
            assert isinstance(got["params"]["emb"], torch.Tensor)
            assert got["params"]["emb"].dtype == torch.bfloat16
            assert_state(state_to_numpy(got), s, f"port restore {db} {s}")
    finally:
        m.close()


def _table(db: HerculeDB, step: int):
    view = db.view(step)
    rows = sorted((r.name, r.domain, r.dtype, list(r.shape), r.codec,
                   json.dumps(r.meta, sort_keys=True), r.nbytes, r.file,
                   r.offset) for r in view.records)
    payloads = {(r.name, r.domain): db.read_payload(r) for r in view.records}
    return rows, payloads, view.attrs


@pytest.mark.parametrize("db", DBS)
def test_record_tables_and_bytes_equal(cross, db):
    """Same state, same records, same payloads, same files."""
    root, _ = cross
    pt = HerculeDB.open(os.path.join(root, "pt", db))
    ref = HerculeDB.open(os.path.join(root, "ref", db))
    try:
        assert pt.contexts() == ref.contexts() == list(STEPS[db])
        codecs = set()
        for s in STEPS[db]:
            rows_pt, pay_pt, attrs_pt = _table(pt, s)
            rows_ref, pay_ref, attrs_ref = _table(ref, s)
            assert rows_pt == rows_ref, f"step {s}"
            assert pay_pt == pay_ref, f"step {s}"
            assert attrs_pt == attrs_ref
            codecs |= {r[4] for r in rows_pt}
            # ownership pruning: the replicated vector is written once
            ln = [r for r in rows_pt if "['ln']" in r[0]]
            assert [r[1] for r in ln] == [0]
        for f in sorted(os.listdir(os.path.join(pt.root, "data"))):
            with open(os.path.join(pt.root, "data", f), "rb") as a, \
                    open(os.path.join(ref.root, "data", f), "rb") as b:
                assert a.read() == b.read(), f
        assert sorted(os.listdir(os.path.join(pt.root, "data"))) == \
            sorted(os.listdir(os.path.join(ref.root, "data")))
    finally:
        pt.close()
        ref.close()
    want = {"raw": {"raw"}, "delta": {"raw", "fpdelta-delta"},
            "pyramid": {"raw", "fpdelta-pyramid"},
            "async": {"raw", "fpdelta-delta"}}
    if db in want:
        assert codecs == want[db], codecs
    else:   # auto: the smallest per tensor; both fpdelta codecs occur here
        assert {"fpdelta-delta", "fpdelta-pyramid"} <= codecs, codecs
