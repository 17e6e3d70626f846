"""HProt checkpointing in the port (``repro_torch.ckpt``,
``repro_torch.hercule.checkpoint``).

The cases of ``tests/test_ckpt_async.py`` and ``tests/test_elastic_
restore.py`` on the port (sharded states on ``[cpu] * N`` in one
process), the cut's consistency under in-place mutation, ownership
pruning, leaf names against ``jax.tree_util.keystr``, the bfloat16
codecs byte for byte against the reference's ``ml_dtypes`` path, and
``InTransitEngine.submit_state`` against the reference's engine. Every
state is made from a seed with numpy and crosses in through
``state_from_numpy``.
"""
import os
import signal
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import pyramid as pyr_ref
from repro.hercule import codecs as codecs_ref
from repro.hercule.checkpoint import leaf_name as leaf_name_ref
from repro.insitu import Catalog as CatalogRef
from repro.insitu import InTransitEngine as EngineRef
from repro.insitu import SpectraReducer as SpectraRef
from repro.insitu import TensorNormReducer as TNormRef
from repro_torch.ckpt import (AsyncCheckpointManager, CorruptShardError,
                              latest_complete_step)
from repro_torch.core import pyramid as pyr
from repro_torch.hercule import codecs
from repro_torch.hercule.checkpoint import (CheckpointManager, ShardSpec,
                                            ShardedTensor, _leaf_paths,
                                            leaf_name, replicate,
                                            shard_rows, state_from_numpy,
                                            state_to_numpy)
from repro_torch.hercule.database import HerculeDB, _dtype_of
from repro_torch.insitu import (Catalog, InTransitEngine, SpectraReducer,
                                TensorNormReducer)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = torch.device("cpu")


def np_state(step: int) -> dict:
    """Deterministic, temporally correlated state (as the reference's
    ``test_ckpt_async._state``)."""
    base = np.arange(96 * 32, dtype=np.float32).reshape(96, 32) / 977.0
    return {"params": {"w": base * np.float32(1.0 + step / 100.0),
                       "b": np.full(32, step, np.float32)},
            "mu": {"w": base * np.float32(0.01 * step)},
            "step": np.int32(step)}


def _state(step: int, devices=CPU):
    return state_from_numpy(np_state(step), devices)


def _template(state):
    """Each leaf's layout: tensors whole, sharded leaves as they are."""
    def spec(leaf):
        if isinstance(leaf, ShardedTensor):
            return leaf.spec()
        return torch.empty(leaf.shape, dtype=leaf.dtype)
    return jax.tree_util.tree_map(
        spec, state, is_leaf=lambda x: isinstance(x, ShardedTensor))


def _assert_tree_equal(got, want, ctx=""):
    got, want = state_to_numpy(got), state_to_numpy(want)
    flat_g = _leaf_paths(got)
    flat_w = _leaf_paths(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w], ctx
    for (p, a), (_, b) in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx}{p}"
        assert a.tobytes() == b.tobytes(), f"{ctx}{p}"


# ------------------------------------------------- test_ckpt_async cases

@pytest.mark.parametrize("backend", ["thread", "process"])
def test_async_matches_sync_restore(tmp_path, backend):
    """Full async checkpoint restores to the same bytes as a sync one."""
    state = _state(3)
    sync = CheckpointManager(str(tmp_path / "sync"), ncf=2,
                             async_write=False)
    sync.save(1, state)
    got_sync, _ = sync.restore(_template(state), step=1)
    sync.close()

    amgr = AsyncCheckpointManager(str(tmp_path / "async"), ncf=2,
                                  lane_backend=backend)
    amgr.save(1, state, attrs={"tag": "parity"})
    amgr.wait()
    got_async, attrs = amgr.restore(_template(state), step=1)
    amgr.close()

    assert attrs["tag"] == "parity" and attrs["mode"] == "full"
    _assert_tree_equal(got_async, got_sync, "async-vs-sync ")
    _assert_tree_equal(got_async, state, "async-vs-source ")


def test_delta_chain_bitexact_across_rebase(tmp_path):
    """K=2 deltas restore bit-exactly, including across the full rebase."""
    m = AsyncCheckpointManager(str(tmp_path / "d"), ncf=2, delta_every=2)
    for s in range(1, 6):
        m.save(s, _state(s))
    m.wait()
    # cycle: 1 full, 2-3 delta, 4 full rebase, 5 delta
    modes = {s: m.db.view(s).attrs["mode"] for s in range(1, 6)}
    assert modes == {1: "full", 2: "delta", 3: "delta", 4: "full",
                     5: "delta"}, modes
    w3 = m.db.view(3).record(0, "ckpt/['params']['w']")
    assert w3.codec == "fpdelta-delta" and int(w3.meta["pred_step"]) == 2
    assert "crc32" in w3.meta
    tpl = _template(_state(1))
    for s in range(1, 6):    # every step, either side of the rebase
        got, _ = m.restore(tpl, step=s)
        _assert_tree_equal(got, _state(s), f"step {s} ")
    m.close()


def test_corrupt_shard_raises(tmp_path):
    m = AsyncCheckpointManager(str(tmp_path / "c"), ncf=2)
    m.save(1, _state(1))
    m.wait()
    rec = m.db.view(1).record(0, "ckpt/['params']['w']")
    path = os.path.join(m.db.root, "data", rec.file)
    with open(path, "r+b") as f:    # flip one payload byte
        f.seek(rec.offset + rec.nbytes // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CorruptShardError, match="CRC32"):
        m.restore(_template(_state(1)), step=1)
    m.close()


def test_latest_step_skips_incomplete(tmp_path):
    """A manifest referencing truncated/missing data loses latest_step."""
    m = AsyncCheckpointManager(str(tmp_path / "t"), ncf=2)
    for s in (1, 2):
        m.save(s, _state(s))
    m.wait()
    assert m.latest_step() == 2
    # truncate the file holding step 2's records below a record extent
    recs = list(m.db.view(2).records)
    path = os.path.join(m.db.root, "data", recs[-1].file)
    with open(path, "r+b") as f:
        f.truncate(recs[-1].offset + recs[-1].nbytes - 1)
    m.db._invalidate_view(2)
    assert m.latest_step() == 1      # newest *complete* step wins
    got, _ = m.restore(_template(_state(1)))
    _assert_tree_equal(got, _state(1))
    m.close()


def test_lane_crash_no_manifest_no_deadlock(tmp_path):
    """A dying writer lane surfaces as an error, leaves no manifest for
    the in-flight step, and never deadlocks wait()."""
    m = AsyncCheckpointManager(str(tmp_path / "k"), ncf=2,
                               lane_backend="process")
    m.save(1, _state(1))
    m.wait()                          # lane exists and step 1 committed
    [proc] = m._backend._procs.values()
    os.kill(proc.pid, signal.SIGKILL)
    proc.join(timeout=10)
    m.save(2, _state(2))
    with pytest.raises(RuntimeError, match="lane"):
        m.wait(timeout=60)
    assert not os.path.exists(
        os.path.join(m.db.root, "ctx_00000002", "MANIFEST.json"))
    assert latest_complete_step(m.db) == 1
    m.close()


_KILL_SNIPPET = """
import os, sys
sys.path.insert(0, {src!r})
import numpy as np, torch
from repro_torch.ckpt import AsyncCheckpointManager
from repro_torch.hercule.checkpoint import state_from_numpy

def np_state(step):
    base = np.arange(96 * 32, dtype=np.float32).reshape(96, 32) / 977.0
    return {{"params": {{"w": base * np.float32(1.0 + step / 100.0),
                        "b": np.full(32, step, np.float32)}},
            "mu": {{"w": base * np.float32(0.01 * step)}},
            "step": np.int32(step)}}

m = AsyncCheckpointManager({root!r}, ncf=2, delta_every=2)
for s in (1, 2):
    m.save(s, state_from_numpy(np_state(s), torch.device("cpu")))
m.wait()
m.save(3, state_from_numpy(np_state(3), torch.device("cpu")))
print("SAVED", flush=True)   # step 3 still staging/writing when we die
os._exit(17)
"""


def test_kill_mid_save_recovers_previous_step(tmp_path):
    """Killing the process mid-checkpoint leaves a restorable database:
    either step 3 committed in time, or recovery lands on step 2 —
    never a torn manifest, never garbage."""
    root = str(tmp_path / "kill")
    out = subprocess.run(
        [sys.executable, "-c", _KILL_SNIPPET.format(src=SRC, root=root)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 17, (out.returncode, out.stderr[-3000:])
    assert "SAVED" in out.stdout
    db = HerculeDB.open(root)
    latest = latest_complete_step(db)
    assert latest in (2, 3), latest
    db.close()
    m = AsyncCheckpointManager(root, ncf=2)    # reopen like a restart
    got, _ = m.restore(_template(_state(latest)), step=latest)
    _assert_tree_equal(got, _state(latest), f"recovered step {latest} ")
    m.close()


def _elastic_state():
    return {"w": np.arange(64 * 8, dtype=np.float32).reshape(64, 8),
            "b": np.arange(128, dtype=np.float32) / 128.0,
            "step": np.int32(7)}


def _elastic_template(n: int):
    devs = [CPU] * n
    return {"w": ShardSpec.rows((64, 8), torch.float32, devs),
            "b": ShardSpec.rows((128,), torch.float32, devs),
            "step": torch.empty((), dtype=torch.int32)}


def _check_elastic(got, n: int) -> None:
    assert len(got["w"].shards) == n and len(got["b"].shards) == n
    assert [d for d, _, _ in got["w"].shards] == list(range(n))
    for _, sl, t in got["w"].shards:
        assert tuple(t.shape) == (64 // n, 8)
    want = _elastic_state()
    np.testing.assert_array_equal(got["w"].full().numpy(), want["w"])
    np.testing.assert_array_equal(got["b"].full().numpy(), want["b"])
    assert int(got["step"]) == 7


def test_elastic_restore_through_async_manager(tmp_path):
    """4-way sharded async save restores onto 2 shards."""
    m = AsyncCheckpointManager(str(tmp_path / "elastic"), ncf=2)
    m.save(1, state_from_numpy(_elastic_state(), [CPU] * 4))
    m.wait()
    # ownership pruning held: 4 distinct shards of w, one each
    assert len(m.db.view(1).records_named("ckpt/['w']")) == 4
    m.close()
    m = AsyncCheckpointManager(str(tmp_path / "elastic"), ncf=2)
    got, _ = m.restore(_elastic_template(2), step=1)
    _check_elastic(got, 2)
    m.close()


def test_stall_and_metrics_accounting(tmp_path):
    """Spans + metrics cover the save pipeline; stall total accumulates."""
    from repro_torch.obs import TRACER
    TRACER.enable()
    TRACER.clear()
    try:
        m = AsyncCheckpointManager(str(tmp_path / "m"), ncf=2,
                                   delta_every=2)
        for s in (1, 2):
            m.save(s, _state(s))
        m.wait()
        assert m.stall_seconds_total > 0.0
        t = m.telemetry()
        assert t["committed"] == 2 and t["pending"] == 0
        assert t["encode_seconds"] > 0.0
        assert t["bytes_to_host"] == 0     # CPU clones never cross
        snap = m.obs.snapshot()
        assert snap["ckpt_stall_seconds"]["samples"][0]["value"]["count"] == 2
        assert snap["ckpt_records_total"]["samples"][0]["value"] == 8
        modes = {s["labels"]["mode"]: s["value"]
                 for s in snap["ckpt_saves_total"]["samples"]}
        assert modes == {"full": 1.0, "delta": 1.0}
        m.close()
        names = {s["name"] for s in TRACER.spans()}
        assert {"ckpt.snapshot", "ckpt.stage", "ckpt.write",
                "ckpt.commit"} <= names, names
    finally:
        TRACER.disable()
        TRACER.clear()


# ---------------------------------------------- test_elastic_restore cases

@pytest.mark.parametrize("restore_n", [2, 8])
def test_restore_onto_different_shard_layout(tmp_path, restore_n):
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, ncf=2, async_write=False)
    mgr.save(1, state_from_numpy(_elastic_state(), [CPU] * 4))
    mgr.close()
    # ownership pruning: 4 distinct shards of w were written, one each
    assert len(mgr.db.records(1, name="['w']")) == 4
    mgr = CheckpointManager(root, ncf=2, async_write=False)
    got, _ = mgr.restore(_elastic_template(restore_n), step=1)
    _check_elastic(got, restore_n)
    mgr.close()


# ------------------------------------------------- the port's own contract

@pytest.mark.parametrize("manager", ["sync-async-write", "async"])
def test_cut_survives_in_place_mutation(tmp_path, manager):
    """What ``save`` returned on is what restores, whatever the caller
    does to its tensors afterwards (the CPU twin of the card's check)."""
    state = _state(2, [CPU] * 4)
    want = state_to_numpy(state)
    m = CheckpointManager(str(tmp_path / "s"), ncf=2) \
        if manager == "sync-async-write" else \
        AsyncCheckpointManager(str(tmp_path / "a"), ncf=2)
    m.save(1, state)
    for leaf in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, ShardedTensor)):
        for t in ([t for _, _, t in leaf.shards]
                  if isinstance(leaf, ShardedTensor) else [leaf]):
            t.add_(1)
    m.wait()
    got, _ = m.restore(_template(state), step=1)
    m.close()
    _assert_tree_equal(got, state_from_numpy(want, CPU), "cut ")


def test_ownership_pruning_writes_replicas_once(tmp_path):
    w = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    state = {"rep": replicate(w[0], [CPU] * 4), "w": shard_rows(w, [CPU] * 4)}
    m = CheckpointManager(str(tmp_path / "o"), ncf=2, async_write=False)
    m.save(1, state)
    view = m.db.view(1)
    assert [r.domain for r in view.records_named("['rep']")] == [0]
    assert sorted(r.domain for r in view.records_named("['w']")) == \
        [0, 1, 2, 3]
    got, _ = m.restore({"rep": ShardSpec.replicated((4,), torch.float32,
                                                    [CPU] * 2),
                        "w": torch.empty(16, 4)}, step=1)
    m.close()
    assert [d for d, _, _ in got["rep"].shards] == [0, 1]
    assert all(torch.equal(t, w[0]) for _, _, t in got["rep"].shards)
    assert torch.equal(got["w"], w)


def test_template_mismatch_and_rows_raise(tmp_path):
    with pytest.raises(ValueError, match="multiple of 4"):
        shard_rows(torch.zeros(6, 2), [CPU] * 4)
    m = CheckpointManager(str(tmp_path / "x"), ncf=2, async_write=False)
    m.save(1, {"w": torch.zeros(8, 2)})
    with pytest.raises(TypeError, match="dtype"):
        m.restore({"w": torch.empty(8, 2, dtype=torch.float64)}, step=1)
    with pytest.raises(ValueError, match="shape"):
        m.restore({"w": ShardSpec.rows((4, 2), torch.float32, [CPU] * 2)},
                  step=1)
    m.close()


def test_default_devices_need_a_card(tmp_path, monkeypatch):
    """Helpers that default their device take the GPU and raise without
    one: ``state_from_numpy`` with no device, a ``meta`` template."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(np_state(1))
    m = CheckpointManager(str(tmp_path / "meta"), ncf=2, async_write=False)
    m.save(1, _state(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.restore({"step": torch.empty((), dtype=torch.int32,
                                       device="meta")}, step=1)
    got, _ = m.restore({"step": torch.empty((), dtype=torch.int32)}, step=1)
    m.close()
    assert int(got["step"]) == 1


def test_scalar_and_numpy_leaves_as_the_reference(tmp_path):
    """A 0-d leaf is shape [] with slices []; numpy and Python leaves
    write no slices and restore as numpy; dtypes are numpy's names."""
    m = CheckpointManager(str(tmp_path / "n"), ncf=2, async_write=False)
    m.save(1, {"a": np.arange(6, dtype=np.int16).reshape(2, 3), "f": 1.5,
               "t": torch.tensor(True), "bf": torch.ones(2, 2,
                                                         dtype=torch.bfloat16)})
    view = m.db.view(1)
    recs = {r.name: r for r in view.records}
    assert recs["['t']"].shape == () and recs["['t']"].meta["slices"] == []
    assert recs["['t']"].dtype == "bool"
    assert recs["['f']"].dtype == "float64"
    assert recs["['a']"].meta["slices"] == []
    assert recs["['bf']"].dtype == "bfloat16"
    assert recs["['bf']"].meta["slices"] == [[0, 2], [0, 2]]
    got, _ = m.restore({"a": None, "f": 0.0, "t": torch.empty((), dtype=
                                                               torch.bool),
                        "bf": torch.empty(2, 2, dtype=torch.bfloat16)},
                       step=1)
    m.close()
    assert got["a"] is None and got["f"] == 1.5 and bool(got["t"])
    assert torch.equal(got["bf"], torch.ones(2, 2, dtype=torch.bfloat16))
    assert _dtype_of("bfloat16") == np.uint16


# ------------------------------------------------------------ leaf names

def test_leaf_names_are_jax_keystr():
    tree = {"params": {"w": 1, "b": [2, (3, {"z": 4, "a": 5})]},
            "opt": ({"mu": 6}, [7]), "ids": {3: 8, 1: 9}, "n": None,
            "it's": [10]}
    want = [(jax.tree_util.keystr(p), v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert _leaf_paths(tree) == want
    assert [leaf_name(p) for p, _ in _leaf_paths(tree)] == \
        [leaf_name_ref(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert leaf_name("['params']['w']") == "params.w"


# --------------------------------------------------------- bf16 codecs

@pytest.mark.parametrize("n,seed", [(64, 0), (777, 1), (5000, 2)])
def test_bf16_codecs_byte_equal_to_reference(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 0.02).astype(np.float32)
    x[:4] = [np.nan, -np.inf, -np.nan, 3e38]
    with np.errstate(over="ignore"):
        prev = (x * 1.001 + 1e-4).astype(ml_dtypes.bfloat16)
    x = x.astype(ml_dtypes.bfloat16)
    xb, pb = x.view(np.uint16), prev.view(np.uint16)
    want = codecs_ref.encode_delta(pyr_ref.encode_delta(x, prev))
    dc = pyr.encode_delta(xb, pb, dtype="bfloat16")
    assert codecs.encode_delta(dc) == want
    as_torch = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                for a in (xb, pb)]
    assert codecs.encode_delta(pyr.encode_delta(*as_torch)) == want
    back = codecs.decode_delta_bytes(want, pb, {"pad": dc.pad},
                                     _dtype_of("bfloat16"), (n,))
    assert back.dtype == np.uint16 and back.tobytes() == xb.tobytes()

    want = codecs_ref.encode_pyramid(pyr_ref.encode_pyramid(x))
    pc = pyr.encode_pyramid(xb, dtype="bfloat16")
    assert codecs.encode_pyramid(pc) == want
    back = codecs.decode_pyramid_bytes(want, {"pad": pc.pad},
                                       _dtype_of("bfloat16"), (n,))
    assert back.dtype == np.uint16 and back.tobytes() == xb.tobytes()


def test_bf16_mean_rounds_as_ml_dtypes():
    """The pyramid's float64 means round to bfloat16 through float32, as
    ``ml_dtypes`` casts (ties, NaN signs, overflow)."""
    from repro_torch.core import bitstream as bs
    x = np.array([1 + 2**-8 + 2**-30, 1 + 2**-8, -(1 + 2**-9 + 2**-20),
                  np.nan, -np.nan, np.inf, 3.4e38, 1e-41, -0.0])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    with np.errstate(over="ignore"):
        got = bs.f32_to_bf16_bits(x.astype(np.float32))
    assert got.tobytes() == want.tobytes()
    assert bs.bf16_bits_to_f32(got).tobytes() == \
        want.view(ml_dtypes.bfloat16).astype(np.float32).tobytes()


# ----------------------------------------------------------- submit_state

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_submit_state_tensor_flow(tmp_path, dtype):
    """``tests/test_insitu.py::test_engine_tensor_flow`` on the port:
    only matrix-shaped leaves are staged, named as HProt names them; a
    bfloat16 leaf stages on the host as its float32 values."""
    w = np.arange(256, dtype=np.float32).reshape(16, 16) / 256.0
    w = w.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else w
    state = {"params": {"w": w, "bias": np.ones(4, np.float32)}}
    eng = InTransitEngine(str(tmp_path / "db"), [TensorNormReducer()]).start()
    assert eng.submit_state(2, state_from_numpy(state, CPU))
    eng.close()
    out = Catalog(str(tmp_path / "db")).query(2, "tnorm")
    assert list(out["names"]) == ["w"]       # bias is not matrix-shaped
    np.testing.assert_allclose(out["stats"][0, 0],
                               np.linalg.norm(w.astype(np.float32).ravel()),
                               rtol=1e-6)


def test_submit_state_matches_reference(tmp_path):
    """``tests/test_merge.py::test_tensor_concat_and_union_merge``
    against the reference engine: names and shapes exactly, float32
    statistics and singular values within rtol 1e-5, atol 1e-6 (sums in
    another order than XLA's); one and two contributor groups; a leaf
    row-sharded over four CPU shards is assembled whole."""
    rng = np.random.default_rng(3)
    state = {"params": {f"l{i}/w": rng.standard_normal((12, 12)).astype(
        np.float32) for i in range(5)}}
    for g in (1, 2):
        objs = {}
        for pkg, eng_cls, reds, st in (
                ("ref", EngineRef, [TNormRef(), SpectraRef(k=4)],
                 jax.tree_util.tree_map(jax.numpy.asarray, state)),
                ("pt", InTransitEngine, [TensorNormReducer(),
                                         SpectraReducer(k=4)],
                 state_from_numpy(state, [CPU] * 4))):
            root = str(tmp_path / f"{pkg}{g}")
            eng = eng_cls(root, reds, domains=g, policy="block").start()
            assert eng.submit_state(1, st)
            eng.close()
            cat = (CatalogRef if pkg == "ref" else Catalog)(root)
            objs[pkg] = {r: cat.query(1, r) for r in cat.reducers(1)}
        assert sorted(objs["pt"]) == sorted(objs["ref"])
        for r, ref in objs["ref"].items():
            assert sorted(objs["pt"][r]) == sorted(ref)
            for k, v in ref.items():
                got = objs["pt"][r][k]
                assert got.dtype == v.dtype and got.shape == v.shape, (r, k)
                if v.dtype.kind == "f":
                    np.testing.assert_allclose(got, v, rtol=1e-5, atol=1e-6)
                else:
                    np.testing.assert_array_equal(got, v)


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the cut clones on the card's "
                    "streams and copies down through pinned memory)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_cut_consistent_under_in_place_mutation(tmp_path, cuda_device):
    """``save`` returns without waiting for the card; tensors mutated in
    place right after it (on the same stream) restore as they were when
    ``save`` was called, bitwise, in every layout, through delta chains."""
    m = AsyncCheckpointManager(str(tmp_path / "g"), ncf=2, delta_every=2)
    want = {}
    state = _state(0, [cuda_device] * 4)
    for s in (1, 2, 3):
        for leaf in (state["params"]["w"], state["mu"]["w"]):
            for _, _, t in leaf.shards:
                t.mul_(1.0 + 1e-3 * s)
        want[s] = state_to_numpy(state)
        m.save(s, state)
        for _, _, t in state["params"]["w"].shards:
            t.add_(1.0)     # queued right behind the cut's clones
        for _, _, t in state["mu"]["w"].shards:
            t.add_(1.0)
    m.wait()
    assert m.telemetry()["bytes_to_host"] > 0
    for s in (1, 2, 3):
        for n in (1, 4):
            got, _ = m.restore(_template(_state(0, [cuda_device] * n)),
                               step=s)
            _assert_tree_equal(got, state_from_numpy(want[s], CPU),
                               f"step {s} onto {n} ")
    m.close()
