"""The port's trainer (``repro_torch.train.trainer``, ``supervisor``,
``data.pipeline``, ``launch.train``) against the reference's.

The reference's ``test_integration.py`` contracts run on the port's
``minicpm_2b`` smoke config on the CPU; the token pipeline and the
straggler monitor are held to the reference's exactly; a reference
``Trainer`` and the port's start from one step-0 HProt context (the
reference's ParamSpecs drawn with numpy) and train at float32 compute;
each package's trainer resumes from the other's checkpoint; and a save
and an in-transit submission at step k still read as step k after the
in-place update of step k + 1.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_cases import CPU, leaves, spec_params, with_dtype
from repro.configs import get_smoke_config as ref_smoke
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.hercule.checkpoint import CheckpointManager as RefManager
from repro.models.transformer import LM as RefLM
from repro.train import optim as ref_optim
from repro.train.trainer import StragglerMonitor as RefStragglerMonitor
from repro.train.trainer import Trainer as RefTrainer
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.hercule.checkpoint import CheckpointManager, state_to_numpy
from repro_torch.insitu import Catalog, TensorNormReducer
from repro_torch.models.transformer import LM
from repro_torch.train import optim
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import StragglerMonitor, Trainer

ARCH = "minicpm_2b"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _cfgs(dtype=None):
    cfg, ref = get_smoke_config(ARCH), ref_smoke(ARCH)
    if dtype:
        cfg, ref = with_dtype(cfg, dtype), with_dtype(ref, dtype)
    return cfg, ref


def _mk_trainer(ckpt_dir, cfg=None, device=CPU, **kw):
    cfg = cfg or get_smoke_config(ARCH)
    return Trainer(
        LM(cfg, device=device), ckpt_dir=ckpt_dir, log_every=0,
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4),
        opt_cfg=optim.OptConfig(lr=1e-3, warmup_steps=2, stable_steps=100,
                                decay_steps=10),
        device=device, **kw)


def _mk_ref_trainer(ckpt_dir, cfg, **kw):
    return RefTrainer(
        RefLM(cfg), ckpt_dir=ckpt_dir, log_every=0,
        data_cfg=RefDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               global_batch=4),
        opt_cfg=ref_optim.OptConfig(lr=1e-3, warmup_steps=2,
                                    stable_steps=100, decay_steps=10),
        **kw)


def _np_state(state) -> dict:
    """(dotted name, numpy array) of a state of either package."""
    if isinstance(jax.tree.leaves(state)[0], jax.Array):
        state = jax.tree.map(np.asarray, state)
    else:
        state = state_to_numpy(state)
    return {k: np.asarray(v) for k, v in leaves(state)}


def _assert_bitwise(got, want):
    got, want = _np_state(got), _np_state(want)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


# --------------------------------------------------------- data, monitor

@pytest.mark.parametrize("seed,step,host_index,host_count,zipf", [
    (0, 0, 0, 1, 1.1), (0, 7, 1, 2, 1.1), (3, 123_456, 3, 4, 1.1),
    (2 ** 31 - 1, 2 ** 40, 0, 2, 1.1), (11, 5, 2, 8, 0.8),
    (5, 99, 0, 1, 1.5)])
def test_token_pipeline_matches_reference(seed, step, host_index,
                                          host_count, zipf):
    """Tokens and labels bitwise the reference's (int32, same shape) at
    large seeds and steps (uint64 wraps) and every host shard."""
    kw = dict(vocab_size=1031, seq_len=37, global_batch=16, seed=seed,
              zipf=zipf)
    got = TokenPipeline(DataConfig(**kw)).batch(
        step, host_index=host_index, host_count=host_count)
    want = RefTokenPipeline(RefDataConfig(**kw)).batch(
        step, host_index=host_index, host_count=host_count)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].shape == want[k].shape == (16 // host_count, 37)
        assert got[k].tobytes() == want[k].tobytes(), k


def test_straggler_monitor_matches_reference():
    """The same events and baseline, exactly, on one seeded sequence of
    step times with spikes (the same float arithmetic in both)."""
    rng = np.random.default_rng(17)
    times = rng.lognormal(-2.0, 0.3, 200)
    times[rng.choice(200, 12, replace=False)] *= rng.uniform(2, 20, 12)
    got, want = StragglerMonitor(), RefStragglerMonitor()
    for i, dt in enumerate(times.tolist()):
        assert got.observe(i, dt) == want.observe(i, dt), i
    assert got.events == want.events and len(got.events) > 0
    assert got.ewma == want.ewma


def test_straggler_monitor():
    """The reference's own case."""
    m = StragglerMonitor(factor=3.0, warmup=2)
    for i in range(6):
        assert not m.observe(i, 0.1)
    assert m.observe(6, 1.0)          # 10x slower -> straggler
    assert len(m.events) == 1
    assert not m.observe(7, 0.11)     # baseline not poisoned


# ------------------------------------------ test_integration's contracts

def test_loss_decreases(tmp_path):
    tr = _mk_trainer(str(tmp_path / "c"), ckpt_every=50)
    tr.run(24)
    losses = [m["loss"] for m in tr.metrics_log]
    # window means: single-step losses are noisy at this scale
    assert sum(losses[-6:]) / 6 < sum(losses[:6]) / 6


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_crash_restart_bitwise_identical(tmp_path, ckpt_async):
    """Interrupted-and-resumed run == uninterrupted run, bit for bit,
    through the sync and the async (delta-chained) manager."""
    kw = dict(ckpt_every=4, ckpt_async=ckpt_async,
              ckpt_delta_every=2 if ckpt_async else 0)
    sA = _mk_trainer(str(tmp_path / "a"), **kw).run(10)
    _mk_trainer(str(tmp_path / "b"), **kw).run(8)   # "crash" at 8
    tr = _mk_trainer(str(tmp_path / "b"), **kw)
    sB = tr.run(10)                                 # resume
    assert [m["step"] for m in tr.metrics_log] == [9, 10]
    _assert_bitwise(sB, sA)
    assert sB["params"]["embed"]["tok"] is tr.lm.embed.tok


def test_restore_skips_incomplete_context(tmp_path):
    tr = _mk_trainer(str(tmp_path / "c"), ckpt_every=3)
    tr.run(6)
    # corrupt: fake a partial (unfinalized) newer context
    ctx_dir = os.path.join(str(tmp_path / "c"), "ctx_00000099")
    os.makedirs(ctx_dir)
    tr2 = _mk_trainer(str(tmp_path / "c"), ckpt_every=3)
    state, start = tr2.init_or_restore()
    assert start == 6  # ignored the bogus context
    assert state["step"].device == CPU and int(state["step"]) == 6
    tr2.ckpt.close()


def _cli_env():
    return {"PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}


def test_supervisor_restarts_after_induced_crash(tmp_path):
    from repro_torch.train.supervisor import run_supervised
    ckpt = str(tmp_path / "sv")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--steps", "12", "--seq-len", "32",
           "--global-batch", "4", "--ckpt-every", "4",
           "--ckpt-dir", ckpt, "--device", "cpu"]
    # the induced crash models a ONE-OFF node failure: trigger only on the
    # first attempt; the restart resumes from the step-4 checkpoint
    rc, restarts = run_supervised(cmd, max_restarts=3, env=_cli_env(),
                                  env_first={"TRAIN_CRASH_AT": "6"})
    assert restarts >= 1
    assert rc == 0
    mgr = CheckpointManager(ckpt)
    try:
        assert mgr.latest_step() == 12
    finally:
        mgr.close()


def test_hdep_analysis_dump_flow(tmp_path):
    tr = _mk_trainer(str(tmp_path / "c"), ckpt_every=50,
                     hdep_dir=str(tmp_path / "hdep"), hdep_every=5)
    state = tr.run(5)
    from repro_torch.hercule import HerculeDB, api
    db = HerculeDB.open(str(tmp_path / "hdep"))
    try:
        assert db.contexts() == [5]
        out = api.read_object(db, 5, "analysis", 0)
    finally:
        db.close()
    assert out  # params dumped
    for v in out.values():
        assert np.isfinite(v).all()
    assert out["blocks.attn.wq"].tobytes() == \
        state["params"]["blocks"]["attn"]["wq"].detach().numpy().tobytes()


# ------------------------------------------------ against the reference

def _step0_context(root: str, cfg, seed: int):
    """The reference's initial state (numpy draws of its ParamSpecs,
    zero moments, step 0) saved by the reference as step 0."""
    params = spec_params(cfg, seed)
    state = {"params": params,
             "mu": jax.tree.map(np.zeros_like, params),
             "nu": jax.tree.map(np.zeros_like, params),
             "step": np.int32(0)}
    m = RefManager(root, async_write=False)
    m.save(0, jax.tree.map(jnp.asarray, state))
    m.close()


def test_trainer_matches_reference(tmp_path):
    """The port's Trainer and the reference's from one step-0 context,
    three steps at float32 compute: each step's loss within rtol 1e-5,
    the lr exactly, and the final parameters and moments within
    test_torch_train_step's grad bound: each leaf within 5e-3 of its own
    largest value plus 1e-4 of the largest over the tree.

    Three steps, because the trajectory is not fixed to 1e-5 for longer
    by its float32 inputs: step 1's grads differ from the reference's by
    sums in another order (about 3e-5 of each leaf's largest; one-ulp
    noise on the parameters moves the reference's own grads as much),
    and AdamW's first update g / (|g| + eps) turns a grad at that noise
    level into a step of +-lr: at this seed the fourth loss differs from
    the reference's by about the tolerance, as much as the reference's
    own fourth loss moves under one-ulp noise on its parameters."""
    cfg, ref_cfg = _cfgs("float32")
    _step0_context(str(tmp_path / "ref"), ref_cfg, seed=31)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref = _mk_ref_trainer(str(tmp_path / "ref"), ref_cfg, ckpt_every=50)
    want = ref.run(3)
    port = _mk_trainer(str(tmp_path / "port"), cfg, ckpt_every=50)
    got = port.run(3)
    assert [m["step"] for m in port.metrics_log] == [1, 2, 3]
    for g, w in zip(port.metrics_log, ref.metrics_log):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-7)
    got, want = _np_state(got), _np_state(want)
    assert sorted(got) == sorted(want)
    assert got["step"] == want["step"] == 3
    for part in ("params", "mu", "nu"):
        names = [k for k in want if k.startswith(part + ".")]
        top = max(np.abs(want[k]).max() for k in names)
        for k in names:
            err = np.abs(got[k] - want[k]).max()
            assert err <= 5e-3 * np.abs(want[k]).max() + 1e-4 * top, (k, err)


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_trainers_resume_each_others_checkpoints(tmp_path, direction):
    """One package's trainer runs 3 steps (the last one saved); the
    other's restores that step onto its device bitwise and trains on."""
    cfg, ref_cfg = _cfgs()
    root = str(tmp_path / "c")
    if direction == "ref_to_port":
        saved = _mk_ref_trainer(root, ref_cfg, ckpt_every=50).run(3)
        tr = _mk_trainer(root, cfg, ckpt_every=50)
        state, start = tr.init_or_restore()
        assert state["params"]["embed"]["tok"].device == CPU
    else:
        saved = _mk_trainer(root, cfg, ckpt_every=50).run(3)
        tr = _mk_ref_trainer(root, ref_cfg, ckpt_every=50)
        state, start = tr.init_or_restore()
    assert start == 3
    _assert_bitwise(state, saved)
    tr.ckpt.close()
    resumed = (_mk_trainer(root, cfg, ckpt_every=50)
               if direction == "ref_to_port"
               else _mk_ref_trainer(root, ref_cfg, ckpt_every=50))
    resumed.run(4)
    assert [m["step"] for m in resumed.metrics_log] == [4]


# ------------------------------------------- in-place updates after a cut

@dataclasses.dataclass
class _SlowNorm(TensorNormReducer):
    """TensorNormReducer that waits before reading its snapshot."""

    def reduce(self, snap, upstream):
        return _slow(super().reduce)(snap, upstream)


def _slow(fn):
    """``fn`` after a wait, so the next step's in-place update lands
    before it reads its snapshot."""
    def wrapped(*args, **kw):
        time.sleep(0.3)
        return fn(*args, **kw)
    return wrapped


@pytest.mark.parametrize("ckpt_async,device_reduce", [
    (False, False), (True, True)])
def test_cut_at_step_k_survives_in_place_step(tmp_path, monkeypatch,
                                              ckpt_async, device_reduce):
    """A save and a submit_state at step 2, then step 3 updates the same
    tensors in place while the checkpoint's writer (or gather) and the
    reducer still wait: the step-2 checkpoint restores, and the step-2
    reductions read, bitwise what a run that stopped at step 2 holds
    (the sync manager copies in save, the async one clones; the host and
    the device staging areas copy before push returns)."""
    from repro_torch.ckpt import AsyncCheckpointManager
    monkeypatch.setattr(CheckpointManager, "_write",
                        _slow(CheckpointManager._write))
    monkeypatch.setattr(AsyncCheckpointManager, "_gather_one",
                        _slow(AsyncCheckpointManager._gather_one))
    kw = dict(ckpt_every=2, ckpt_async=ckpt_async, insitu_every=2,
              insitu_reducers=[_SlowNorm()],
              insitu_device_reduce=device_reduce, insitu_policy="block")
    want = _mk_trainer(str(tmp_path / "w"),
                       insitu_dir=str(tmp_path / "wi"), **kw).run(2)
    _mk_trainer(str(tmp_path / "g"), insitu_dir=str(tmp_path / "gi"),
                **kw).run(3)
    tr = _mk_trainer(str(tmp_path / "g"), ckpt_async=ckpt_async)
    got, _ = tr.ckpt.restore(step_lib.abstract_state(tr.lm, CPU), step=2)
    tr.ckpt.close()
    _assert_bitwise(got, want)
    a, b = Catalog(str(tmp_path / "gi")), Catalog(str(tmp_path / "wi"))
    assert a.steps() == b.steps() == [2]
    ga, gb = a.query(2, "tnorm"), b.query(2, "tnorm")
    assert list(ga["names"]) == list(gb["names"])
    assert ga["stats"].tobytes() == gb["stats"].tobytes()


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_checkpoint_commits_after_the_insitu_steps_it_covers(
        tmp_path, monkeypatch, ckpt_async):
    """Each checkpoint's manifest commits only once the in-transit
    contexts of every step up to it are in the catalog (the reducer
    waits 0.3 s, a step takes milliseconds): a run that dies after
    checkpoint k and restarts from it leaves no hole in the catalog."""
    from repro_torch.hercule.database import ContextWriter, HerculeDB
    ins = str(tmp_path / "ins")
    seen = {}

    def record(db, step):
        if db.kind == "hprot":
            seen[step] = HerculeDB.open(ins).contexts()

    finalize, commit = ContextWriter.finalize, HerculeDB.commit_context

    def finalize_seen(self, *a, **kw):
        record(self.db, self.step)
        return finalize(self, *a, **kw)

    def commit_seen(self, step, *a, **kw):
        record(self, step)
        return commit(self, step, *a, **kw)

    monkeypatch.setattr(ContextWriter, "finalize", finalize_seen)
    monkeypatch.setattr(HerculeDB, "commit_context", commit_seen)
    _mk_trainer(str(tmp_path / "ck"), ckpt_every=2, ckpt_async=ckpt_async,
                insitu_dir=ins, insitu_every=2,
                insitu_reducers=[_SlowNorm()]).run(4)
    assert seen == {2: [2], 4: [2, 4]}


def test_train_cli_async_delta_insitu_ledger(tmp_path):
    """``launch.train --ckpt-async --ckpt-delta-every 2 --insitu-dir …
    --insitu-device-reduce --ledger --device cpu``: exit 0, the last
    step checkpointed, the in-transit catalog and the ledger read back
    with no device fallback."""
    from repro_torch.ckpt import AsyncCheckpointManager
    from repro_torch.obs import LedgerReader
    ck, ins = str(tmp_path / "ck"), str(tmp_path / "ins")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "8", "--seq-len", "32", "--global-batch",
         "4", "--ckpt-every", "2", "--ckpt-async", "--ckpt-delta-every",
         "2", "--ckpt-dir", ck, "--insitu-dir", ins, "--insitu-every", "2",
         "--insitu-device-reduce", "--ledger", "--device", "cpu"],
        env=_cli_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "run ledger:" in out.stdout
    mgr = AsyncCheckpointManager(ck)
    try:
        assert mgr.latest_step() == 8
    finally:
        mgr.close()
    cat = Catalog(ins)
    assert cat.steps() == [2, 4, 6, 8]
    assert set(cat.reducers(8)) == {"tnorm", "spectra-k8"}
    reader = LedgerReader(ins)
    try:
        flushes = reader.flushes()
        signals = [next(iter(f["parts"]["meta"].values()))["signals"]
                   for f in flushes]
    finally:
        reader.close()
    assert flushes and all(s.get("device_fallbacks") == 0.0
                           for s in signals), signals


def test_trainer_raises_without_device_match():
    """A CPU LM under a trainer told to run elsewhere raises; without
    a GPU the default device raises too (never a CPU fallback)."""
    lm = LM(get_smoke_config(ARCH), device=CPU)
    with pytest.raises((RuntimeError, ValueError)):
        Trainer(lm, device=None if not torch.cuda.is_available()
                else "cuda")


def test_insitu_device_mesh_count_shards_the_given_device(tmp_path):
    """``insitu_device_mesh=N`` with a ``device`` given means N shards
    on that device (``launch.train`` passes its ``--device`` and the
    count through unchanged); a list of devices is taken as it is."""
    for mesh, want in ((3, [CPU] * 3), ([CPU, CPU], [CPU] * 2)):
        tr = _mk_trainer(str(tmp_path / "ck"),
                         insitu_dir=str(tmp_path / f"ins{len(want)}"),
                         insitu_every=2, insitu_device_mesh=mesh)
        try:
            assert tr.insitu.device_reduce == "mesh"
            assert tr.insitu._device.devices == want
        finally:
            tr._close()


def test_train_cli_means_the_gpu(tmp_path):
    """Without ``--device`` the train CLI runs on cuda, so on a machine
    without a card it raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_crash_restart_bitwise_on_cuda(tmp_path, cuda_device):
    """The crash/restart contract on the card, with async delta saves
    and device-reduced in-transit reductions: bitwise."""
    kw = dict(ckpt_every=4, ckpt_async=True, ckpt_delta_every=2,
              insitu_every=2, insitu_device_reduce=True)
    sA = _mk_trainer(str(tmp_path / "a"), device=cuda_device,
                     insitu_dir=str(tmp_path / "ai"), **kw).run(10)
    _mk_trainer(str(tmp_path / "b"), device=cuda_device,
                insitu_dir=str(tmp_path / "bi"), **kw).run(8)
    tr = _mk_trainer(str(tmp_path / "b"), device=cuda_device,
                     insitu_dir=str(tmp_path / "bi2"), **kw)
    sB = tr.run(10)
    assert sB["params"]["embed"]["tok"].is_cuda
    _assert_bitwise(sB, sA)
