"""Runs of the harness on the CPU at a small size: the plain reference
against the port, the result line, the faults and the control.

The card-only step (the harness's refusal without a card) is skipped
by calling ``harness.run_cell`` with a CPU device; everything after it
runs as on the card."""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import pytest
import torch
from conftest import ROOT

from portbench import calibrate, harness, yardstick

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CPU = torch.device("cpu")


def _job(root, workload, seed):
    return harness.make_job(root, harness.load_json(root / "BENCHMARK.json"),
                            workload, seed, 0.0, False, CPU)[0]


@pytest.mark.parametrize("workload,seq", [(CELLS[0], 32), (CELLS[1], 32),
                                          (CELLS[1], 1024)])
def test_reference_is_the_ports_mathematics(small, workload, seq):
    """One train step of the port at float32 compute against the plain
    reference: loss, every leaf's gradient, and AdamW's first update.
    At 1,024 x 2 tokens the MoE dispatches in 2 groups (2,048 tokens)."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import LM, tree_leaves
    from repro_torch.train import optim, step
    job = _job(small, workload, 11)
    m = dict(job.model, compute_dtype="float32")
    o = job.traffic["optimizer"]
    ref = job.reference
    stream = yardstick.TokenStream(m["vocab_size"], seq, 2, 11, 1.1)
    b = stream.batch(0)
    tokens, labels = (torch.from_numpy(b[k]) for k in ("tokens", "labels"))

    lm = LM(ModelConfig(**m), device="cpu")
    lm.load_param_tree(ref.nest(ref.make_params(m, 11, CPU)))
    metrics, grads = step.loss_and_grads(lm, lm.param_tree(),
                                         {"tokens": tokens,
                                          "labels": labels})
    leaves = {k: v.requires_grad_(True)
              for k, v in ref.make_params(m, 11, CPU).items()}
    nll, aux = ref.loss(leaves, tokens, labels, m)
    g_ref = dict(zip(leaves, torch.autograd.grad(nll + 0.01 * aux,
                                                 list(leaves.values()))))
    # float32 sums in another order: a few ulps of a loss near 5.5
    assert float(metrics["loss"]) == pytest.approx(float(nll), rel=2e-6)
    flat = dict(tree_leaves(grads))
    assert flat.keys() == g_ref.keys()
    for k, g in g_ref.items():
        # each leaf to float32 roundoff of its largest entry
        scale = float(g.abs().max())
        assert float((flat[k] - g).abs().max()) <= 1e-4 * scale, k

    state = {"params": lm.param_tree(),
             **optim.init_opt_state(lm.param_tree())}
    opt = optim.OptConfig(**o)
    optim.adamw_step(state["params"], grads, state, opt)
    r = ref.train(m, o, ref.make_params(m, 11, CPU), [(tokens, labels)])
    p0 = ref.make_params(m, 11, CPU)
    mus = dict(tree_leaves(state["mu"]))
    for k, x in tree_leaves(state["params"]):
        # Adam's first step is +-lr an entry whatever the gradient's size,
        # so a norm of the change holds where entries could flip sign
        change = float((x.detach() - p0[k]).double().norm())
        assert change == pytest.approx(r["change_norm"][k], rel=1e-4), k
        mu = float(mus[k].double().norm()) / (1 - o["b1"])
        assert mu == pytest.approx(r["grad_norm"][k], rel=1e-5), k


def test_result_line_has_the_required_keys(small):
    out = harness.run_cell(small, CELLS[0], 2 ** 31 + 5, 3.0, False, CPU,
                           0.0)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    traced = harness.run_cell(small, CELLS[0], 2 ** 31 + 5, 3.0, True, CPU,
                              0.0)
    assert list(traced)[-1] == "checks"
    assert set(traced) <= {"correct", "attempted", "failed", "metrics",
                           "device", "breakdown", "checks"}
    assert "insitu.submit_ms" in traced["metrics"]


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.main(["--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1"])
    assert rc != 0 and buf.getvalue() == ""


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small, workload):
    out = harness.run_cell(small, workload, 987654321, 0.3, False, CPU, 0.0)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", calibrate.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_each_fault_makes_the_run_incorrect(small, workload, fault):
    with calibrate.plant(fault, _job(small, workload, 987654321)):
        out = harness.run_cell(small, workload, 987654321, 0.3, False, CPU,
                               0.0)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(small, workload, seed):
    """The reference in float8 in the program's place, under the whole
    run, makes the harness's own ``correct`` false (the same readings on
    the chip at the cells' sizes are in PERF.md)."""
    with calibrate.plant("control", _job(small, workload, seed)):
        out = harness.run_cell(small, workload, seed, 0.0, False, CPU, 0.0)
    assert not out["correct"], out["checks"]
    assert all(isinstance(c["value"], float) for c in out["checks"].values())


def test_readings_go_through_the_harness(small):
    got = []
    summary = calibrate.readings(small, CELLS[0], CPU, seeds=[4],
                                 control_seeds=[5], fault_seeds=[6],
                                 emit=got.append, faults=["half_batch"])
    assert [(g["kind"], g["correct"]) for g in got] == [
        ("program", True), ("control", False), ("half_batch", False)]
    assert summary["program"]["correct_runs"] == 1
    assert summary["control"]["correct_runs"] == 0


def test_fault_is_removed_after_the_block(small):
    from repro_torch.train import optim, step
    real, real_step = optim.adamw_step, step.loss_and_grads
    job = _job(small, CELLS[0], 1)
    with calibrate.plant("state_unchanged", job):
        assert optim.adamw_step is not real
    with calibrate.plant("control", job):
        assert step.loss_and_grads is not real_step
    assert optim.adamw_step is real and step.loss_and_grads is real_step


def test_configs_build_the_ports_model_config():
    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig
    for c in BENCH["configs"]:
        model = json.loads((ROOT / c["file"]).read_text())["model"]
        port = get_config(model["name"].replace("-", "_").replace(".", "_"))
        assert dataclasses.asdict(ModelConfig(**model)) == \
            dataclasses.asdict(port)


def test_trace_readings_from_profiler_events():
    """Busy time is the union of the device's intervals in the window;
    the window's own range on the device's track is not device work;
    an idle gap goes to the outermost host op over it."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    runner = harness.load_module(ROOT / "portbench/runners/train.py")

    def ev(name, s, t, dev=DeviceType.CPU, thread=1, note=False):
        return SimpleNamespace(
            name=lambda: name, start_ns=lambda: int(s * 1e3),
            end_ns=lambda: int(t * 1e3), device_type=lambda: dev,
            start_thread_id=lambda: thread, is_user_annotation=lambda: note)
    events = [ev("portbench.window", 0, 100, note=True),
              ev("portbench.window", 0, 100, DeviceType.CUDA, note=True),
              ev("gemm", 10, 40, DeviceType.CUDA),
              ev("add", 30, 50, DeviceType.CUDA),
              ev("gemm", 70, 90, DeviceType.CUDA),
              ev("aten::item", 50, 69),
              ev("aten::mm", 0, 9), ev("child", 1, 8.5),
              ev("lane", 60, 61, thread=2)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    got = runner._trace_readings(prof)
    assert got["busy_s"] == pytest.approx(60e-6)
    assert got["trace_window_s"] == pytest.approx(100e-6)
    assert got["device_ops"] == [["gemm", pytest.approx(50e-6)],
                                 ["add", pytest.approx(20e-6)]]
    assert dict(got["idle_gaps"]) == {
        "aten::item": pytest.approx(20e-6), "aten::mm": pytest.approx(10e-6),
        "python": pytest.approx(10e-6)}
    assert yardstick.outermost([(0, 9, "a", 1), (1, 2, "b", 1),
                                (3, 4, "c", 2), (9, 10, "d", 1)]) == [
        (0, 9, "a", 1), (9, 10, "d", 1), (3, 4, "c", 2)]
