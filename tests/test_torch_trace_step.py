"""The training step's own tracing: ``Trainer._traced_step``'s spans,
``models.probe``'s stream times and MoE counters, ``train.syncs``' sync
counter, the profiler mirror of ``train.sync``, and portbench's readers of them.

On the CPU the host clock stands in for the CUDA events (ops are
synchronous there); the card's sync count has a ``gpu`` case."""
import dataclasses
import sys
import threading
import warnings
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import moe, probe
from repro_torch.models.transformer import LM, tree_leaves
from repro_torch.obs.attrib import Attributor, attribute
from repro_torch.obs.trace import TRACER
from repro_torch.train import syncs
from repro_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
DENSE, MOE = "stablelm_1_6b", "granite_moe_1b_a400m"
#: the regions every step of these families marks
KINDS = ["block.embed", "block.attention", "block.ffn", "block.head",
         "train.adamw"]


@pytest.fixture
def tracer():
    TRACER.clear()
    TRACER.enable()
    yield TRACER
    TRACER.disable()
    TRACER.clear()


def _trainer(path: Path, arch: str, device="cpu", engine=False, seq=32,
             trace_out=None, **overrides):
    cfg = dataclasses.replace(get_smoke_config(arch), **overrides)
    lm = LM(cfg, device=device)
    lm.init(torch.Generator(device=device).manual_seed(0))
    kw = dict(insitu_dir=str(path / "insitu"), insitu_every=1) \
        if engine else {}
    return Trainer(lm, ckpt_dir=str(path / "ckpt"), log_every=0,
                   data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq, global_batch=2),
                   device=device, insitu_trace_out=trace_out, **kw)


def _named(spans, name, step=None):
    return [sp for sp in spans if sp["name"] == name
            and (step is None or sp["args"].get("step") == step)]


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_span_tree_of_each_step(tmp_path, tracer, arch):
    tr = _trainer(tmp_path, arch, engine=True)
    tr.run(2)
    spans = tracer.spans()
    layers = tr.cfg.n_layers
    for n in (1, 2):
        (step,) = _named(spans, "train.step", n)
        end = step["ts"] + step["dur"]
        for child in ("train.dispatch", "train.sync"):
            (c,) = _named(spans, child, n)
            assert c["parent_id"] == step["span_id"]
            assert step["ts"] <= c["ts"] and c["ts"] + c["dur"] <= end
        (dispatch,) = _named(spans, "train.dispatch", n)
        total, first = 0.0, []
        for kind in KINDS:
            (b,) = _named(spans, kind, n)
            assert b["parent_id"] == step["span_id"]
            assert b["args"]["device_ms"] > 0
            assert b["args"]["calls"] == (
                layers if kind in ("block.attention", "block.ffn") else 1)
            assert b["dur"] == pytest.approx(b["args"]["device_ms"] * 1e3)
            total += b["args"]["device_ms"]
            first.append(b["ts"])
        # each region starts where the host first queued it, in the
        # order the step meets them, inside the dispatch
        assert first == sorted(first)
        assert dispatch["ts"] <= first[0] and \
            first[-1] <= dispatch["ts"] + dispatch["dur"]
        # the host clock's stamps all fall inside the dispatch
        assert total * 1e3 <= dispatch["dur"] + 1.0
        assert ("moe_assigned" in step["args"]) == (arch == MOE)
        # the engine's hand-off keeps its own trace, after the step
        (sub,) = _named(spans, "submit", n)
        assert sub["ts"] >= end and sub["trace_id"] != step["trace_id"]
    assert all("step" in sp["args"] for sp in spans
               if sp["cat"] == "train")
    # the ledger's attribution of the pipeline reads as without them
    got = {a["step"]: a for a in Attributor().ingest(spans)}
    for n in (1, 2):
        pipeline = [sp for sp in spans if sp["args"].get("step") == n
                    and sp["cat"] != "train"]
        assert got[n] == attribute(n, pipeline)


def _graph_names(root) -> set:
    seen, todo, names = set(), [root.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_tracing_off_adds_nothing_and_changes_no_bit(tmp_path, monkeypatch):
    """Off: no stamp, no marking node in the graph, no CUDA event and
    no sync debug mode. On or off, the same losses and parameters."""
    def refuse(*a, **k):
        raise AssertionError("touched with tracing off")
    graphs, stamps = [], []
    real_grad, real_stamp = torch.autograd.grad, probe.StepProbe._stamp

    def grad(outputs, *a, **k):
        graphs.append(_graph_names(outputs))
        return real_grad(outputs, *a, **k)

    def stamp(self, region):
        stamps.append(region)
        real_stamp(self, region)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    monkeypatch.setattr(probe.StepProbe, "_stamp", stamp)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", refuse)

    runs = {}
    for traced in (False, True):
        TRACER.clear()
        TRACER.enabled = traced
        try:
            tr = _trainer(tmp_path / str(traced), MOE, remat="full")
            state = tr.run(3)
        finally:
            TRACER.disable()
            TRACER.clear()
        marks = {n for g in graphs for n in g if n.startswith(("_Enter",
                                                               "_Exit"))}
        runs[traced] = ([m["loss"] for m in tr.metrics_log],
                        dict(tree_leaves(state["params"])), marks,
                        len(stamps))
        graphs.clear()
        stamps.clear()
    losses, params, marks, n_stamps = runs[False]
    assert not marks and n_stamps == 0
    t_losses, t_params, t_marks, t_stamps = runs[True]
    assert t_marks == {"_EnterBackward", "_ExitBackward"} and t_stamps
    assert t_losses == losses
    assert all(torch.equal(params[k], t_params[k]) for k in params)


def _plain_drops(probs, cfg):
    """Per group and expert, assignments past capacity from the router's
    probabilities: (assigned, dropped)."""
    g, tl, e = probs.shape
    k = cfg.top_k
    ids = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
    cap = moe.capacity(cfg, tl)
    dropped = 0
    for gi in range(g):
        counts = torch.bincount(ids[gi].reshape(-1), minlength=e)
        dropped += int(torch.clamp(counts - cap, min=0).sum())
    return g * tl * k, dropped


@pytest.mark.parametrize("nmb", [1, 2])
def test_moe_counters_are_the_routings_plain_count(tmp_path, tracer, nmb):
    """Every token routed to the same top k (a zero router): the step's
    counters equal a plain count of the routing, with remat full and
    off, summed over the microbatches, each forward counted once."""
    got = {}
    for remat in ("none", "full"):
        tr = _trainer(tmp_path / remat, MOE, seq=1024, remat=remat,
                      moe_groups=2, num_microbatches=nmb)
        init = tr.init_or_restore

        def zero_router():
            state, start = init()
            with torch.no_grad():
                state["params"]["blocks"]["moe"]["router"].zero_()
            return state, start
        tr.init_or_restore = zero_router
        calls = []

        def hook(p):
            if torch._C._current_graph_task_id() == -1:   # not recompute
                calls.append(p)
        handle = moe.register_router_hook(hook)
        try:
            tracer.clear()
            tr.run(1)
        finally:
            handle.remove()
        (step,) = _named(tracer.spans(), "train.step", 1)
        plain = [_plain_drops(p, tr.cfg) for p in calls]
        assert len(plain) == nmb * tr.cfg.n_layers
        expect = (sum(a for a, _ in plain), sum(d for _, d in plain))
        got[remat] = (step["args"]["moe_assigned"],
                      step["args"]["moe_dropped"])
        assert got[remat] == expect
        # the zero router sends each group's tokens to experts 0..k-1
        g = moe.groups(tr.cfg, 2048 // nmb)
        tl, k = 2048 // nmb // g, tr.cfg.top_k
        drop = k * max(0, tl - moe.capacity(tr.cfg, tl))
        assert expect == (2048 * k * tr.cfg.n_layers,
                          drop * g * nmb * tr.cfg.n_layers)
        assert expect[1] > 0
    assert got["none"] == got["full"]


@pytest.mark.parametrize("remat,nmb", [("full", 1), ("none", 2)])
def test_attention_counters_count_each_forward_call(tmp_path, tracer, remat,
                                                    nmb):
    """``attn_calls`` is every attention call of the step's forward (a
    layer a microbatch; remat's recompute is not counted again), and on
    the CPU ``attn_kernel`` is 0: the plain loop takes them all."""
    tr = _trainer(tmp_path, DENSE, remat=remat, num_microbatches=nmb)
    tr.run(2)
    for n in (1, 2):
        (step,) = _named(tracer.spans(), "train.step", n)
        assert step["args"]["attn_calls"] == tr.cfg.n_layers * nmb
        assert step["args"]["attn_kernel"] == 0


def test_sync_span_is_mirrored_on_the_profilers_clock(tmp_path, tracer):
    from torch.profiler import ProfilerActivity, profile
    tr = _trainer(tmp_path, DENSE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run(2)
    events = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("train."))
    names = {n for _, _, n in events}
    # only the waiting span is mirrored: the forward keeps its aten names
    assert names == {"train.sync"}
    spans = _named(tracer.spans(), "train.sync")
    assert len(events) == len(spans) == 2
    for (s, t, _), sp in zip(events, sorted(spans, key=lambda x: x["ts"])):
        assert abs(s - sp["ts"]) < 1000.0
        assert abs(t - (sp["ts"] + sp["dur"])) < 1000.0


def test_sync_counter_counts_every_sync_of_the_step(monkeypatch):
    """Each warning of the sync debug mode counts, from one call site
    too: this thread's and the autograd engine's (a thread inside a
    graph task), not another thread's; none is shown; other warnings
    pass."""
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(syncs, "in_backward",
                        lambda: threading.current_thread().name == "engine")

    def sync():
        warnings.warn(syncs.SYNC_WARNING, UserWarning)
    counter = syncs.SyncCounter()
    with pytest.warns(UserWarning, match="other") as shown:
        hook = warnings.showwarning
        try:
            for _ in range(2):      # two steps, one install
                with counter.counting():
                    installed = warnings.showwarning, warnings.filters
                    for _ in range(3):
                        sync()
                    for name in ("engine", "lane"):
                        t = threading.Thread(target=sync, name=name)
                        t.start()
                        t.join(timeout=10)
                        assert not t.is_alive()
                    warnings.warn("other", UserWarning)
                assert counter.count == 4
                assert (warnings.showwarning, warnings.filters) == installed
        finally:
            counter.uninstall()
        assert warnings.showwarning is hook
    assert modes == ["warn", 0] * 2
    assert [str(w.message) for w in shown] == ["other"] * 2


def test_trace_out_without_an_engine(tmp_path):
    import json
    out = tmp_path / "trace.json"
    try:
        tr = _trainer(tmp_path, DENSE, trace_out=str(out))
        assert TRACER.enabled
        tr.run(2)
    finally:
        TRACER.disable()
        TRACER.clear()
    names = [e["name"] for e in json.loads(out.read_text())["traceEvents"]]
    assert names.count("train.step") == 2 and "block.attention" in names


READERS = {
    "train.dispatch_ms": 15.0, "train.sync_ms": 30.0,
    "block.embed_ms": 1.5, "block.attention_ms": 3.0, "block.ffn_ms": 4.5,
    "block.head_ms": 6.0, "train.adamw_ms": 7.5, "train.host_syncs": 9.0,
    "moe.drop_share": 100.0 * 30 / 400,
    "attn.kernel_share": 100.0 * 36 / 48,
}


def _ctx():
    spans = []
    for n, f in ((2, 1.0), (4, 2.0)):
        spans += [
            {"name": "train.step", "args": {"step": n, "host_syncs": 6 * f,
                                            "moe_assigned": 200,
                                            "moe_dropped": 10 * f,
                                            "attn_calls": 24,
                                            "attn_kernel": 12 * f},
             "dur": 50e3 * f},
            {"name": "train.dispatch", "args": {"step": n}, "dur": 10e3 * f},
            {"name": "train.sync", "args": {"step": n}, "dur": 20e3 * f},
            {"name": "submit", "args": {"step": n}, "dur": 5e3}]
        spans += [{"name": k, "args": {"step": n, "device_ms": v * f,
                                       "calls": 1}, "dur": v * f * 1e3}
                  for k, v in (("block.embed", 1.0), ("block.attention", 2.0),
                               ("block.ffn", 3.0), ("block.head", 4.0),
                               ("train.adamw", 5.0))]
    return {"spans": spans}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_of_each_new_metric(name):
    from portbench import harness
    reader = harness.load_module(ROOT / "portbench" / "metrics" /
                                 f"{name}.py")
    assert reader.read({}) is None
    assert reader.read(_ctx()) == pytest.approx(READERS[name])


class _SyncInBackward(torch.autograd.Function):
    """Identity whose Python backward syncs (on the engine's thread)."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g.sum().item()
        return g


@pytest.mark.gpu
def test_backward_syncs_are_counted_on_the_card():
    """A C++ backward's sync (a boolean mask's ``IndexBackward0`` makes
    ``nonzero``), replayed on this thread, and a Python backward's, made
    on the engine's device thread: two."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(8, device="cuda", requires_grad=True)
    mask = torch.arange(8, device="cuda") % 2 == 0
    y = _SyncInBackward.apply(x[mask]).sum()
    counter = syncs.SyncCounter()
    try:
        with counter.counting():
            torch.autograd.grad(y, x)
    finally:
        counter.uninstall()
    assert counter.count == 2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_host_syncs_on_the_card(tmp_path, tracer, arch):
    """The batch's two uploads and the four ``float()``s at least, on
    the training thread; the backward's syncs are replayed there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tr = _trainer(tmp_path, arch, device=torch.device("cuda", 0))
    tr.run(2)
    for n in (1, 2):
        (step,) = _named(tracer.spans(), "train.step", n)
        assert step["args"]["host_syncs"] >= 6
        assert sum(b["args"]["device_ms"] for k in KINDS
                   for b in _named(tracer.spans(), k, n)) > 0
    assert torch.cuda.get_sync_debug_mode() == 0
