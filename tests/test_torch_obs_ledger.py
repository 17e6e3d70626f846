"""The port's run ledger: flight recorder, attribution, health.

``repro_torch.obs.{events,trace,attrib,health,ledger,httpd}`` and
``launch/obs.py``: the bounded event ring (capacity, exactly-once
drains, dump hooks), the tracer's bounded span window, critical-path
attribution over unions of overlapping stage intervals (incl. partial
steps), the declarative health rules (parse, burn windows,
edge-triggered alerts, verdict), the RunLedger <-> LedgerReader
roundtrip through a real ``telemetry/`` Hercule database (writer slots,
foreign lane domains, crash-dump flushes, seq resume), the engine's
ledger hooks on the mesh path (two CPU shards) and on the device path
(``device_fallbacks``), a SIGKILLed process lane's postmortem, the
``/metrics`` endpoint, the ``launch/obs`` CLI, the insitu CLI's
``--serve-check --ledger``, and each package's ``LedgerReader`` on the
other's ``telemetry/`` database. Every assertion reads this package's
own TRACER/EVENTS; the reference's rings are only touched to write a
reference ledger.
"""
import contextlib
import io
import json
import os
import re
import signal
import time
import urllib.error
import urllib.request

import pytest
import torch

import repro.obs as ref_obs
import repro_torch.obs as pt_obs
from repro.launch import obs as ref_obs_cli
from repro_torch.hercule import api
from repro_torch.hercule.database import DomainWriter, HerculeDB
from repro_torch.insitu import (InTransitEngine, LevelHistogramReducer,
                                SliceReducer)
from repro_torch.launch import insitu as insitu_cli
from repro_torch.launch import obs as obs_cli
from repro_torch.obs import TRACER, metrics, serve_metrics
from repro_torch.obs import events as obs_events
from repro_torch.obs.attrib import Attributor, attribute, union_seconds
from repro_torch.obs.events import EventRing
from repro_torch.obs.health import HealthEngine, Rule, default_rules
from repro_torch.obs.ledger import (SEQ_STRIDE, LedgerReader, RunLedger,
                                    lane_domain, ledger_dir)
from repro_torch.obs.trace import Tracer
from repro_torch.sim import amrgen, fields


@pytest.fixture(autouse=True)
def _clean_obs():
    """Each test starts with empty global rings and leaves them empty
    (the ledger drains the process-global TRACER/EVENTS)."""
    obs_events.EVENTS.clear()
    TRACER.clear()
    prev = TRACER.enabled
    yield
    TRACER.enabled = prev
    TRACER.clear()
    obs_events.EVENTS.clear()
    metrics.set_enabled(True)


@pytest.fixture(scope="module")
def sedov_tree():
    t = amrgen.generate_tree(fields.sedov(), min_level=2, max_level=4,
                             threshold=1.2)
    t.validate()
    return t


def _reducers():
    return [SliceReducer(field="density", axis=2, position=0.5,
                         resolution=32),
            LevelHistogramReducer(field="density", bins=16, lo=0.0,
                                  hi=8.0)]


def _span(name, step, t0, t1, cat="insitu", **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": float(t0),
            "dur": float(t1 - t0), "pid": os.getpid(), "tid": 1,
            "trace_id": "t", "span_id": f"{name}-{step}-{t0}",
            "parent_id": None, "args": {"step": step, **args}}


# ------------------------------------------------------------ event ring

def test_event_ring_bounded_and_drained_exactly_once():
    ring = EventRing(capacity=8)
    for i in range(20):
        ring.emit(obs_events.STEP_BEGIN, step=i)
    assert ring.count == 20
    assert ring.dropped == 12
    mark, evs = ring.drain_since(0)
    assert [e["fields"]["step"] for e in evs] == list(range(12, 20))
    # nothing new: the same mark drains nothing
    mark2, evs2 = ring.drain_since(mark)
    assert (mark2, evs2) == (mark, [])
    ring.emit(obs_events.STEP_COMMIT, step=20)
    _, evs3 = ring.drain_since(mark2)
    assert [e["type"] for e in evs3] == [obs_events.STEP_COMMIT]
    # foreign events keep their identity but get local arrival order
    foreign = {"ts_us": 1.0, "type": obs_events.LANE_ERROR,
               "pid": 99999, "seq": 3, "fields": {"group": 1}}
    mark4, _ = ring.drain_since(0)
    ring.ingest([foreign])
    _, evs4 = ring.drain_since(mark4)
    assert evs4 == [foreign]


def test_event_ring_taxonomy_and_kill_switch():
    ring = EventRing()
    with pytest.raises(ValueError, match="unknown event type"):
        ring.emit("made.up", step=1)
    metrics.set_enabled(False)
    try:
        assert ring.emit(obs_events.STEP_BEGIN, step=1) is None
        assert ring.count == 0
    finally:
        metrics.set_enabled(True)
    assert ring.emit(obs_events.STEP_BEGIN, step=1) is not None


def test_event_ring_dump_hooks_never_raise():
    ring = EventRing()
    calls = []

    def good(reason, r):
        calls.append((reason, len(r.snapshot())))

    def broken(reason, r):
        raise RuntimeError("sink down")

    ring.register_dump_hook(good)
    ring.register_dump_hook(broken)
    ring.emit(obs_events.LANE_ERROR, group=0, stage="reduce")
    errors = ring.dump("unit.test", group=0)
    assert len(errors) == 1 and "sink down" in str(errors[0])
    # the dump marker itself is in the ring the hook saw
    assert calls == [("unit.test", 2)]
    types = [e["type"] for e in ring.snapshot()]
    assert obs_events.CRASH_DUMP in types
    ring.unregister_dump_hook(broken)
    ring.unregister_dump_hook(good)
    assert ring.dump("again") == []


# --------------------------------------------------------------- tracer

def test_tracer_bounded_window_counts_drops():
    t = Tracer(enabled=True, max_spans=16)
    for i in range(40):
        with t.span("submit", args={"step": i}):
            pass
    assert t.spans_dropped == 24
    assert len(t.spans()) == 16
    mark, spans = t.drain_since(0)
    assert [s["args"]["step"] for s in spans] == list(range(24, 40))
    _, again = t.drain_since(mark)
    assert again == []
    with t.span("submit", args={"step": 40}):
        pass
    _, fresh = t.drain_since(mark)
    assert [s["args"]["step"] for s in fresh] == [40]


# ---------------------------------------------------------- attribution

def test_union_seconds_merges_overlaps():
    assert union_seconds([]) == 0.0
    # [0,10] + [5,15] + [20,30] us -> 25 us of coverage
    got = union_seconds([(0.0, 10.0), (5.0, 15.0), (20.0, 30.0)])
    assert got == pytest.approx(25e-6)


def test_attribute_parallel_lanes_count_once():
    # two lanes reduce concurrently: 2x CPU, 1x wall
    spans = [_span("submit", 1, 0, 100),
             _span("reduce", 1, 100, 900, group=0),
             _span("reduce", 1, 150, 900, group=1),
             _span("manifest.commit", 1, 900, 1000)]
    a = attribute(1, spans)
    assert a["step"] == 1 and not a["partial"]
    assert a["total_s"] == pytest.approx(1000e-6)
    assert a["stages"]["reduce"] == pytest.approx(800e-6)
    assert a["critical"] == "reduce"
    assert a["idle_s"] == pytest.approx(0.0, abs=1e-9)


def test_attributor_terminal_completion_and_partial_flush():
    at = Attributor()
    assert at.ingest([_span("submit", 1, 0, 50),
                      _span("submit", 2, 0, 50)]) == []
    assert at.pending_steps == [1, 2]
    done = at.ingest([_span("reduce", 1, 50, 90, group=0),
                      _span("manifest.commit", 1, 90, 100)])
    assert [a["step"] for a in done] == [1]
    assert not done[0]["partial"] and at.pending_steps == [2]
    pending = at.flush_pending()
    assert [(a["step"], a["partial"]) for a in pending] == [(2, True)]
    assert at.pending_steps == []


# --------------------------------------------------------------- health

def test_rule_parse_roundtrip_and_validation():
    r = Rule.parse("staging_pressure > 0.9 for 3/5 : crit")
    assert (r.signal, r.op, r.threshold) == ("staging_pressure", ">", 0.9)
    assert (r.window, r.need, r.severity) == (5, 3, "crit")
    assert Rule.parse("lane_crashes >= 1").window == 1
    with pytest.raises(ValueError, match="unparsable"):
        Rule.parse("pressure !! 3")
    with pytest.raises(ValueError, match="K must be <="):
        Rule.parse("x > 1 for 4/3")
    with pytest.raises(ValueError, match="severity"):
        Rule(signal="x", op=">", threshold=1, severity="meh")
    assert {r.severity for r in default_rules()} == {"warn", "crit"}


def test_health_burn_window_edge_triggered():
    eng = HealthEngine([Rule.parse("p > 0.5 for 2/3 : warn")])
    assert eng.observe({"p": 0.9}) == []        # window not full
    assert eng.observe({"p": 0.1}) == []
    fired = eng.observe({"p": 0.8})             # 2 of last 3 violate
    assert [a["rule"] for a in fired] == ["p>0.5"]
    assert eng.observe({"p": 0.8}) == []        # still burning: no re-fire
    eng.observe({"p": 0.1})
    eng.observe({"p": 0.1})                     # burn ends -> clear
    assert "cleared_sample" in eng.alerts[0]
    assert eng.state()["active"] == []
    assert eng.verdict() == "degraded"          # history keeps the warn


def test_health_verdict_severity_order():
    eng = HealthEngine([Rule.parse("crashes >= 1 : crit")])
    assert eng.verdict() == "healthy"
    assert eng.observe({"unrelated": 5.0}) == []     # absent signal: idle
    eng.observe({"crashes": 1.0})
    assert eng.verdict() == "critical"
    state = eng.state()
    assert state["verdict"] == "critical" and state["samples"] == 2


# ----------------------------------------------------- ledger roundtrip

def test_ledger_roundtrip_merges_domains_and_slots(tmp_path):
    root = str(tmp_path / "run")
    TRACER.enable()
    led = RunLedger(root, "trainer", interval=0)
    obs_events.EVENTS.emit(obs_events.STEP_BEGIN, step=1, parts=2)
    TRACER.ingest([_span("submit", 1, 0, 100),
                   _span("reduce", 1, 100, 900, group=0),
                   _span("manifest.commit", 1, 900, 1000)])
    obs_events.EVENTS.emit(obs_events.STEP_COMMIT, step=1, domains=[0])
    lane_ev = {"ts_us": 5.0, "type": obs_events.LANE_ERROR, "pid": 424242,
               "seq": 1, "fields": {"group": 2, "stage": "reduce"}}
    led.ingest_domain(lane_domain(2), {"events": [lane_ev]})
    step0 = led.flush()
    assert step0 == 0 * SEQ_STRIDE + 0
    step1 = led.flush()                 # nothing new: still commits meta
    assert step1 == 1 * SEQ_STRIDE + 0
    # a second writer slot in the same run (the catalog server's)
    srv = RunLedger(root, "server", interval=0)
    assert srv.flush() % SEQ_STRIDE == 1
    srv.close()
    led.close()

    reader = LedgerReader(root)
    try:
        flushes = reader.flushes()
        assert {f["proc"] for f in flushes} == {"trainer", "server"}
        # exactly-once: the step events appear once despite 3+ flushes
        events = reader.events(flushes)
        begin = [e for e in events if e["type"] == obs_events.STEP_BEGIN]
        assert len(begin) == 1 and begin[0]["fields"]["step"] == 1
        assert lane_ev in events        # foreign lane domain merged in
        assert sum(1 for e in events
                   if e["type"] == obs_events.RUN_END) == 2
        attribs = reader.attribs(flushes)
        assert attribs[1]["critical"] == "reduce"
        assert not attribs[1]["partial"]
        assert reader.verdict(flushes) == "healthy"
        out = str(tmp_path / "trace.json")
        n = reader.export_perfetto(out)
        assert n == 3
        doc = json.load(open(out))
        assert [e["ph"] for e in doc["traceEvents"]] == ["X"] * 3
        assert doc["traceEvents"][0]["args"]["step"] == 1
    finally:
        reader.close()


def test_ledger_reader_requires_a_ledger(tmp_path):
    with pytest.raises(FileNotFoundError, match="no run ledger"):
        LedgerReader(str(tmp_path / "nope"))
    assert ledger_dir("/a/run") == "/a/run/telemetry"
    assert ledger_dir("/a/run/telemetry") == "/a/run/telemetry"


def test_ledger_seq_resumes_after_restart(tmp_path):
    root = str(tmp_path / "run")
    led = RunLedger(root, "trainer", interval=0)
    led.flush()
    led.close()                                     # + final flush
    led2 = RunLedger(root, "trainer", interval=0)   # simulated restart
    step = led2.flush()
    led2.close()
    assert step == 2 * SEQ_STRIDE                   # continues, no clobber
    reader = LedgerReader(root)
    try:
        assert [f["seq"] for f in reader.flushes()] == [0, 1, 2, 3]
    finally:
        reader.close()


def test_ledger_dump_flush_carries_partial_attribution(tmp_path):
    root = str(tmp_path / "run")
    TRACER.enable()
    led = RunLedger(root, "trainer", interval=0)
    TRACER.ingest([_span("submit", 7, 0, 100),
                   _span("stage.push", 7, 100, 300, domain=0)])
    obs_events.EVENTS.dump("unit.crash", group=0)   # hook -> flush(dump)
    assert led.flushes == 1
    # the step later completes: the complete record must win on read
    TRACER.ingest([_span("submit", 7, 0, 100),
                   _span("reduce", 7, 300, 900, group=0),
                   _span("manifest.commit", 7, 900, 1000)])
    led.flush()
    # ...and a *later* partial (e.g. relayed by a lane) must not clobber
    led.ingest_domain(lane_domain(0), {"attrib": {
        "7": attribute(7, [_span("submit", 7, 0, 50)], partial=True)}})
    led.close()
    reader = LedgerReader(root)
    try:
        a = reader.attribs()[7]
        assert not a["partial"]
        assert a["critical"] == "reduce"
        dumps = reader.crash_dumps()
        assert any(e["fields"].get("reason") == "unit.crash"
                   for e in dumps)
    finally:
        reader.close()


def test_ledger_signals_feed_health_and_alert_lands_in_flush(tmp_path):
    led = RunLedger(str(tmp_path / "run"), "trainer", interval=0,
                    rules=[Rule.parse("pressure > 0.9 : warn")])
    led.add_signal("pressure", lambda: 0.97)
    led.add_signal("broken", lambda: 1 / 0)         # must not crash flush
    led.flush()
    led.close()
    reader = LedgerReader(str(tmp_path / "run"))
    try:
        alerts = reader.alerts()
        assert len(alerts) == 1
        assert alerts[0]["fields"]["signal"] == "pressure"
        assert alerts[0]["fields"]["value"] == pytest.approx(0.97)
        assert reader.verdict() == "degraded"
        meta = next(iter(
            reader.flushes()[0]["parts"]["meta"].values()))
        assert meta["signals"]["pressure"] == pytest.approx(0.97)
        assert "broken" not in meta["signals"]
    finally:
        reader.close()


# ----------------------------------------------- telemetry Hercule kind

def test_telemetry_kind_concatenates_span_domains(tmp_path):
    db = HerculeDB.create(str(tmp_path / "db"), kind="hdep", ncf=1)
    kind = api.KINDS["telemetry"]
    w = DomainWriter(db, 0)
    kind.write(w, 0, {"spans": [_span("submit", 1, 200, 300)],
                      "meta": {"proc": "trainer"}})
    kind.write(w, 8, {"spans": [_span("reduce", 1, 100, 150)]})
    db.commit_context(0, w.records)
    parts = kind.assemble(db.view(0))
    # span streams concatenate across domains, time-ordered
    assert [s["name"] for s in parts["spans"]] == ["reduce", "submit"]
    assert [s["ts"] for s in parts["spans"]] == [100.0, 200.0]
    # keyed parts stay per-domain
    assert parts["meta"][0]["proc"] == "trainer"
    db.close()


# ------------------------------------------------ engine mesh telemetry

def test_engine_mesh_telemetry_includes_ledger_and_trace(tmp_path,
                                                         sedov_tree):
    TRACER.enable()
    led = RunLedger(str(tmp_path / "run"), "trainer", interval=0)
    eng = InTransitEngine(str(tmp_path / "run"), _reducers(),
                          device_reduce="mesh",
                          mesh_devices=[torch.device("cpu")] * 2,
                          policy="block", ledger=led).start()
    assert eng.submit(0, sedov_tree)
    eng.drain()
    led.flush()
    tel = eng.telemetry()
    assert tel["device"]["mesh_devices"] >= 1
    assert tel["trace"]["max_spans"] == TRACER.max_spans
    assert tel["trace"]["spans_dropped"] == 0
    assert tel["ledger"]["proc"] == "trainer"
    assert tel["ledger"]["flushes"] >= 1
    assert tel["ledger"]["verdict"] == "healthy"
    assert tel["ledger"]["steps_attributed"] >= 1
    eng.close()
    led.close()
    reader = LedgerReader(str(tmp_path / "run"))
    try:
        assert 0 in reader.attribs()
        types = {e["type"] for e in reader.events()}
        assert {obs_events.STEP_BEGIN, obs_events.STEP_COMMIT} <= types
    finally:
        reader.close()


# -------------------------------------------- SIGKILL acceptance path

def test_killed_lane_leaves_readable_ledger(tmp_path, sedov_tree):
    """A SIGKILLed process lane must leave a postmortem on disk: the
    lane-crash event, a crash-dump flush, partial attribution for the
    step it stranded, and a critical verdict."""
    root = str(tmp_path / "run")
    TRACER.enable()
    led = RunLedger(root, "trainer", interval=0)
    eng = InTransitEngine(root, _reducers(), domains=2,
                          backend="process", ledger=led).start()
    assert eng.submit(1, sedov_tree)
    eng.drain()
    # step 2 only ever gets its domain-1 part: it can never commit, so
    # its attribution is guaranteed partial regardless of kill timing
    assert eng.submit_part(2, 1, sedov_tree)
    victim = eng._backend._procs[0]
    os.kill(victim.pid, signal.SIGKILL)
    victim.join(timeout=30)
    deadline = time.monotonic() + 30
    while not eng._errors and time.monotonic() < deadline:
        time.sleep(0.05)
    assert eng._errors, "collector never noticed the dead lane"
    with pytest.raises(RuntimeError, match="in-transit reduction failed"):
        eng.close()
    led.close()

    reader = LedgerReader(root)
    try:
        events = reader.events()
        crashes = [e for e in events
                   if e["type"] == obs_events.LANE_CRASH]
        assert crashes and crashes[0]["fields"]["group"] == 0
        assert crashes[0]["fields"]["exitcode"] == -signal.SIGKILL
        assert any(e["type"] == obs_events.CRASH_DUMP for e in events)
        attribs = reader.attribs()
        assert 1 in attribs and not attribs[1]["partial"]
        assert attribs[2]["partial"]
        assert "submit" in attribs[2]["stages"]
        assert reader.verdict() == "critical"
        # the crash registered as a health signal, not just an event
        flushes = reader.flushes()
        last_meta = next(iter(flushes[-1]["parts"]["meta"].values()))
        assert last_meta["signals"]["lane_crashes"] >= 1
    finally:
        reader.close()


def test_lane_events_relay_into_their_ledger_domain(tmp_path):
    """A process lane's event drain lands in its own ledger domain
    (``8 + group``) when a ledger is bound, else in the engine ring."""
    from types import SimpleNamespace

    from repro_torch.insitu.lanes import ProcessLaneBackend
    ev = {"ts_us": 5.0, "type": obs_events.LANE_ERROR, "pid": 4242,
          "seq": 1, "fields": {"group": 3, "stage": "reduce"}}
    led = RunLedger(str(tmp_path / "run"), "trainer", interval=0)
    backend = SimpleNamespace(engine=SimpleNamespace(ledger=led))
    ProcessLaneBackend._relay_events(backend, 3, [ev])
    assert obs_events.EVENTS.snapshot() == []
    step = led.flush()
    led.close()
    db = HerculeDB.open(ledger_dir(str(tmp_path / "run")))
    try:
        kind = api.KINDS["telemetry"]
        assert kind.assemble(db.view(step),
                             domain=lane_domain(3))["events"] == [ev]
        assert ev not in kind.assemble(db.view(step), domain=0)["events"]
    finally:
        db.close()
    backend.engine.ledger = None
    ProcessLaneBackend._relay_events(backend, 3, [ev])
    assert obs_events.EVENTS.snapshot()[-1] == ev


# ------------------------------------------------------ /metrics httpd

def test_serve_metrics_endpoint():
    reg = metrics.MetricsRegistry()
    c = reg.counter("ledger_test_scrapes_total", "unit test counter")
    c.inc(3)
    srv = serve_metrics(0, registry=reg)
    try:
        assert srv.port > 0
        body = urllib.request.urlopen(srv.url, timeout=10).read().decode()
        assert "ledger_test_scrapes_total 3" in body
        base = srv.url.rsplit("/", 1)[0]
        snap = json.loads(urllib.request.urlopen(
            base + "/snapshot", timeout=10).read())
        assert snap["ledger_test_scrapes_total"]["samples"][0]["value"] == 3
        ok = urllib.request.urlopen(base + "/healthz", timeout=10)
        assert ok.status == 200
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        srv.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(srv.url, timeout=2)


# ---------------------------------------------------------- launch CLI

def _mini_ledger(root):
    TRACER.enable()
    led = RunLedger(root, "trainer", interval=0)
    TRACER.ingest([_span("submit", 1, 0, 100),
                   _span("reduce", 1, 100, 900, group=0),
                   _span("manifest.commit", 1, 900, 1000)])
    obs_events.EVENTS.emit(obs_events.STEP_COMMIT, step=1, domains=[0])
    led.flush()
    led.close()


def test_obs_cli_report_tail_export(tmp_path, capsys):
    root = str(tmp_path / "run")
    _mini_ledger(root)
    assert obs_cli.main(["report", root]) == 0
    out = capsys.readouterr().out
    assert "verdict: HEALTHY" in out
    assert "critical=reduce" in out
    assert obs_cli.main(["tail", root, "--once"]) == 0
    assert "step.commit" in capsys.readouterr().out
    trace = str(tmp_path / "t.json")
    dump = str(tmp_path / "d.json")
    assert obs_cli.main(["export", root, "--perfetto", trace,
                         "--json", dump]) == 0
    assert len(json.load(open(trace))["traceEvents"]) == 3
    doc = json.load(open(dump))
    assert doc["verdict"] == "healthy" and doc["attribs"]["1"]
    assert obs_cli.main(["export", root]) == 2


def test_obs_cli_empty_ledger_reports_cleanly(tmp_path):
    root = str(tmp_path / "run")
    # a ledger database that exists but has no committed flush yet
    HerculeDB.create(ledger_dir(root), kind="hdep", ncf=1,
                     io_threads=1).close()
    assert obs_cli.main(["report", root]) == 1


# ------------------------------------------------ device path and CLI

def test_engine_device_path_ledger_signals(tmp_path, sedov_tree):
    """The device path's ledger: the engine's signals land in every
    flush, ``device_fallbacks`` read off the device runner's stats."""
    root = str(tmp_path / "run")
    TRACER.enable()
    led = RunLedger(root, "trainer", interval=0)
    eng = InTransitEngine(root, _reducers(), policy="block",
                          device_reduce=True, device="cpu",
                          ledger=led).start()
    for s in (1, 2):
        assert eng.submit(s, sedov_tree.to_arrays())
    eng.drain()
    led.flush()
    assert eng.telemetry()["ledger"]["steps_attributed"] == 2
    eng._device.stats.fallback_snapshots += 1   # what the signal reads
    led.flush()
    eng._device.stats.fallback_snapshots -= 1
    eng.close()
    led.close()
    reader = LedgerReader(root)
    try:
        metas = [next(iter(f["parts"]["meta"].values()))
                 for f in reader.flushes()]
        sig = [m["signals"] for m in metas]
        assert [s["device_fallbacks"] for s in sig] == [0.0, 1.0, 0.0]
        assert all({"staging_pressure", "backpressure", "engine_failed"}
                   <= set(s) for s in sig)
        assert all(s["engine_failed"] == 0.0 for s in sig)
        assert {1, 2} <= set(reader.attribs())
        # the default rule "device_fallbacks > 0 : warn" fired once
        alerts = reader.alerts()
        assert [a["fields"]["signal"] for a in alerts] == \
            ["device_fallbacks"]
        assert reader.verdict() == "degraded"
        assert "engine" in reader.flushes()[0]["parts"]["metrics"][0]
    finally:
        reader.close()


def test_insitu_cli_serve_check_and_ledger(tmp_path, capsys):
    """``launch.insitu --device-reduce --device cpu --serve-check
    --ledger``: the served catalog matches, and ``launch.obs report``
    reads the run's ledger with ``device_fallbacks`` at 0."""
    root = str(tmp_path / "run")
    rc = insitu_cli.main(["--out", root, "--steps", "4", "--max-level", "5",
                          "--resolution", "32", "--queries", "2",
                          "--policy", "block", "--device-reduce",
                          "--device", "cpu", "--serve-check", "--ledger",
                          "--ledger-interval", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert re.search(r"serve check http://\S+: (\d+) arrays, 0 mismatched",
                     out)
    assert "verdict=healthy" in out
    assert obs_cli.main(["report", root]) == 0
    report = capsys.readouterr().out
    assert "verdict: HEALTHY" in report
    assert "critical=" in report
    reader = LedgerReader(root)
    try:
        last = next(iter(reader.flushes()[-1]["parts"]["meta"].values()))
        assert last["signals"]["device_fallbacks"] == 0.0
        assert sorted(reader.attribs()) == [2, 4]
    finally:
        reader.close()


# ------------------------------------------------ across the packages

def _write_ledger(obs_pkg, root):
    """A small two-writer run through one package's ledger and rings."""
    tracer, ring = obs_pkg.TRACER, obs_pkg.EVENTS
    enabled = tracer.enabled
    tracer.clear()
    ring.clear()
    tracer.enable()
    try:
        led = obs_pkg.RunLedger(root, "trainer", interval=0,
                                rules=[obs_pkg.Rule.parse(
                                    "pressure > 0.9 : warn")])
        led.add_signal("pressure", lambda: 0.95)
        ring.emit(obs_events.STEP_BEGIN, step=1, parts=2)
        tracer.ingest([_span("submit", 1, 0, 100),
                       _span("reduce", 1, 100, 900, group=0),
                       _span("manifest.commit", 1, 900, 1000),
                       _span("submit", 2, 1000, 1100)])
        ring.emit(obs_events.STEP_COMMIT, step=1, domains=[0])
        led.ingest_domain(lane_domain(1), {"events": [
            {"ts_us": 5.0, "type": obs_events.LANE_ERROR, "pid": 4242,
             "seq": 1, "fields": {"group": 1, "stage": "reduce"}}]})
        led.flush()
        ring.dump("unit.crash", group=1)
        srv = obs_pkg.RunLedger(root, "server", interval=0)
        srv.flush()
        srv.close()
        led.close()
    finally:
        tracer.enabled = enabled
        tracer.clear()
        ring.clear()


def _read(reader_cls, root) -> dict:
    reader = reader_cls(root)
    try:
        flushes = reader.flushes()
        return {"flushes": [(f["step"], f["seq"], f["slot"], f["proc"],
                             f["parts"]) for f in flushes],
                "events": reader.events(flushes),
                "spans": reader.spans(flushes),
                "attribs": reader.attribs(flushes),
                "alerts": reader.alerts(flushes),
                "crash_dumps": reader.crash_dumps(flushes),
                "verdict": reader.verdict(flushes)}
    finally:
        reader.close()


def _report(cli, root) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["report", root]) == 0
    return buf.getvalue()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_ledger_read_across_packages(tmp_path, writer):
    """Each package's LedgerReader (and ``launch.obs report``) reads the
    other's ``telemetry/`` database and gets the same answers."""
    root = str(tmp_path / "run")
    _write_ledger(ref_obs if writer == "ref" else pt_obs, root)
    got_ref = _read(ref_obs.LedgerReader, root)
    got_pt = _read(LedgerReader, root)
    assert got_pt == got_ref
    assert {f[3] for f in got_pt["flushes"]} == {"trainer", "server"}
    assert got_pt["attribs"][1]["critical"] == "reduce"
    assert got_pt["attribs"][2]["partial"]
    assert [a["fields"]["signal"] for a in got_pt["alerts"]] == ["pressure"]
    assert any(e["fields"].get("reason") == "unit.crash"
               for e in got_pt["crash_dumps"])
    assert got_pt["verdict"] == "degraded"
    report = _report(obs_cli, root)
    assert report == _report(ref_obs_cli, root)
    assert "verdict: DEGRADED" in report
    a, b = str(tmp_path / "pt.json"), str(tmp_path / "ref.json")
    assert obs_cli.main(["export", root, "--perfetto", a]) == 0
    assert ref_obs_cli.main(["export", root, "--perfetto", b]) == 0
    assert json.load(open(a)) == json.load(open(b))
