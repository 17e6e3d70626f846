"""Persistent run ledger: telemetry as its own Hercule flavor.

The paper's lesson is purpose-specific formats — HProt for restart,
HDep for post-processing. Without a ledger, metrics, spans and events
live only in volatile process memory, scattered over the producer, the
lane processes and the catalog server, gone the moment anything
crashed. The run ledger gives observability its own
lightweight Hercule flavor instead: a ``telemetry/`` sub-database under
the run root to which every process periodically appends a *flush* —
one small Hercule context holding JSON records
(:class:`~repro_torch.hercule.api.TelemetryKind`):

  ``telemetry/meta``     flush header (proc, seq, wall time, reason)
  ``telemetry/metrics``  MetricsRegistry snapshots per source
  ``telemetry/spans``    span batch drained from the tracer since the
                         previous flush (exactly-once via drain marks)
  ``telemetry/events``   event-ring drain (same discipline)
  ``telemetry/attrib``   per-step critical-path attribution completed
                         since the previous flush
  ``telemetry/health``   rule-engine state incl. full alert history

Domain layout follows the engine's per-producer shape: the trainer (or
the insitu CLI's producer process) writes domain 0, the catalog server
writes domain 1, and process lanes land as domains ``8+group`` — their
span/event batches arrive over the existing results queue and the
engine relays them into the trainer's ledger via :meth:`ingest_domain`.
Context numbering keeps concurrent committers collision-free: flush
``seq`` of committer slot ``s`` commits context ``seq*64 + s``, and
every commit is the usual fsync-then-atomic-rename, so a SIGKILL at any
point leaves every previously-flushed context readable.

Crash persistence: the ledger registers a dump hook on the global event
ring — when a lane dies or the engine aborts,
:meth:`~repro_torch.obs.events.EventRing.dump` forces an immediate flush that also carries *partial*
attribution for every step still in flight.

:class:`LedgerReader` merges the whole run back (all domains, all
slots): merged event/span streams, per-step attribution, alert
timeline, run verdict — the substrate for ``launch/obs.py``'s
``tail`` / ``report`` / ``export --perfetto``.
"""
from __future__ import annotations

import json
import os
import threading
import time

from ..hercule import api
from ..hercule.database import DomainWriter, HerculeDB
from . import metrics as _metrics
from .attrib import Attributor
from .events import ALERT, EVENTS, RUN_END, LANE_CRASH, STAGING_EVICT, \
    SERVE_429
from .health import HealthEngine
from .trace import TRACER, now_us

#: context step = seq * SEQ_STRIDE + slot; one slot per committing
#: process, so concurrent committers never race a manifest
SEQ_STRIDE = 64
SLOTS = {"trainer": 0, "server": 1}
#: Hercule domain of each writer within a flush context
DOMAINS = {"trainer": 0, "server": 1}
LANE_DOMAIN_BASE = 8

LEDGER_DIRNAME = "telemetry"


def ledger_dir(run_root: str) -> str:
    """The telemetry sub-database of a run root (idempotent)."""
    if os.path.basename(os.path.normpath(run_root)) == LEDGER_DIRNAME:
        return run_root
    return os.path.join(run_root, LEDGER_DIRNAME)


def lane_domain(group: int) -> int:
    """Ledger domain of contributor-group ``group``'s lane process."""
    return LANE_DOMAIN_BASE + int(group)


def _open_db(path: str) -> HerculeDB:
    """Create-or-open with a retry: two processes (trainer + catalog
    server) may race the initial ``db.json`` write; the content is
    identical, so losing the race only means re-reading it."""
    for attempt in range(3):
        try:
            return HerculeDB.create(path, kind="hdep", ncf=1,
                                    io_threads=1)
        except (json.JSONDecodeError, OSError):
            if attempt == 2:
                raise
            time.sleep(0.05 * (attempt + 1))
    raise AssertionError("unreachable")


class RunLedger:
    """One process's writer into the run's telemetry database.

    ``interval > 0`` starts a daemon flush thread; ``interval = 0``
    leaves cadence to explicit :meth:`flush` calls (tests, benchmarks).
    Registered *sources* (``name -> fn() -> metrics snapshot``) are
    captured every flush; *signals* (``name -> fn() -> float|None``)
    feed the health rule engine, alongside the event-derived rates the
    ledger computes itself (eviction/429 rates, lane-crash count).
    """

    def __init__(self, run_root: str, proc: str = "trainer", *,
                 interval: float = 2.0, rules=None,
                 capture_spans: bool = True):
        if proc not in SLOTS:
            raise ValueError(f"proc must be one of {sorted(SLOTS)}")
        self.proc = proc
        self.slot = SLOTS[proc]
        self.domain = DOMAINS[proc]
        self.dir = ledger_dir(run_root)
        self.db = _open_db(self.dir)
        self.interval = float(interval)
        self.capture_spans = capture_spans
        self.health = HealthEngine(rules)
        self.attributor = Attributor()
        self._sources: dict = {"process": _metrics.REGISTRY.snapshot}
        self._signals: dict = {}
        self._foreign: list[tuple[int, dict]] = []   # (domain, parts)
        # drain marks start at the current heads: a ledger owns its
        # run's telemetry from the moment it is created, not whatever an
        # earlier run in this process left in the global rings
        self._span_mark = TRACER.drain_since(0)[0]
        self._event_mark = EVENTS.drain_since(0)[0]
        self._counts = {"lane_crashes": 0, "evictions": 0, "serve_429": 0}
        self._last_flush_ts = time.monotonic()
        self._flush_lock = threading.Lock()
        self._closed = False
        self.bytes_written = 0
        self.flushes = 0
        self.steps_attributed = 0
        # resume after a crash/restart: continue this slot's seq stream
        seqs = [s // SEQ_STRIDE for s in self.db.contexts()
                if s % SEQ_STRIDE == self.slot]
        self._seq = (max(seqs) + 1) if seqs else 0
        EVENTS.register_dump_hook(self._on_dump)
        self._stop = threading.Event()
        self._thread = None
        if self.interval > 0:
            self._thread = threading.Thread(
                target=self._loop, name=f"ledger-{proc}", daemon=True)
            self._thread.start()

    # ------------------------------------------------------- registration
    def add_source(self, name: str, fn) -> None:
        """Register a metrics source (``fn() -> snapshot dict``)."""
        self._sources[name] = fn

    def add_signal(self, name: str, fn) -> None:
        """Register a health signal (``fn() -> float | None``)."""
        self._signals[name] = fn

    def ingest_domain(self, domain: int, parts: dict) -> None:
        """Queue another process's telemetry parts (e.g. a lane batch
        relayed over the results queue) for the next flush."""
        if parts:
            with self._flush_lock:
                self._foreign.append((int(domain), dict(parts)))

    # ------------------------------------------------------------- flush
    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.flush(reason="interval")
            except Exception:   # noqa: BLE001 — a failing flush must
                pass            # never take the pipeline down with it

    def _on_dump(self, reason: str, ring) -> None:
        self.flush(reason=reason, dump=True)

    def _event_signals(self, events, elapsed: float) -> dict:
        for ev in events:
            t = ev.get("type")
            if t == LANE_CRASH:
                self._counts["lane_crashes"] += 1
            elif t == STAGING_EVICT:
                self._counts["evictions"] += 1
            elif t == SERVE_429:
                self._counts["serve_429"] += 1
        n_evict = sum(1 for ev in events
                      if ev.get("type") == STAGING_EVICT)
        n_429 = sum(1 for ev in events if ev.get("type") == SERVE_429)
        elapsed = max(elapsed, 1e-6)
        return {"lane_crashes": self._counts["lane_crashes"],
                "eviction_rate": n_evict / elapsed,
                "serve_429_rate": n_429 / elapsed}

    def flush(self, reason: str = "manual", *, dump: bool = False
              ) -> int | None:
        """Write one ledger context; returns its step id (None if the
        ledger is already closed)."""
        with self._flush_lock:
            if self._closed and reason != "final":
                return None
            now_wall = now_us()
            elapsed = time.monotonic() - self._last_flush_ts
            self._last_flush_ts = time.monotonic()

            spans: list = []
            if self.capture_spans:
                self._span_mark, spans = \
                    TRACER.drain_since(self._span_mark)
            foreign, self._foreign = self._foreign, []
            # lane spans were TRACER.ingest-ed engine-side and ride the
            # trainer drain; lane *events* arrive as foreign parts and
            # also feed attribution/health below
            foreign_events = [ev for _, parts in foreign
                              for ev in parts.get("events", ())]
            attribs = self.attributor.ingest(spans)
            if dump or reason == "final":
                attribs = attribs + self.attributor.flush_pending()
            self.steps_attributed += sum(1 for a in attribs
                                         if not a["partial"])

            # health: evaluate on signals *before* draining events so
            # fired alerts land in this same flush
            _, pre_events = EVENTS.drain_since(self._event_mark)
            signals = self._event_signals(pre_events + foreign_events,
                                          elapsed)
            for name, fn in self._signals.items():
                try:
                    v = fn()
                except Exception:   # noqa: BLE001 — bad signal != crash
                    v = None
                if v is not None:
                    signals[name] = float(v)
            for alert in self.health.observe(signals, ts_us=now_wall):
                EVENTS.emit(ALERT, **alert)
            self._event_mark, events = \
                EVENTS.drain_since(self._event_mark)

            parts = {
                "meta": {"proc": self.proc, "seq": self._seq,
                         "pid": os.getpid(), "ts_us": now_wall,
                         "reason": reason, "elapsed_s": elapsed,
                         "signals": signals,
                         "spans_dropped": TRACER.spans_dropped,
                         "events_dropped": EVENTS.dropped},
                "metrics": {name: fn() for name, fn
                            in self._sources.items()},
                "spans": spans,
                "events": events,
                "attrib": {str(a["step"]): a for a in attribs},
                "health": self.health.state(),
            }
            step = self._seq * SEQ_STRIDE + self.slot
            writer = DomainWriter(self.db, step)
            api.KINDS["telemetry"].write(writer, self.domain, parts)
            for domain, fparts in foreign:
                api.KINDS["telemetry"].write(writer, domain, fparts)
            self.db.commit_context(step, writer.records, attrs={
                "telemetry": {"proc": self.proc, "seq": self._seq,
                              "reason": reason}})
            self.bytes_written += sum(r.nbytes for r in writer.records)
            self.flushes += 1
            self._seq += 1
            return step

    # ------------------------------------------------------------- admin
    def verdict(self) -> str:
        return self.health.verdict()

    def telemetry(self) -> dict:
        """The ledger's own accounting (for engine/CLI summaries)."""
        return {"proc": self.proc, "flushes": self.flushes,
                "bytes_written": self.bytes_written,
                "steps_attributed": self.steps_attributed,
                "verdict": self.health.verdict(),
                "alerts": len(self.health.alerts)}

    def close(self) -> None:
        if self._closed:
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        EVENTS.emit(RUN_END, proc=self.proc,
                    verdict=self.health.verdict())
        self._closed = True
        self.flush(reason="final")
        EVENTS.unregister_dump_hook(self._on_dump)
        self.db.close()


# ===================================================================== read

class LedgerReader:
    """Merged read side over every process's flushes of one run."""

    def __init__(self, run_root: str):
        path = ledger_dir(run_root)
        if not os.path.exists(os.path.join(path, "db.json")):
            raise FileNotFoundError(
                f"no run ledger under {run_root!r} (expected "
                f"{path}/db.json — was the run started with a ledger?)")
        self.db = HerculeDB.open(path)
        self._kind = api.KINDS["telemetry"]

    def close(self) -> None:
        self.db.close()

    # ----------------------------------------------------------- flushes
    def flushes(self) -> list[dict]:
        """Every flush context, time-ordered: ``{seq, slot, step,
        parts}`` with parts merged across the flush's domains."""
        out = []
        for step in self.db.contexts():
            view = self.db.view(step)
            parts = self._kind.assemble(view)
            meta = next(iter(parts.get("meta", {}).values()), {})
            out.append({"step": step, "seq": step // SEQ_STRIDE,
                        "slot": step % SEQ_STRIDE,
                        "ts_us": meta.get("ts_us", 0.0),
                        "proc": meta.get("proc", f"slot{step % SEQ_STRIDE}"),
                        "parts": parts})
        out.sort(key=lambda f: (f["ts_us"], f["step"]))
        return out

    # ------------------------------------------------------ merged views
    def events(self, flushes=None) -> list[dict]:
        """One time-ordered event stream for the whole run (deduped)."""
        seen, out = set(), []
        for fl in flushes if flushes is not None else self.flushes():
            for ev in fl["parts"].get("events", []):
                key = (ev.get("pid"), ev.get("seq"), ev.get("type"),
                       ev.get("ts_us"))
                if key not in seen:
                    seen.add(key)
                    out.append(ev)
        out.sort(key=lambda e: e.get("ts_us", 0.0))
        return out

    def spans(self, flushes=None) -> list[dict]:
        """Every persisted span across trainer, lanes and server."""
        out = []
        for fl in flushes if flushes is not None else self.flushes():
            out.extend(fl["parts"].get("spans", []))
        out.sort(key=lambda s: s.get("ts", 0.0))
        return out

    def attribs(self, flushes=None) -> dict[int, dict]:
        """Per-step attribution; a complete record wins over a partial
        one from a crash flush, later flushes win otherwise."""
        out: dict[int, dict] = {}
        for fl in flushes if flushes is not None else self.flushes():
            for dom_attr in fl["parts"].get("attrib", {}).values():
                for key, a in (dom_attr or {}).items():
                    step = int(key)
                    prev = out.get(step)
                    if prev is not None and not prev["partial"] \
                            and a["partial"]:
                        continue        # complete beats partial
                    out[step] = a
        return out

    def alerts(self, flushes=None) -> list[dict]:
        return [ev for ev in self.events(flushes)
                if ev.get("type") == ALERT]

    def crash_dumps(self, flushes=None) -> list[dict]:
        return [ev for ev in self.events(flushes)
                if ev.get("type") in ("crash.dump", LANE_CRASH)]

    def verdict(self, flushes=None) -> str:
        """Worst run-end verdict across every writing process."""
        order = {"healthy": 0, "degraded": 1, "critical": 2}
        worst = "healthy"
        fls = flushes if flushes is not None else self.flushes()
        latest: dict[str, str] = {}
        for fl in fls:
            for health in fl["parts"].get("health", {}).values():
                if health and "verdict" in health:
                    latest[fl["proc"]] = health["verdict"]
        for v in latest.values():
            if order.get(v, 0) > order[worst]:
                worst = v
        return worst

    def export_perfetto(self, path: str) -> int:
        """Write one merged Chrome-trace/Perfetto JSON for the run —
        trainer, lane and server spans in a single timeline. Returns
        the event count."""
        events = []
        for s in self.spans():
            events.append({
                "name": s["name"], "cat": s.get("cat", "insitu"),
                "ph": "X", "pid": s["pid"], "tid": s["tid"],
                "ts": s["ts"], "dur": s["dur"],
                "args": {**s.get("args", {}),
                         "trace_id": s.get("trace_id"),
                         "span_id": s.get("span_id"),
                         "parent_id": s.get("parent_id")}})
        events.sort(key=lambda e: e["ts"])
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      fh)
        return len(events)
