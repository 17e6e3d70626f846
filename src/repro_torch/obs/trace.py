"""Per-step span tracing with cross-process context propagation.

Every pipeline stage (producer ``submit`` → staging enqueue/dequeue →
lane ``reduce`` → device transfer → domain ``write`` → manifest
``commit``) opens a span. Spans carry ``trace_id`` (one per pipeline
step), ``span_id``, and ``parent_id``; within a thread, parentage is
implicit via a thread-local span stack. Across process lanes the parent
context rides the existing shm descriptor JSON header (a two-key dict
from :meth:`Tracer.context`, restored lane-side with ``parent=``), and
finished lane spans are shipped back over the results queue and
:meth:`Tracer.ingest`-ed into the parent's buffer.

The export format is Chrome trace / Perfetto JSON (``traceEvents`` with
complete ``ph:"X"`` events): ``write_chrome_trace(path)`` then
chrome://tracing or https://ui.perfetto.dev loads it directly.

Tracing is OFF by default — ``span()`` returns a shared no-op object
and costs one attribute read; ``launch/insitu.py --trace-out`` enables
the global ``TRACER`` for a run.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
import uuid

_EPOCH_NS = time.time_ns() - time.perf_counter_ns()


def _now_us() -> float:
    """Microseconds since the unix epoch, monotonic within the process."""
    return (_EPOCH_NS + time.perf_counter_ns()) / 1e3


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed unit of pipeline work (Chrome-trace complete event)."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "ts", "dur", "args", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 trace_id: str, parent_id: str | None, args=None):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.ts = _now_us()
        self.dur = 0.0
        self.args = dict(args) if args else {}
        self._tracer = tracer

    def set(self, **kw) -> None:
        self.args.update(kw)

    def __enter__(self):
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self._tracer._pop(self)
        return False

    def context(self) -> dict:
        """Wire form of this span as a parent: rides JSON headers."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def as_dict(self) -> dict:
        return {"name": self.name, "cat": self.cat,
                "trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "pid": os.getpid(),
                "tid": threading.get_ident() % 2**31,
                "ts": self.ts, "dur": self.dur, "args": self.args}


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw) -> None:
        pass

    def context(self):
        return None


_NOOP = _NoopSpan()


#: default retained-span window; a long ledger-instrumented run keeps
#: only the newest spans in memory (older ones were already flushed to
#: the run ledger, or weren't wanted at all)
DEFAULT_MAX_SPANS = 100_000


class Tracer:
    """Collects finished spans; thread-local stack gives implicit parents.

    The span buffer is bounded (``max_spans``, a deque window): once a
    run outgrows it the oldest spans fall off and ``spans_dropped``
    counts them. ``write_chrome_trace``/``export`` keep their exact
    semantics on the retained window; incremental consumers (the run
    ledger) use :meth:`drain_since` marks and therefore see every span
    as long as they drain faster than the window turns over.
    """

    def __init__(self, enabled: bool = False,
                 max_spans: int = DEFAULT_MAX_SPANS):
        self.enabled = enabled
        self._max_spans = int(max_spans)
        self._spans: collections.deque[dict] = \
            collections.deque(maxlen=self._max_spans)
        self._appended = 0          # lifetime spans, incl. fallen-off
        self._lock = threading.Lock()
        self._tls = threading.local()

    # --------------------------------------------------------- lifecycle
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._appended = 0

    def set_max_spans(self, n: int) -> None:
        """Resize the retained window (keeps the newest spans)."""
        with self._lock:
            self._max_spans = int(n)
            self._spans = collections.deque(self._spans,
                                            maxlen=self._max_spans)

    @property
    def max_spans(self) -> int:
        return self._max_spans

    @property
    def spans_dropped(self) -> int:
        """Spans that fell off the bounded window (lifetime count)."""
        with self._lock:
            return self._appended - len(self._spans)

    # ------------------------------------------------------------- spans
    def span(self, name: str, cat: str = "insitu", parent=None,
             args=None):
        """Open a span. ``parent`` may be a wire dict from ``context()``.

        Disabled tracers hand back a shared no-op, so call sites don't
        need their own enabled checks.
        """
        if not self.enabled:
            return _NOOP
        if parent is not None:
            trace_id = parent["trace_id"]
            parent_id = parent["span_id"]
        else:
            cur = self._current()
            if cur is not None:
                trace_id, parent_id = cur.trace_id, cur.span_id
            else:
                trace_id, parent_id = _new_id(), None
        return Span(self, name, cat, trace_id, parent_id, args)

    def record(self, name: str, t0_us: float, t1_us: float,
               cat: str = "insitu", parent=None, args=None) -> dict | None:
        """Log an already-measured interval (timestamps from ``now_us``)."""
        if not self.enabled:
            return None
        span = self.span(name, cat, parent=parent, args=args)
        span.ts = t0_us
        span.dur = max(0.0, t1_us - t0_us)
        rec = span.as_dict()
        with self._lock:
            self._spans.append(rec)
            self._appended += 1
        return rec

    def context(self) -> dict | None:
        """Wire dict of the innermost open span (None when disabled)."""
        cur = self._current()
        return cur.context() if cur is not None else None

    def ingest(self, spans) -> None:
        """Merge span dicts produced elsewhere (e.g. a process lane)."""
        if not spans:
            return
        with self._lock:
            self._spans.extend(spans)
            self._appended += len(spans)

    # ----------------------------------------------------------- exports
    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def drain_since(self, mark: int) -> tuple[int, list[dict]]:
        """Spans appended after ``mark``; returns ``(new_mark, spans)``.

        ``mark`` is an opaque cursor (the lifetime append count from a
        previous call; start at 0). Spans that both arrived and fell
        off the bounded window between two drains are lost — they still
        show in :attr:`spans_dropped`. A cursor ahead of the buffer
        (e.g. after :meth:`clear`) resyncs to the full window.
        """
        with self._lock:
            total = self._appended
            if mark > total:      # buffer was cleared since that mark
                mark = total - len(self._spans)
            n_new = min(total - mark, len(self._spans))
            if n_new <= 0:
                return total, []
            start = len(self._spans) - n_new
            return total, list(itertools.islice(
                self._spans, start, len(self._spans)))

    def export(self) -> dict:
        """Chrome-trace JSON object (load in chrome://tracing/Perfetto)."""
        events = []
        for s in self.spans():
            events.append({
                "name": s["name"], "cat": s["cat"], "ph": "X",
                "pid": s["pid"], "tid": s["tid"],
                "ts": s["ts"], "dur": s["dur"],
                "args": {**s["args"], "trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"]}})
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> int:
        """Write the export to ``path``; returns the span count."""
        doc = self.export()
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(doc["traceEvents"])

    # ----------------------------------------------------------- internal
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _current(self):
        st = self._stack()
        return st[-1] if st else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        span.dur = _now_us() - span.ts
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        else:                      # unbalanced exit: drop just this span
            try:
                st.remove(span)
            except ValueError:
                pass
        with self._lock:
            self._spans.append(span.as_dict())
            self._appended += 1


def now_us() -> float:
    """Public clock for ``Tracer.record`` call sites."""
    return _now_us()


#: process-global tracer: pipeline call sites trace through this; it is
#: disabled (no-op spans) unless a CLI/test enables it
TRACER = Tracer(enabled=False)
