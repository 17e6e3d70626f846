"""Bounded structured event ring: the run's flight recorder.

Where metrics answer "how much" and spans answer "how long", events
answer "what happened": discrete, typed occurrences on the pipeline —
step begin/commit, staging evictions and backpressure transitions, lane
crashes, device fallbacks, checkpoint commits/rebases, serve-side 429
rejections, health alerts. Each is one small dict appended to a bounded
ring (:class:`EventRing`); emission costs one short uncontended lock
acquire plus a deque append, and events are per-step-or-rarer, so the
hot paths never notice.

The ring is volatile by design — persistence is the run ledger's job
(:mod:`repro.obs.ledger` drains it incrementally via
:meth:`EventRing.drain_since`). What makes it a *flight recorder* is the
crash-dump hook: when a lane dies or the engine aborts, :meth:`dump`
flushes the retained window through every registered hook (the ledger
registers one that forces an immediate durable flush), so the last
``capacity`` events survive the crash on disk.

Emission shares the metrics kill switch (``repro_torch.obs.metrics.ENABLED``)
— "obs off" silences the whole always-on substrate at once, and the
overhead benchmark's bare arm measures the true zero-cost path.
"""
from __future__ import annotations

import collections
import os
import threading

from . import metrics as _metrics
from .trace import now_us

# ------------------------------------------------------ event taxonomy

STEP_BEGIN = "step.begin"              # a step entered the pipeline
STEP_COMMIT = "step.commit"            # its context manifest committed
STAGING_EVICT = "staging.evict"        # drop-oldest displaced a part
STAGING_BACKPRESSURE = "staging.backpressure"   # state: enter|exit
LANE_CRASH = "lane.crash"              # a lane process died unreported
LANE_ERROR = "lane.error"              # a lane's reduce/write failed
DEVICE_FALLBACK = "device.fallback"    # device reduce fell back to host
CKPT_COMMIT = "ckpt.commit"            # checkpoint manifest committed
CKPT_REBASE = "ckpt.rebase"            # delta chain rebased onto a full
SERVE_429 = "serve.429"                # admission control shed a viewer
ALERT = "alert"                        # a health rule fired
CRASH_DUMP = "crash.dump"              # the ring was dump()-flushed
RUN_END = "run.end"                    # ledger closed with a verdict

EVENT_TYPES = frozenset({
    STEP_BEGIN, STEP_COMMIT, STAGING_EVICT, STAGING_BACKPRESSURE,
    LANE_CRASH, LANE_ERROR, DEVICE_FALLBACK, CKPT_COMMIT, CKPT_REBASE,
    SERVE_429, ALERT, CRASH_DUMP, RUN_END,
})

DEFAULT_CAPACITY = 4096


class EventRing:
    """Bounded ring of typed event dicts with crash-dump hooks.

    Events are ``{"seq", "ts_us", "type", "pid", "fields"}``; ``seq``
    is a per-ring lifetime counter, so incremental consumers drain with
    :meth:`drain_since` marks and duplicates are detectable across
    process boundaries by ``(pid, seq)``.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        #: entries are ``(arrival, event)``: the arrival cursor orders
        #: emits *and* ingests, so incremental drains never duplicate
        self._ring: collections.deque[tuple[int, dict]] = \
            collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._count = 0          # locally-emitted events (seq stream)
        self._arrivals = 0       # appended entries incl. ingested
        self._dump_hooks: list = []

    # ----------------------------------------------------------- emit
    def emit(self, etype: str, **fields) -> dict | None:
        """Append one typed event; returns it (None when obs is off)."""
        if not _metrics.ENABLED:
            return None
        if etype not in EVENT_TYPES:
            raise ValueError(f"unknown event type {etype!r}; "
                             f"taxonomy: {sorted(EVENT_TYPES)}")
        ev = {"ts_us": now_us(), "type": etype, "pid": os.getpid(),
              "fields": fields}
        with self._lock:
            self._count += 1
            self._arrivals += 1
            ev["seq"] = self._count
            self._ring.append((self._arrivals, ev))
        return ev

    def ingest(self, events) -> None:
        """Merge event dicts produced elsewhere (e.g. a lane process).

        Foreign events keep their own ``pid``/``seq`` identity but get
        local arrival cursors, so drains stay exactly-once.
        """
        if not events:
            return
        with self._lock:
            for ev in events:
                self._arrivals += 1
                self._ring.append((self._arrivals, ev))

    # ---------------------------------------------------------- read
    def snapshot(self) -> list[dict]:
        with self._lock:
            return [ev for _, ev in self._ring]

    def drain_since(self, mark: int) -> tuple[int, list[dict]]:
        """Retained events that arrived after the ``mark`` cursor;
        returns ``(new_mark, events)``. Start at 0; events that arrived
        and fell off between two drains are lost (see ``dropped``)."""
        with self._lock:
            if mark > self._arrivals:     # ring cleared since that mark
                mark = 0
            return self._arrivals, [ev for arr, ev in self._ring
                                    if arr > mark]

    @property
    def count(self) -> int:
        """Lifetime locally-emitted event count."""
        with self._lock:
            return self._count

    @property
    def dropped(self) -> int:
        """Appended events that fell off the bounded ring."""
        with self._lock:
            return max(0, self._arrivals - len(self._ring))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._count = 0
            self._arrivals = 0

    # ---------------------------------------------------- crash dumps
    def register_dump_hook(self, fn) -> None:
        """``fn(reason, ring)`` runs on every :meth:`dump` call."""
        with self._lock:
            if fn not in self._dump_hooks:
                self._dump_hooks.append(fn)

    def unregister_dump_hook(self, fn) -> None:
        with self._lock:
            try:
                self._dump_hooks.remove(fn)
            except ValueError:
                pass

    def dump(self, reason: str, **fields) -> list:
        """Flush the ring through every dump hook (lane died, engine
        aborted). Emits a ``crash.dump`` marker first so readers can
        locate the dump in the persisted stream; hook errors are
        collected, never raised — a broken sink must not mask the
        original crash."""
        self.emit(CRASH_DUMP, reason=reason, **fields)
        with self._lock:
            hooks = list(self._dump_hooks)
        errors = []
        for fn in hooks:
            try:
                fn(reason, self)
            except Exception as e:      # noqa: BLE001 — see docstring
                errors.append(e)
        return errors


#: process-global event ring: pipeline call sites emit through this
EVENTS = EventRing()
