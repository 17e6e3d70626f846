"""Declarative run-health rules: thresholds, burn rates, a verdict.

A :class:`Rule` watches one *signal* — a named scalar the run ledger
computes each flush (staging pressure, eviction rate, ckpt stall ratio,
serve p99, device fallbacks, lane crashes) — and fires when the signal
violates its threshold persistently enough:

* ``window=1`` (default): plain threshold — one bad sample fires.
* ``window=N, burn=f``: windowed burn rate — fires when at least
  ``ceil(f*N)`` of the last ``N`` samples violate, the standard SLO
  burn-rate shape that ignores one-sample blips but catches sustained
  pressure.

Rules are data, not code: build them from dicts/kwargs or from the
compact string syntax (``Rule.parse``)::

    staging_pressure > 0.9 for 3/5 : warn
    lane_crashes    >= 1           : crit

Firing is *edge-triggered*: an alert event is emitted when a rule
transitions into violation, and a clear is recorded when it leaves, so
the event stream stays an incident log rather than a square wave.
:meth:`HealthEngine.verdict` folds the run's alert history into one
run-end answer: ``healthy`` / ``degraded`` (only warnings) /
``critical``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import re

_OPS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}

_RULE_RE = re.compile(
    r"^\s*(?P<signal>[\w.]+)\s*(?P<op>>=|<=|>|<)\s*(?P<thr>[-\w.+]+)"
    r"(?:\s+for\s+(?P<need>\d+)/(?P<window>\d+))?"
    r"(?:\s*:\s*(?P<sev>warn|crit))?\s*$")

SEVERITIES = ("warn", "crit")


@dataclasses.dataclass
class Rule:
    """One health rule over a ledger signal."""

    signal: str
    op: str
    threshold: float
    window: int = 1
    burn: float = 1.0               # fraction of window that must violate
    severity: str = "warn"
    name: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}; use one of "
                             f"{sorted(_OPS)}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}")
        self.window = max(1, int(self.window))
        self.burn = min(1.0, max(0.0, float(self.burn)))
        if not self.name:
            self.name = f"{self.signal}{self.op}{self.threshold:g}"

    @property
    def need(self) -> int:
        """Violating samples within the window required to fire."""
        return max(1, math.ceil(self.burn * self.window))

    @staticmethod
    def parse(text: str, severity: str | None = None) -> "Rule":
        """Build a rule from the compact syntax (see module docstring).

        ``"signal > 0.9"`` — instant threshold; append ``for K/N`` for
        a K-of-last-N burn window and ``: warn|crit`` for severity.
        """
        m = _RULE_RE.match(text)
        if m is None:
            raise ValueError(
                f"unparsable health rule {text!r}; expected "
                f"'<signal> <op> <threshold> [for K/N] [: warn|crit]'")
        window = int(m["window"]) if m["window"] else 1
        need = int(m["need"]) if m["need"] else 1
        if need > window:
            raise ValueError(f"rule {text!r}: K must be <= N in 'for K/N'")
        return Rule(signal=m["signal"], op=m["op"],
                    threshold=float(m["thr"]), window=window,
                    burn=need / window,
                    severity=severity or m["sev"] or "warn")

    def violated(self, value: float) -> bool:
        return _OPS[self.op](float(value), self.threshold)


def default_rules() -> list[Rule]:
    """The stock rule set over the signals the stock writers register.

    A rule whose signal never appears in a run's flushes simply stays
    idle — trainer-side and server-side ledgers share one default set.
    """
    return [
        Rule.parse("staging_pressure > 0.9 for 2/3 : warn"),
        Rule.parse("eviction_rate > 2 for 2/3 : warn"),       # parts/s
        Rule.parse("backpressure > 0.5 for 3/5 : warn"),      # blocked frac
        Rule.parse("ckpt_stall_ratio > 0.25 for 2/3 : warn"),
        Rule.parse("device_fallbacks > 0 : warn"),
        Rule.parse("serve_p99_ms > 500 for 2/3 : warn"),
        Rule.parse("serve_429_rate > 5 for 2/3 : warn"),      # rejects/s
        Rule.parse("lane_crashes >= 1 : crit"),
        Rule.parse("engine_failed >= 1 : crit"),
    ]


class HealthEngine:
    """Evaluates rules over successive signal samples; keeps history."""

    def __init__(self, rules=None):
        self.rules: list[Rule] = list(default_rules() if rules is None
                                      else rules)
        self._hist = {r.name: collections.deque(maxlen=r.window)
                      for r in self.rules}
        self._active: dict[str, dict] = {}
        self.alerts: list[dict] = []    # full incident history
        self._samples = 0

    def observe(self, signals: dict, *, ts_us: float = 0.0) -> list[dict]:
        """Feed one flush's signal sample; returns newly-fired alerts."""
        self._samples += 1
        fired = []
        for rule in self.rules:
            value = signals.get(rule.signal)
            if value is None:
                continue                # signal absent this run: idle
            hist = self._hist[rule.name]
            hist.append(1 if rule.violated(value) else 0)
            burning = len(hist) == rule.window and sum(hist) >= rule.need
            active = rule.name in self._active
            if burning and not active:
                alert = {"rule": rule.name, "signal": rule.signal,
                         "severity": rule.severity,
                         "value": float(value),
                         "threshold": rule.threshold, "op": rule.op,
                         "window": rule.window, "need": rule.need,
                         "ts_us": ts_us, "sample": self._samples}
                self._active[rule.name] = alert
                self.alerts.append(alert)
                fired.append(alert)
            elif not burning and active:
                cleared = self._active.pop(rule.name)
                cleared["cleared_sample"] = self._samples
                cleared["cleared_ts_us"] = ts_us
        return fired

    def state(self) -> dict:
        """JSON-able engine state, persisted with every ledger flush."""
        return {"samples": self._samples,
                "rules": [r.name for r in self.rules],
                "active": sorted(self._active),
                "alerts": list(self.alerts),
                "verdict": self.verdict()}

    def verdict(self) -> str:
        if any(a["severity"] == "crit" for a in self.alerts):
            return "critical"
        if self.alerts:
            return "degraded"
        return "healthy"
