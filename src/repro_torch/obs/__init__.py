"""Observability substrate of the in-transit pipeline (stdlib only).

  * :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
    histograms behind a :class:`MetricsRegistry`.
  * :mod:`repro_torch.obs.trace` — per-step span tracing with
    Chrome-trace/Perfetto export.
  * :mod:`repro_torch.obs.events` — bounded typed event ring (the
    flight recorder).
"""
from . import events, metrics, trace
from .events import EVENTS, EventRing
from .metrics import (Counter, Gauge, Histogram, LATENCY_BUCKETS,
                      MetricsRegistry, REGISTRY, exponential_buckets,
                      set_enabled)
from .trace import TRACER, Span, Tracer, now_us

__all__ = [
    "Counter", "EVENTS", "EventRing", "Gauge", "Histogram",
    "LATENCY_BUCKETS", "MetricsRegistry", "REGISTRY", "Span", "TRACER",
    "Tracer", "events", "exponential_buckets", "metrics", "now_us",
    "set_enabled", "trace",
]
