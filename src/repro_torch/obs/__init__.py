"""Observability substrate of the in-transit pipeline.

  * :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
    histograms behind a :class:`MetricsRegistry`, with Prometheus text
    and JSON snapshot renderers.
  * :mod:`repro_torch.obs.trace` — per-step span tracing with
    Chrome-trace/Perfetto export.
  * :mod:`repro_torch.obs.events` — bounded typed event ring (the
    flight recorder) with crash-dump hooks.
  * :mod:`repro_torch.obs.ledger` — persistent run ledger: periodic
    durable flushes of metrics/spans/events/attribution/health into a
    ``telemetry/`` Hercule database under the run root, readable by
    either package's :class:`LedgerReader`.
  * :mod:`repro_torch.obs.attrib` — per-step critical-path attribution.
  * :mod:`repro_torch.obs.health` — declarative threshold/burn-rate
    rules with a run-end verdict.
  * :mod:`repro_torch.obs.httpd` — opt-in ``/metrics`` scrape endpoint
    for processes without a catalog server.

Everything but the ledger is stdlib only; the ledger writes through
:mod:`repro_torch.hercule`.
"""
from . import attrib, events, health, httpd, ledger, metrics, trace
from .attrib import Attributor, attribute
from .events import EVENTS, EventRing
from .health import HealthEngine, Rule, default_rules
from .httpd import MetricsServer, serve_metrics
from .ledger import LedgerReader, RunLedger
from .metrics import (Counter, Gauge, Histogram, LATENCY_BUCKETS,
                      MetricsRegistry, REGISTRY, exponential_buckets,
                      set_enabled)
from .trace import TRACER, Span, Tracer, now_us

__all__ = [
    "Attributor", "Counter", "EVENTS", "EventRing", "Gauge",
    "HealthEngine", "Histogram", "LATENCY_BUCKETS", "LedgerReader",
    "MetricsRegistry", "MetricsServer", "REGISTRY", "Rule", "RunLedger",
    "Span", "TRACER", "Tracer", "attrib", "attribute", "default_rules",
    "events", "exponential_buckets", "health", "httpd", "ledger",
    "metrics", "now_us", "serve_metrics", "set_enabled", "trace",
]
