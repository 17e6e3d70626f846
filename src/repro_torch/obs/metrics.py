"""Process-local metrics: counters, gauges, fixed-bucket histograms.

The in-transit pipeline's measurement substrate (DESIGN.md §15). Three
instrument kinds behind one :class:`MetricsRegistry`:

  * :class:`Counter`   — monotonically increasing float. The write path
    is lock-free: each thread accumulates into its own shard (a slot of
    a plain dict keyed by thread id, written only by that thread — a
    single GIL-atomic read-modify-write), and shards are summed at read.
  * :class:`Gauge`     — last-write-wins value, or a pull ``fn`` sampled
    at collect time (for stats another object already maintains).
  * :class:`Histogram` — fixed bucket boundaries, per-thread shards of
    bucket counts. Quantiles (p50/p90/p99) are estimated at read by
    linear interpolation inside the bucket holding the rank — accuracy
    is bounded by the bucket width (asserted against numpy percentiles
    in ``tests/test_obs.py``).

Labeled families (``registry.counter(name, labels=("endpoint",))``)
materialize one child instrument per label-value tuple so staging areas,
lanes, reducers and server endpoints register under stable names with
bounded cardinality. :meth:`MetricsRegistry.render_prometheus` emits the
Prometheus text exposition format (scraped by ``CatalogServer`` at
``/metrics``); :meth:`MetricsRegistry.snapshot` the JSON twin.

``ENABLED`` is the module kill switch the overhead benchmark flips
(``bench_insitu.run_obs_overhead``): instrumented call sites gate their
observes on it, so the uninstrumented baseline is measurable in-process.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import time

#: global kill switch consulted by instrumented hot paths (the overhead
#: benchmark measures the pipeline with this off vs on)
ENABLED = True


def set_enabled(on: bool) -> None:
    global ENABLED
    ENABLED = bool(on)


_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _escape_label(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"") \
        .replace("\n", r"\n")


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# ------------------------------------------------------------ instruments

class Counter:
    """Monotonic counter; per-thread shards merged at read."""

    kind = "counter"

    def __init__(self):
        self._shards: dict[int, float] = {}

    def inc(self, v: float = 1.0) -> None:
        # each thread writes only its own key: one dict slot, GIL-atomic
        tid = threading.get_ident()
        d = self._shards
        d[tid] = d.get(tid, 0.0) + v

    @property
    def value(self) -> float:
        return sum(self._shards.values())

    def sample(self):
        return self.value


class Gauge:
    """Point-in-time value: set directly, or pulled from ``fn``."""

    kind = "gauge"

    def __init__(self):
        self._value = 0.0
        self._fn = None

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self._value += v

    def dec(self, v: float = 1.0) -> None:
        self._value -= v

    def set_function(self, fn) -> None:
        """Sample ``fn()`` at collect time instead of a stored value."""
        self._fn = fn

    @property
    def value(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def sample(self):
        return self.value


#: default latency buckets (seconds): 1 µs .. 60 s, ~x2.5 steps
LATENCY_BUCKETS = (1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4,
                   5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def exponential_buckets(start: float, factor: float, count: int
                        ) -> tuple[float, ...]:
    return tuple(start * factor ** i for i in range(count))


class Histogram:
    """Fixed-bucket histogram with per-thread shards.

    ``observe`` touches only this thread's shard (bucket counts + sum),
    no lock anywhere on the write path. Reads merge every shard.
    """

    kind = "histogram"

    def __init__(self, buckets=None):
        bounds = tuple(sorted(buckets or LATENCY_BUCKETS))
        assert bounds, "histogram needs at least one finite bucket bound"
        self.bounds = bounds                   # finite upper bounds
        self._n = len(bounds) + 1              # + the +Inf bucket
        self._shards: dict[int, list] = {}     # tid -> [counts, sum]

    def observe(self, v: float) -> None:
        tid = threading.get_ident()
        shard = self._shards.get(tid)
        if shard is None:
            shard = self._shards.setdefault(tid, [[0] * self._n, 0.0])
        shard[0][bisect.bisect_left(self.bounds, v)] += 1
        shard[1] += v

    def timeit(self):
        """Context manager observing the elapsed wall seconds."""
        return _Timer(self)

    # ----------------------------------------------------------- reads
    def merged(self) -> tuple[list[int], float, int]:
        """(per-bucket counts, value sum, total count) over all shards."""
        counts = [0] * self._n
        total = 0.0
        for shard in list(self._shards.values()):
            for i, c in enumerate(shard[0]):
                counts[i] += c
            total += shard[1]
        return counts, total, sum(counts)

    @property
    def count(self) -> int:
        return self.merged()[2]

    @property
    def sum(self) -> float:
        return self.merged()[1]

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile by in-bucket interpolation.

        Exact to within the width of the bucket holding the rank; the
        open +Inf bucket reports its lower bound.
        """
        counts, _, n = self.merged()
        if n == 0:
            return math.nan
        rank = q * n
        cum = 0
        for i, c in enumerate(counts):
            prev = cum
            cum += c
            if cum >= rank and c > 0:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                if i == len(self.bounds):      # the open +Inf bucket
                    return self.bounds[-1]
                hi = self.bounds[i]
                return lo + (hi - lo) * (rank - prev) / c
        return self.bounds[-1]

    def quantiles(self, qs=(0.5, 0.9, 0.99)) -> dict[str, float]:
        return {f"p{int(q * 100)}": self.quantile(q) for q in qs}

    def sample(self):
        counts, total, n = self.merged()
        out = {"count": n, "sum": total,
               "buckets": dict(zip([*map(float, self.bounds), math.inf],
                                   counts))}
        if n:
            out.update(self.quantiles())
        return out


class _Timer:
    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric with 0+ label dimensions.

    With no ``labels`` the family is its single child (attribute access
    forwards), so ``registry.counter("x").inc()`` just works; with
    labels, :meth:`labels` materializes/returns the child for one
    label-value tuple.
    """

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: tuple[str, ...], **kw):
        assert _NAME_RE.match(name), f"bad metric name {name!r}"
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._kw = kw
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = _KINDS[kind](**kw)

    def labels(self, *values) -> object:
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: got {len(key)} label values for "
                f"{self.labelnames}")
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, _KINDS[self.kind](
                    **self._kw))
        return child

    def __getattr__(self, attr):
        # unlabeled families act as their single child
        if not self.labelnames:
            return getattr(self._children[()], attr)
        raise AttributeError(
            f"{self.name} has labels {self.labelnames}; use .labels(...)")

    def children(self) -> list[tuple[tuple, object]]:
        with self._lock:
            return sorted(self._children.items())


# -------------------------------------------------------------- registry

class MetricsRegistry:
    """Named instruments + pull callbacks, one coherent read surface.

    Components create (or share) a registry and register instruments
    under stable names; ``snapshot``/``render_prometheus`` give the
    merged view. ``register_callback(fn)`` runs ``fn()`` before every
    collect — the hook that syncs externally-maintained stats (staging
    counters, cache info) into gauges without touching their hot paths.
    """

    def __init__(self):
        self._families: dict[str, Family] = {}
        self._callbacks: list = []
        self._lock = threading.Lock()

    # ------------------------------------------------------ constructors
    def _family(self, name: str, kind: str, help: str, labels, **kw
                ) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}")
                return fam
            fam = Family(name, kind, help, tuple(labels), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels=()) -> Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=None) -> Family:
        return self._family(name, "histogram", help, labels,
                            buckets=buckets)

    def register_callback(self, fn) -> None:
        with self._lock:
            self._callbacks.append(fn)

    # ------------------------------------------------------------ reads
    def _collect(self) -> list[Family]:
        with self._lock:
            callbacks = list(self._callbacks)
        # callbacks run first: they may register families lazily
        for fn in callbacks:
            try:
                fn()
            except Exception:       # noqa: BLE001 — a dead component's
                pass                # callback must not poison the scrape
        with self._lock:
            return sorted(self._families.values(),
                          key=lambda f: f.name)

    def snapshot(self) -> dict:
        """JSON-able view: name -> {kind, help, values|series}."""
        out = {}
        for fam in self._collect():
            samples = []
            for key, child in fam.children():
                samples.append({
                    "labels": dict(zip(fam.labelnames, key)),
                    "value": child.sample()})
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "samples": samples}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for fam in self._collect():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children():
                pairs = [f'{n}="{_escape_label(v)}"'
                         for n, v in zip(fam.labelnames, key)]
                if fam.kind == "histogram":
                    counts, total, n = child.merged()
                    cum = 0
                    for bound, c in zip([*child.bounds, math.inf], counts):
                        cum += c
                        lp = ",".join([*pairs, f'le="{_fmt(bound)}"'])
                        lines.append(f"{fam.name}_bucket{{{lp}}} {cum}")
                    suffix = "{" + ",".join(pairs) + "}" if pairs else ""
                    lines.append(f"{fam.name}_sum{suffix} {_fmt(total)}")
                    lines.append(f"{fam.name}_count{suffix} {n}")
                else:
                    suffix = "{" + ",".join(pairs) + "}" if pairs else ""
                    lines.append(
                        f"{fam.name}{suffix} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"


#: process-wide default registry (components may also own private ones —
#: the engine and catalog server do, so two instances never collide)
REGISTRY = MetricsRegistry()
