"""Query API over reduced HDep objects, with an LRU reduction cache.

The paper's many-concurrent-viewers scenario: dashboards and viewers ask
for the same few reductions over and over. The catalog keys an LRU cache
on ``(step, reducer, region)`` so repeated queries are served from memory
— the database files are only touched on a miss (observable via
:attr:`io_reads` / :attr:`cache_hits`).

A *region* is an optional tuple of ``(lo, hi)`` pairs cropping the
leading axes of every array in the reduced object (e.g. a zoomed window
of a slice image). Cropping happens on the cached full object, so a
window query after a full query is also a cache hit.
"""
from __future__ import annotations

import collections
import threading
import time

import numpy as np

from ..hercule import api
from ..hercule.database import HerculeDB
from ..obs import metrics as obs_metrics

Region = tuple[tuple[int, int], ...]


def _normalize_region(region) -> Region | None:
    if region is None:
        return None
    return tuple((int(lo), int(hi)) for lo, hi in region)


def _crop(arrays: dict[str, np.ndarray], region: Region
          ) -> dict[str, np.ndarray]:
    out = {}
    for name, arr in arrays.items():
        if arr.ndim >= len(region):
            sl = tuple(slice(lo, hi) for lo, hi in region)
            out[name] = arr[sl]
        else:
            out[name] = arr
    return out


def _hist_digest(h) -> dict:
    """Compact JSON-able digest of one histogram (no NaN quantiles)."""
    _, total, n = h.merged()
    out = {"count": n, "sum": total}
    if n:
        out.update(h.quantiles())
    return out


class Catalog:
    """Read-side view of an in-transit HDep database."""

    def __init__(self, root: str | HerculeDB, *, cache_entries: int = 64):
        self.db = root if isinstance(root, HerculeDB) else \
            HerculeDB.open(root)
        self.cache_entries = cache_entries
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.io_reads = 0      # records decoded from the database files
        self.cache_hits = 0
        self.cache_misses = 0
        #: private registry: two catalogs in one process never collide
        self.obs = obs_metrics.MetricsRegistry()
        self._h_query = self.obs.histogram(
            "catalog_query_seconds",
            "query() latency split by cache outcome", labels=("result",))
        self._h_series = self.obs.histogram(
            "catalog_series_seconds", "series() end-to-end latency")

    # ------------------------------------------------------------ discovery
    def steps(self) -> list[int]:
        return self.db.contexts()

    def latest_step(self) -> int | None:
        return self.db.latest_context()

    def reducers(self, step: int) -> list[str]:
        return api.REDUCED.reducers_in(self.db.view(step))

    def attrs(self, step: int) -> dict:
        return self.db.view(step).attrs

    def scan(self, selector: api.Selector | None = None, **kw):
        """Iterate matching reduced records (see :func:`hercule.api.scan`).

        Defaults to the ``reduced`` kind; pass an explicit selector to
        widen. Yields :class:`~repro_torch.hercule.api.RecordRef`.
        """
        if selector is None and "kinds" not in kw:
            kw["kinds"] = "reduced"
        return api.scan(self.db, selector, **kw)

    def domains(self, step: int, reducer: str) -> list[int]:
        """Contributor domains holding parts of one reduced object."""
        return api.REDUCED.domains_in(self.db.view(step), reducer)

    # ---------------------------------------------------------------- query
    def query(self, step: int, reducer: str, *,
              region=None, domain: int | None = None
              ) -> dict[str, np.ndarray]:
        """Fetch one reduced object, optionally cropped to ``region``.

        ``domain=None`` (the default) transparently merges the object
        across every contributing domain using the reducer's registered
        merge strategy — on a single-domain database this is bit-for-bit
        the plain read. Pass a concrete domain for one group's part.

        Contexts are immutable once finalized, so cached entries never go
        stale. The full (merged) object is what gets cached; region crops
        are views of the cached arrays.
        """
        t0 = time.perf_counter() if obs_metrics.ENABLED else 0.0
        region = _normalize_region(region)
        key = (step, reducer, domain)
        with self._lock:
            full = self._cache.get(key)
            if full is not None:
                self._cache.move_to_end(key)
                self.cache_hits += 1
        hit = full is not None
        if full is None:
            full = api.read_object(self.db, step, "reduced", domain,
                                   reducer=reducer)
            for arr in full.values():
                # cached arrays are shared across viewers: freeze them so
                # an in-place edit can't poison later queries (mutating
                # callers take an explicit .copy())
                arr.flags.writeable = False
            with self._lock:
                self.cache_misses += 1
                self.io_reads += len(full)
                self._cache[key] = full
                self._cache.move_to_end(key)
                while len(self._cache) > self.cache_entries:
                    self._cache.popitem(last=False)
        if obs_metrics.ENABLED:
            self._h_query.labels("hit" if hit else "miss").observe(
                time.perf_counter() - t0)
        if region is None:
            return dict(full)
        return _crop(full, region)

    def peek(self, step: int, reducer: str, domain: int | None = None
             ) -> bool:
        """True when the full object is already in the LRU cache.

        A cache probe, not a fetch: the serving engine
        (:mod:`repro.insitu.serve`) uses it to let cached objects bypass
        admission control — a hot viewer polling an object the server
        already holds must not be 429'd just because the *backend read*
        queue is saturated. Does not touch hit/miss counters or LRU
        order.
        """
        with self._lock:
            return (step, reducer, domain) in self._cache

    def series(self, reducer: str, name: str, *,
               steps: list[int] | None = None) -> tuple[np.ndarray, list]:
        """(steps, values) time series of one array across contexts.

        A Selector scan finds the contexts actually holding the record
        (index lookups, no decoding); values are then served through the
        cached (domain-merged) :meth:`query` path — a context whose
        record lives in several contributor domains appears once.
        ``reducer``/``name`` are compared as exact strings — glob
        characters in them are literal.
        """
        t0 = time.perf_counter() if obs_metrics.ENABLED else 0.0
        target = f"reduced/{reducer}/{name}"
        sel = api.Selector(steps=steps, kinds="reduced")
        out_steps, vals = [], []
        for ref in api.scan(self.db, sel):
            if ref.record.name != target or ref.step in out_steps[-1:]:
                continue
            out_steps.append(ref.step)
            vals.append(self.query(ref.step, reducer)[name])
        if obs_metrics.ENABLED:
            self._h_series.observe(time.perf_counter() - t0)
        return np.asarray(out_steps, np.int64), vals

    # ----------------------------------------------------------------- admin
    def invalidate_step(self, step: int) -> None:
        """Drop every cached object of one step (rewritten context).

        Contexts are normally immutable, which is the cache's premise —
        but the engine's resubmission path *can* rewrite a step's
        manifest. The catalog server calls this when the manifest
        identity changes, so a fresh ETag never gets stamped onto stale
        cached bytes.
        """
        with self._lock:
            for key in [k for k in self._cache if k[0] == step]:
                del self._cache[key]
        self.db._invalidate_view(step)

    def cache_info(self) -> dict:
        """Cache counters plus a compact query/series latency summary.

        The four counter keys are stable API; ``timing`` carries
        histogram digests (count/sum + interpolated quantiles, NaN-free
        so the dict JSON-serializes strictly).
        """
        with self._lock:
            info = {"entries": len(self._cache), "hits": self.cache_hits,
                    "misses": self.cache_misses, "io_reads": self.io_reads}
        info["timing"] = {
            "query_hit": _hist_digest(self._h_query.labels("hit")),
            "query_miss": _hist_digest(self._h_query.labels("miss")),
            "series": _hist_digest(self._h_series),
        }
        return info

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()

    def close(self) -> None:
        """Release the cache and the underlying database handles."""
        self.clear_cache()
        self.db.close()
