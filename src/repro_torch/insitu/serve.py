"""Continuous-batching serving core between the catalog server and catalog.

The paper's HDep format exists so that *many concurrent analysis
consumers* can be fed cheaply — but a thread-per-request HTTP front end
over :class:`~repro_torch.insitu.catalog.Catalog` pays one full decode+merge
per request on a cache miss: 100 identical viewers cost 100x one viewer.
This module is the JetStream-style engine shape
that fixes the serving story; :class:`~repro_torch.insitu.server.CatalogServer`
routes ``/v1/query`` through it, and it is equally usable embedded
(benchmarks, tests, custom front ends).

:class:`ServeEngine` provides four mechanisms:

  * **Single-flight coalescing** — concurrent requests for the same
    coalescing key ``(step, reducer, name, domain)`` attach to one
    in-flight backend read; N identical viewers cost one decode+merge
    and N response writes (``serve_coalesced_total``).
  * **Crop batching** — region crops of the same object are *compatible*
    requests: the flight performs one merged full-object read and every
    requester slices its own crop from the shared frozen arrays
    (``serve_batched_reads_total`` counts flights that served more than
    one distinct region from a single read).
  * **Admission control + per-client fairness** — a bounded pending
    queue (capacity scaled down by the staging ring's backpressure
    signal, see :func:`staging_pressure`) refuses overload with
    :class:`ServeOverloaded` → HTTP 429 + ``Retry-After``; queued work
    drains round-robin across client tokens so one flooding dashboard
    cannot starve the others. Objects already in the catalog's LRU
    bypass admission entirely (they cost no backend read).
  * **Progressive responses** — :func:`plan_progressive` splits a
    reduced object into a coarse-first frame sequence built on the
    ``fpdelta-pyramid`` levels (the codec's mean pyramid *is* a LOD
    ladder): frame 0 carries the coarsest level (plus every
    non-pyramidal array), later frames stream refinement blocks, and
    :class:`ProgressiveAssembler` reconstructs — approximately after
    every frame, **bit-exactly** after the last (the codec is lossless).

Metric families (registered on the engine's — usually the server's —
registry): ``serve_coalesced_total``, ``serve_batched_reads_total``,
``serve_admission_rejections_total``, ``serve_backend_reads_total``,
``serve_cache_serves_total``, the ``serve_queue_depth`` gauge, and the
``serve_stage_seconds{stage}`` latency histograms
(admit/queue/read/follow/crop/encode/write).
"""
from __future__ import annotations

import collections
import io
import json
import threading
import time

import numpy as np

from ..core import fpdelta, pyramid
from ..hercule.codecs import _block_to_bytes, _blocks_from_bytes
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from .catalog import _crop, _normalize_region

#: stage labels of the serve_stage_seconds histogram family
STAGES = ("admit", "queue", "read", "follow", "crop", "encode", "write")


class ServeOverloaded(RuntimeError):
    """Admission control refused the request (HTTP 429 upstream).

    ``retry_after`` (seconds) is the server's backoff hint; it grows
    with the observed backpressure.
    """

    def __init__(self, retry_after: float):
        super().__init__(f"serving queue full; retry after "
                         f"{retry_after:.3f}s")
        self.retry_after = float(retry_after)


def staging_pressure(area) -> "collections.abc.Callable[[], float]":
    """Backpressure signal (0..1) from a staging ring's queue depth.

    Pass the result as ``pressure_fn`` to couple admission control to a
    live :class:`~repro_torch.insitu.staging.StagingArea`: when the ring backs
    up (the compute flow is outrunning the analysis flow), the serving
    engine sheds viewer load first instead of competing for the same
    cores.
    """
    return lambda: len(area) / max(1, area.capacity)


class _Flight:
    """One in-flight backend read plus everyone waiting on it."""

    __slots__ = ("event", "result", "error", "followers", "regions")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.followers = 0
        self.regions: set = set()


class ServeEngine:
    """Single-flight, batching, fair-queueing front end over a catalog.

    ``catalog`` needs ``query(step, reducer, domain=...)`` (full-object
    read) and ``peek(step, reducer, domain)`` (cache probe) — a
    :class:`~repro_torch.insitu.catalog.Catalog` or any duck-typed wrapper.
    ``workers`` backend-read threads execute queued flights;
    ``max_pending`` bounds flights admitted but not yet finished, scaled
    down to 10% as ``pressure_fn()`` approaches 1.0.
    """

    def __init__(self, catalog, *, workers: int = 4,
                 max_pending: int = 256, retry_after: float = 0.05,
                 pressure_fn=None,
                 obs: obs_metrics.MetricsRegistry | None = None):
        self.catalog = catalog
        self.workers = max(1, int(workers))
        self.max_pending = max(1, int(max_pending))
        self.base_retry_after = float(retry_after)
        self.pressure_fn = pressure_fn
        self.obs = obs if obs is not None else obs_metrics.MetricsRegistry()

        self._cv = threading.Condition()
        self._inflight: dict[tuple, _Flight] = {}
        self._queues: dict[str, collections.deque] = {}
        self._rr: collections.deque = collections.deque()
        self._pending = 0
        self._closed = False

        self._m_coalesced = self.obs.counter(
            "serve_coalesced_total",
            "requests attached to an in-flight identical backend read")
        self._m_batched = self.obs.counter(
            "serve_batched_reads_total",
            "flights that served >1 distinct region crop from one read")
        self._m_rejected = self.obs.counter(
            "serve_admission_rejections_total",
            "requests refused by admission control (429)")
        self._m_backend = self.obs.counter(
            "serve_backend_reads_total",
            "full decode+merge reads executed against the catalog")
        self._m_inline = self.obs.counter(
            "serve_cache_serves_total",
            "requests served inline from the catalog LRU (no queue slot)")
        self.obs.gauge(
            "serve_queue_depth",
            "flights admitted but not yet finished"
        ).set_function(lambda: self._pending)
        self._h_stage = self.obs.histogram(
            "serve_stage_seconds", "per-stage serving latency",
            labels=("stage",))

        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"hx-serve-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    # --------------------------------------------------------- admission
    def _pressure(self) -> float:
        if self.pressure_fn is None:
            return 0.0
        try:
            return min(1.0, max(0.0, float(self.pressure_fn())))
        except Exception:       # noqa: BLE001 — a dead producer's signal
            return 0.0          # must not take serving down with it

    def capacity(self) -> int:
        """Effective admission capacity under the current backpressure."""
        return max(1, int(self.max_pending * (1.0 - 0.9 * self._pressure())))

    def retry_after(self) -> float:
        """Backoff hint for a rejected client; grows with backpressure."""
        return self.base_retry_after * (1.0 + 9.0 * self._pressure())

    def observe_stage(self, stage: str, seconds: float) -> None:
        """Record one stage latency (servers report encode/write here)."""
        if obs_metrics.ENABLED:
            self._h_stage.labels(stage).observe(seconds)

    # ------------------------------------------------------------- fetch
    def fetch(self, step: int, reducer: str, *, name: str | None = None,
              region=None, domain: int | None = None,
              client: str = "anon", timeout: float = 120.0
              ) -> dict[str, np.ndarray]:
        """One viewer request; returns the (cropped) reduced object.

        Coalesces with concurrent identical requests, batches region
        crops onto one read, and raises :class:`ServeOverloaded` when
        admission control refuses. ``KeyError`` propagates exactly like
        ``Catalog.query`` (absent object).
        """
        t0 = time.perf_counter()
        region = _normalize_region(region)
        key = (step, reducer, name, domain)
        with self._cv:
            if self._closed:
                raise RuntimeError("ServeEngine is closed")
            fl = self._inflight.get(key)
            if fl is not None:                    # single-flight attach
                fl.followers += 1
                fl.regions.add(region)
                # stats() counters are functional (the selftest and the
                # load test assert on them): never gated on the obs
                # kill switch, unlike the stage histograms
                self._m_coalesced.inc()
            elif self.catalog.peek(step, reducer, domain):
                fl = None                         # LRU hit: serve inline
            else:
                if self._pending >= self.capacity():
                    self._m_rejected.inc()
                    obs_events.EVENTS.emit(
                        obs_events.SERVE_429, step=step, reducer=reducer,
                        pending=self._pending,
                        retry_after=self.retry_after())
                    raise ServeOverloaded(self.retry_after())
                fl = self._inflight[key] = _Flight()
                fl.regions.add(region)
                self._pending += 1
                self._enqueue_locked(client, key, fl)
                self._cv.notify()
        self.observe_stage("admit", time.perf_counter() - t0)

        if fl is None:                            # inline cache serve
            self._m_inline.inc()
            full = self.catalog.query(step, reducer, domain=domain)
        else:
            t1 = time.perf_counter()
            if not fl.event.wait(timeout):
                raise TimeoutError(
                    f"backend read for {key} did not finish in {timeout}s")
            self.observe_stage("follow", time.perf_counter() - t1)
            if fl.error is not None:
                raise fl.error
            full = fl.result
        t2 = time.perf_counter()
        out = dict(full) if region is None else _crop(full, region)
        self.observe_stage("crop", time.perf_counter() - t2)
        return out

    # --------------------------------------------------- fair scheduling
    def _enqueue_locked(self, client: str, key: tuple, fl: _Flight
                        ) -> None:
        q = self._queues.get(client)
        if q is None:
            q = self._queues[client] = collections.deque()
            if client not in self._rr:
                self._rr.append(client)
        q.append((key, fl, time.perf_counter()))

    def _next_job_locked(self):
        """Round-robin across client tokens; None when nothing queued."""
        for _ in range(len(self._rr)):
            c = self._rr[0]
            self._rr.rotate(-1)
            q = self._queues.get(c)
            if not q:
                # lazily retire clients with no queued work (c is now
                # at the tail after the rotate)
                self._queues.pop(c, None)
                if self._rr and self._rr[-1] == c:
                    self._rr.pop()
                continue
            return q.popleft()
        return None

    def _worker(self) -> None:
        while True:
            with self._cv:
                job = self._next_job_locked()
                while job is None and not self._closed:
                    self._cv.wait(0.5)
                    job = self._next_job_locked()
                if job is None:
                    return
            key, fl, t_enq = job
            self.observe_stage("queue", time.perf_counter() - t_enq)
            step, reducer, _name, domain = key
            t0 = time.perf_counter()
            try:
                fl.result = self.catalog.query(step, reducer,
                                               domain=domain)
                self._m_backend.inc()
            except BaseException as e:      # noqa: BLE001 — propagated
                fl.error = e                # to every waiter
            self.observe_stage("read", time.perf_counter() - t0)
            with self._cv:
                self._inflight.pop(key, None)
                self._pending -= 1
                n_regions = len(fl.regions)
            if n_regions > 1:
                self._m_batched.inc()
            fl.event.set()

    # --------------------------------------------------------------- admin
    def stats(self) -> dict:
        """JSON-able counter snapshot (the /v1/stats ``serve`` section)."""
        with self._cv:
            depth, inflight = self._pending, len(self._inflight)
        return {"coalesced": int(self._m_coalesced.value),
                "batched_reads": int(self._m_batched.value),
                "rejections": int(self._m_rejected.value),
                "backend_reads": int(self._m_backend.value),
                "cache_serves": int(self._m_inline.value),
                "queue_depth": depth,
                "inflight": inflight,
                "capacity": self.capacity(),
                "workers": self.workers,
                "max_pending": self.max_pending}

    def close(self) -> None:
        with self._cv:
            self._closed = True
            # fail any still-queued flights: their waiters must not hang
            for q in self._queues.values():
                for _key, fl, _t in q:
                    fl.error = RuntimeError("ServeEngine closed")
                    fl.event.set()
            self._queues.clear()
            self._rr.clear()
            self._inflight.clear()
            self._pending = 0
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)


# ---------------------------------------------------------- progressive

PROG_SCHEMA = "hx-progressive/1"
#: floats below this element count ship whole in frame 0 (a pyramid of
#: a tiny array refines nothing worth a round trip)
PROG_MIN_SIZE = 4096


def _upsample(vals: np.ndarray, shape: tuple, dtype) -> np.ndarray:
    """Nearest-neighbour preview of a coarse pyramid level at full shape."""
    n = int(np.prod(shape)) if shape else 1
    reps = -(-n // max(1, vals.size))
    return np.repeat(np.asarray(vals), reps)[:n].reshape(shape) \
        .astype(dtype, copy=False)


def plan_progressive(arrays: dict[str, np.ndarray], *,
                     min_size: int = PROG_MIN_SIZE, zbits: int = 4
                     ) -> list[dict[str, np.ndarray]]:
    """Split a reduced object into coarse-first ``hx-frame/1`` payloads.

    Frame 0 carries a JSON plan (``__prog__``), every non-pyramidal
    array whole, and the coarsest pyramid level (``<name>@root``) of
    each eligible float array. Frame ``i`` (i>=1) carries refinement
    block ``k-i`` of each array with ``k`` levels (coarse → fine), as
    raw section bytes (``<name>@L<j>``). Feeding all frames to
    :class:`ProgressiveAssembler` reproduces the arrays bit-exactly.
    """
    plan: dict = {"schema": PROG_SCHEMA, "arrays": {}}
    frame0: dict[str, np.ndarray] = {}
    blocks_of: dict[str, list[bytes]] = {}
    n_refine = 0
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        if a.dtype in (np.dtype(np.float32), np.dtype(np.float64)) \
                and a.size >= min_size:
            pc = pyramid.encode_pyramid(a, zbits=zbits)
            if pc.levels:
                k = len(pc.levels)
                plan["arrays"][name] = {
                    "mode": "pyramid", "dtype": str(a.dtype),
                    "shape": list(a.shape), "pad": pc.pad, "n_levels": k}
                frame0[f"{name}@root"] = pc.root
                secs = []
                for blk in pc.levels:           # fine -> coarse storage
                    buf = io.BytesIO()
                    _block_to_bytes(buf, blk)
                    secs.append(buf.getvalue())
                blocks_of[name] = secs
                n_refine = max(n_refine, k)
                continue
        plan["arrays"][name] = {"mode": "full"}
        frame0[name] = a
    plan["frames"] = 1 + n_refine
    frames = [{"__prog__": np.frombuffer(json.dumps(plan).encode(),
                                         np.uint8), **frame0}]
    for i in range(1, n_refine + 1):
        fr: dict[str, np.ndarray] = {}
        for name, secs in blocks_of.items():
            j = len(secs) - i                   # coarsest block first
            if j >= 0:
                fr[f"{name}@L{j}"] = np.frombuffer(secs[j], np.uint8)
        frames.append(fr)
    return frames


class ProgressiveAssembler:
    """Viewer-side reassembly of a :func:`plan_progressive` stream.

    ``feed`` one decoded frame at a time; each call returns the current
    best reconstruction (coarse levels upsampled nearest-neighbour).
    After the final frame (``done``) the result is bit-exact — the
    pyramid codec is lossless, so refinement is *correction*, not
    approximation.
    """

    def __init__(self):
        self.plan: dict | None = None
        self._root: dict[str, np.ndarray] = {}
        self._blocks: dict[str, dict[int, fpdelta.Compressed]] = {}
        self._full: dict[str, np.ndarray] = {}
        self._frames_seen = 0

    @property
    def done(self) -> bool:
        return self.plan is not None and \
            self._frames_seen >= int(self.plan["frames"])

    def feed(self, frame: dict[str, np.ndarray]
             ) -> dict[str, np.ndarray]:
        if self.plan is None:
            meta = frame.get("__prog__")
            if meta is None:
                raise ValueError("first frame carries no __prog__ plan")
            self.plan = json.loads(bytes(bytearray(meta)).decode())
            if self.plan.get("schema") != PROG_SCHEMA:
                raise ValueError(
                    f"unsupported progressive schema "
                    f"{self.plan.get('schema')!r}")
            for name, spec in self.plan["arrays"].items():
                if spec["mode"] == "full":
                    self._full[name] = frame[name]
                else:
                    self._root[name] = frame[f"{name}@root"]
                    self._blocks[name] = {}
        else:
            for tkey, payload in frame.items():
                name, sep, j = tkey.rpartition("@L")
                if not sep or name not in self._blocks:
                    raise ValueError(
                        f"unexpected refinement key {tkey!r}")
                self._blocks[name][int(j)] = \
                    _blocks_from_bytes(bytes(bytearray(payload)))[0]
        self._frames_seen += 1
        return self.current()

    def current(self) -> dict[str, np.ndarray]:
        """Best reconstruction from the frames received so far."""
        if self.plan is None:
            raise ValueError("no frames fed yet")
        out = dict(self._full)
        for name, spec in self.plan["arrays"].items():
            if spec["mode"] != "pyramid":
                continue
            k = int(spec["n_levels"])
            shape = tuple(spec["shape"])
            dtype = np.dtype(spec["dtype"])
            cur = np.asarray(self._root[name])
            have = self._blocks[name]
            exact = True
            for j in range(k - 1, -1, -1):      # decode coarse -> fine
                blk = have.get(j)
                if blk is None:
                    exact = False
                    break
                cur = fpdelta.decode(blk, cur[:blk.n_groups]).reshape(-1)
            if exact:
                n = int(np.prod(shape)) if shape else 1
                out[name] = cur[:n].reshape(shape)
            else:
                out[name] = _upsample(cur, shape, dtype)
        return out

    def result(self) -> dict[str, np.ndarray]:
        """The bit-exact arrays; raises unless every frame was fed."""
        if not self.done:
            raise ValueError(
                f"progressive stream incomplete: "
                f"{self._frames_seen}/{self.plan and self.plan['frames']} "
                f"frames")
        return self.current()


__all__ = ["ServeEngine", "ServeOverloaded", "staging_pressure",
           "plan_progressive", "ProgressiveAssembler", "PROG_SCHEMA",
           "STAGES"]
