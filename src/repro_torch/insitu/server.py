"""Server-mode catalog: one shared reduction cache for many viewers.

The paper's post-processing scenario (and the in-situ services in
VisIVO/IHPV-style pipelines) has analysis consumers as *remote
processes* querying a catalog service. This module puts the
:class:`~repro_torch.insitu.catalog.Catalog` behind a small stdlib HTTP server
so any number of viewer processes share one LRU reduction cache and one
merge-at-read pass — instead of each process re-reading and re-merging
the same domains.

Wire format (``hx-frame/1``): array payloads travel as raw codec bytes
with a JSON descriptor header, reusing the registered Hercule codecs —
no pickle on the wire, any language can parse it:

    b"HXF1" | u32 header_len | header JSON | payload bytes...

    header = {"schema": "hx-frame/1",
              "arrays": [{"name", "dtype", "shape", "codec", "meta",
                          "nbytes"}, ...]}

Payloads are codec-encoded per array (``raw`` by default; the server may
opt into ``fpdelta-pyramid`` for large float arrays) and concatenated in
header order; the client decodes through the same codec registry
(:func:`repro_torch.hercule.database.get_codec`).

Endpoints (JSON unless framed):

    GET /v1/manifest                         server + database summary
    GET /v1/steps                            context steps
    GET /v1/reducers?step=S                  reducer names in one context
    GET /v1/attrs?step=S                     context attrs
    GET /v1/domains?step=S&reducer=R         contributing domains
    GET /v1/query?step=S&reducer=R[&domain=D][&region=a:b,c:d]   framed
        [&progressive=1]  -> chunked coarse-first hx-frame stream
    GET /v1/series?reducer=R&name=N[&steps=s1,s2]                framed
    GET /v1/stats                            cache + request telemetry
    GET /metrics                             Prometheus text exposition

:class:`RemoteCatalog` mirrors ``Catalog.query`` / ``series`` /
``domains`` (and the discovery surface) over these endpoints; a missing
object raises :class:`KeyError` exactly like the local catalog.
"""
from __future__ import annotations

import collections
import hashlib
import hmac
import json
import os
import queue
import struct
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..hercule.database import Record, get_codec
from ..obs import metrics as obs_metrics
from .catalog import Catalog, _hist_digest, _normalize_region
from .serve import (ProgressiveAssembler, ServeEngine, ServeOverloaded,
                    plan_progressive)

FRAME_MAGIC = b"HXF1"
FRAME_SCHEMA = "hx-frame/1"


# ------------------------------------------------------------ wire format

def pack_frame(arrays: dict[str, np.ndarray], *,
               compress: bool = False) -> bytes:
    """Encode named arrays as one hx-frame/1 message."""
    descs, payloads = [], []
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        codec, meta, payload = "raw", {}, None
        if compress and arr.dtype.kind == "f" and arr.size >= 64:
            enc, m = get_codec("fpdelta-pyramid").encode(arr)
            if len(enc) < arr.nbytes:
                payload, codec, meta = enc, "fpdelta-pyramid", m
        if payload is None:   # raw only materialized when it wins
            payload, _ = get_codec("raw").encode(arr)
        descs.append({"name": name, "dtype": str(arr.dtype),
                      "shape": list(arr.shape), "codec": codec,
                      "meta": meta, "nbytes": len(payload)})
        payloads.append(payload)
    header = json.dumps({"schema": FRAME_SCHEMA, "arrays": descs}).encode()
    return b"".join([FRAME_MAGIC, struct.pack("<I", len(header)), header,
                     *payloads])


def unpack_frame(data: bytes) -> dict[str, np.ndarray]:
    """Decode one hx-frame/1 message through the codec registry."""
    if data[:4] != FRAME_MAGIC:
        raise ValueError("not an hx-frame/1 message")
    (hlen,) = struct.unpack_from("<I", data, 4)
    head = json.loads(data[8:8 + hlen].decode())
    if head.get("schema") != FRAME_SCHEMA:
        raise ValueError(f"unsupported frame schema {head.get('schema')!r}")
    out, off = {}, 8 + hlen
    for d in head["arrays"]:
        payload = data[off:off + d["nbytes"]]
        off += d["nbytes"]
        rec = Record(name=d["name"], domain=0, file="", offset=0,
                     nbytes=d["nbytes"], dtype=d["dtype"],
                     shape=tuple(d["shape"]), codec=d["codec"],
                     meta=d.get("meta", {}))
        # frame codecs are self-contained (no cross-context predictors),
        # so decode needs no database handle
        out[d["name"]] = get_codec(d["codec"]).decode(None, rec, payload)
    return out


def _read_exact(fp, n: int) -> bytes:
    """Read exactly ``n`` bytes from a file-like (chunk-decoded) stream."""
    parts, got = [], 0
    while got < n:
        chunk = fp.read(n - got)
        if not chunk:
            raise ValueError(
                f"progressive stream truncated: wanted {n}, got {got}")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def _read_wire_frame(fp) -> bytes:
    """Read one complete hx-frame/1 message off a streaming response."""
    head = _read_exact(fp, 8)
    if head[:4] != FRAME_MAGIC:
        raise ValueError("not an hx-frame/1 stream")
    (hlen,) = struct.unpack_from("<I", head, 4)
    header = _read_exact(fp, hlen)
    nbytes = sum(d["nbytes"]
                 for d in json.loads(header.decode())["arrays"])
    return head + header + _read_exact(fp, nbytes)


def _parse_region(spec: str):
    """``"8:24,0:16"`` -> ((8, 24), (0, 16))."""
    return tuple(tuple(int(x) for x in part.split(":"))
                 for part in spec.split(","))


def _format_region(region) -> str:
    return ",".join(f"{int(lo)}:{int(hi)}" for lo, hi in region)


# ----------------------------------------------------------------- server

class _PooledHTTPServer(ThreadingHTTPServer):
    """HTTP server with a *bounded* connection-worker pool.

    ``ThreadingHTTPServer`` spawns one OS thread per connection — under
    a viewer storm the OS scheduler, not the serving engine, becomes
    the backstop. Here accepted connections land on a queue drained by
    ``max_connections`` long-lived daemon workers: concurrency is capped
    by configuration, excess connections simply wait their turn (the
    engine's admission control 429s *work* overload long before the
    connection cap matters), and saturation is observable
    (``server_conn_active`` gauge, ``server_conn_saturation_total``
    counter) instead of showing up as thread-count growth.
    """

    def __init__(self, addr, handler, *, max_connections: int = 32,
                 obs: obs_metrics.MetricsRegistry | None = None):
        self.max_connections = max(1, int(max_connections))
        # socketserver's default listen backlog is 5: a viewer-storm
        # connection burst overflows it, dropped SYNs retransmit after
        # 1s, and tail latency jumps by whole seconds. Queue the burst
        # here instead — the workers drain it in arrival order.
        self.request_queue_size = max(128, 4 * self.max_connections)
        super().__init__(addr, handler)
        self._conn_q: queue.SimpleQueue = queue.SimpleQueue()
        self._active_lock = threading.Lock()
        self._active = 0
        self._m_saturated = None
        if obs is not None:
            self._m_saturated = obs.counter(
                "server_conn_saturation_total",
                "connections queued because every worker was busy")
            obs.gauge("server_conn_active",
                      "connection workers currently handling a request"
                      ).set_function(lambda: self._active)
            obs.gauge("server_conn_pool_size",
                      "configured connection-worker cap"
                      ).set(self.max_connections)
        self._conn_threads = [
            threading.Thread(target=self._conn_worker, daemon=True,
                             name=f"hx-conn-{i}")
            for i in range(self.max_connections)]
        for t in self._conn_threads:
            t.start()

    def process_request(self, request, client_address):
        if self._m_saturated is not None and obs_metrics.ENABLED:
            with self._active_lock:
                saturated = self._active >= self.max_connections
            if saturated:
                self._m_saturated.inc()
        self._conn_q.put((request, client_address))

    def _conn_worker(self) -> None:
        while True:
            item = self._conn_q.get()
            if item is None:
                return
            request, client_address = item
            with self._active_lock:
                self._active += 1
            try:
                self.finish_request(request, client_address)
            except Exception:       # noqa: BLE001 — mirror ThreadingMixIn
                self.handle_error(request, client_address)
            finally:
                self.shutdown_request(request)
                with self._active_lock:
                    self._active -= 1

    def server_close(self) -> None:
        super().server_close()
        for _ in self._conn_threads:
            self._conn_q.put(None)


class CatalogServer:
    """HTTP front-end over one shared :class:`Catalog`.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    The handler threads all hit the same catalog, whose lock-guarded
    LRU makes concurrent viewer queries share reductions.

    ``token`` switches on bearer authentication: every request must
    carry ``Authorization: Bearer <token>`` (compared constant-time) or
    is refused with 401 — the minimum for a deployment beyond
    localhost. ``/v1/query`` responses carry an ``ETag`` derived from
    the immutable context manifest, and ``If-None-Match`` revalidation
    answers 304 with no body — a hot viewer re-polling the same object
    skips the transfer entirely (see :class:`RemoteCatalog`).

    ``engine=True`` (the default) routes ``/v1/query`` through a
    :class:`~repro_torch.insitu.serve.ServeEngine`: concurrent identical
    queries coalesce onto one backend read, region crops batch, and
    admission control answers overload with 429 + ``Retry-After``
    (optionally coupled to a staging ring via ``pressure_fn``, see
    :func:`~repro_torch.insitu.serve.staging_pressure`). Connection handling
    runs on a bounded pool of ``max_connections`` workers rather than a
    thread per connection.
    """

    def __init__(self, root, *, host: str = "127.0.0.1", port: int = 0,
                 cache_entries: int = 64, compress: bool = False,
                 token: str | None = None, engine: bool = True,
                 serve_workers: int = 4, max_pending: int = 256,
                 max_connections: int = 32, pressure_fn=None):
        if isinstance(root, Catalog) or hasattr(root, "query"):
            self.catalog, self._own_catalog = root, False
        else:
            self.catalog = Catalog(root, cache_entries=cache_entries)
            self._own_catalog = True
        self.compress = compress
        self.obs = obs_metrics.MetricsRegistry()
        self._sync_obs()
        self.engine = ServeEngine(
            self.catalog, workers=serve_workers, max_pending=max_pending,
            pressure_fn=pressure_fn, obs=self.obs) if engine else None
        handler = _make_handler(self.catalog, compress, token, self.obs,
                                self.engine)
        self.httpd = _PooledHTTPServer(
            (host, port), handler, max_connections=max_connections,
            obs=self.obs)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def bind_ledger(self, ledger) -> None:
        """Register this server with a run ledger (its own, when run as
        a standalone process — ``launch/catalog_serve.py --ledger`` —
        or the trainer's in embedded use): metrics become a flush
        source; ``serve_p99_ms`` (worst per-endpoint request p99 in ms)
        feeds the health rules."""
        ledger.add_source("server", self.obs.snapshot)
        hist = self.obs.histogram(
            "catalog_request_seconds", "request handling latency",
            labels=("endpoint",))

        def p99_ms():
            worst = None
            for _, child in hist.children():
                if child.count:
                    q = child.quantile(0.99) * 1e3
                    worst = q if worst is None else max(worst, q)
            return worst

        ledger.add_signal("serve_p99_ms", p99_ms)

    def _sync_obs(self) -> None:
        """Mirror the shared catalog's cache counters into gauges."""
        cat = self.catalog
        for name, fn in (("entries", lambda: len(cat._cache)),
                         ("hits", lambda: cat.cache_hits),
                         ("misses", lambda: cat.cache_misses),
                         ("io_reads", lambda: cat.io_reads)):
            self.obs.gauge(f"catalog_cache_{name}",
                           f"shared reduction cache: {name}"
                           ).set_function(fn)

    def telemetry(self) -> dict:
        """JSON-able merged snapshot: cache counters + request metrics."""
        out = {"cache": self.catalog.cache_info(),
               "metrics": self.obs.snapshot()}
        if self.engine is not None:
            out["serve"] = self.engine.stats()
        return out

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "CatalogServer":
        """Serve on a background thread (tests, embedded viewers)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self.httpd.serve_forever, name="catalog-server",
                daemon=True)
            self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.engine is not None:
            self.engine.close()
        if self._own_catalog:
            self.catalog.close()


#: routes whose paths become metric label values; anything else is
#: folded into "other" so probing clients can't explode the cardinality
_KNOWN_ENDPOINTS = frozenset({
    "/v1/manifest", "/v1/steps", "/v1/reducers", "/v1/attrs",
    "/v1/domains", "/v1/query", "/v1/series", "/v1/stats", "/metrics"})

PROMETHEUS_CTYPE = "text/plain; version=0.0.4; charset=utf-8"


def _make_handler(catalog: Catalog, compress: bool,
                  token: str | None = None,
                  obs: obs_metrics.MetricsRegistry | None = None,
                  engine: ServeEngine | None = None):
    #: step -> last seen manifest identity; a change means the context
    #: was rewritten (engine resubmission) and cached bytes are stale
    idents: dict[int, tuple[int, int]] = {}
    ident_lock = threading.Lock()

    obs = obs if obs is not None else obs_metrics.MetricsRegistry()
    m_requests = obs.counter(
        "catalog_requests_total", "HTTP requests by endpoint and status",
        labels=("endpoint", "status"))
    m_seconds = obs.histogram(
        "catalog_request_seconds", "request handling latency",
        labels=("endpoint",))
    m_bytes = obs.counter(
        "catalog_bytes_sent_total", "response body bytes by endpoint",
        labels=("endpoint",))
    m_304 = obs.counter(
        "catalog_etag_304_total",
        "ETag revalidations answered 304 (headers only, no payload)")

    def _stats_payload() -> dict:
        """/v1/stats body: cache counters + per-endpoint request stats."""
        info = catalog.cache_info()
        requests: dict[str, dict[str, int]] = {}
        for (endpoint, status), child in m_requests.children():
            requests.setdefault(endpoint, {})[status] = int(child.value)
        info["server"] = {
            "requests": requests,
            "etag_304": int(m_304.value),
            "bytes_sent": {ep: int(c.value)
                           for (ep,), c in m_bytes.children()},
            "request_seconds": {ep: _hist_digest(c)
                                for (ep,), c in m_seconds.children()},
        }
        if engine is not None:
            info["serve"] = engine.stats()
        return info

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet by default
            pass

        # ------------------------------------------------------ responses
        def _observe(self) -> None:
            """Record this request's metrics, once, before its response
            is complete on the wire: a client that reads the response
            and then asks ``/v1/stats`` (a new connection, so another
            worker) finds the request counted. Recording after the last
            write, as the reference server does, races that worker."""
            if self._obs_done:
                return
            self._obs_done = True
            if obs_metrics.ENABLED:
                endpoint = self._obs_endpoint
                m_requests.labels(endpoint, self._obs_status or
                                  "aborted").inc()
                m_seconds.labels(endpoint).observe(
                    time.perf_counter() - self._obs_t0)
                if self._obs_bytes:
                    m_bytes.labels(endpoint).inc(self._obs_bytes)

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: dict | None = None) -> None:
            self._obs_status = code
            self._obs_bytes += len(body)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self._observe()
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200,
                  headers: dict | None = None) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json",
                       headers)

        def _frame(self, arrays: dict, headers: dict | None = None) -> None:
            t0 = time.perf_counter()
            body = pack_frame(arrays, compress=compress)
            if engine is not None:
                engine.observe_stage("encode", time.perf_counter() - t0)
            t1 = time.perf_counter()
            self._send(200, body, "application/x-hx-frame", headers)
            if engine is not None:
                engine.observe_stage("write", time.perf_counter() - t1)

        def _stream_progressive(self, arrays: dict, tag: str) -> None:
            """Chunked coarse-first response: one hx-frame per chunk
            group, frame 0 = coarsest pyramid level + non-pyramidal
            arrays, later frames = refinement blocks (bit-exact once
            complete; see ``repro_torch.insitu.serve.plan_progressive``)."""
            t0 = time.perf_counter()
            frames = plan_progressive(arrays)
            if engine is not None:
                engine.observe_stage("encode", time.perf_counter() - t0)
            self._obs_status = 200
            self.send_response(200)
            self.send_header("Content-Type", "application/x-hx-frame-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("ETag", tag)
            self.send_header("X-Progressive-Frames", str(len(frames)))
            self.end_headers()
            t1 = time.perf_counter()
            for fr in frames:
                data = pack_frame(fr, compress=False)
                self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()
                self._obs_bytes += len(data)
            self._observe()
            self.wfile.write(b"0\r\n\r\n")
            if engine is not None:
                engine.observe_stage("write", time.perf_counter() - t1)

        def _client_token(self) -> str:
            """Fairness token: explicit client id, else the peer host."""
            return self.headers.get("X-Client-Id") \
                or self.client_address[0]

        # ----------------------------------------------------------- auth
        def _authorized(self) -> bool:
            if token is None:
                return True
            got = self.headers.get("Authorization", "")
            # constant-time compare: an attacker probing byte by byte
            # learns nothing from response timing
            return hmac.compare_digest(got.encode(),
                                       f"Bearer {token}".encode())

        # ----------------------------------------------------------- etag
        def _query_etag(self, step: int, reducer: str,
                        domain: int | None, region) -> str:
            """Validator for one reduced object.

            Contexts are immutable once finalized, so the manifest's
            identity (mtime + size) pins the object's bytes; the query
            key makes the tag vary per object/crop. A rewritten context
            (engine resubmission, rebuilt database) changes the
            manifest stat: the tag rotates *and* the server's cached
            bytes for that step are dropped first, so a fresh validator
            is never stamped onto stale LRU content.
            """
            st = os.stat(os.path.join(catalog.db._ctx_dir(step),
                                      "MANIFEST.json"))
            ident = (st.st_mtime_ns, st.st_size)
            with ident_lock:
                stale = idents.get(step, ident) != ident
                idents[step] = ident
            if stale:
                catalog.invalidate_step(step)
            key = (f"{st.st_mtime_ns}/{st.st_size}/{step}/{reducer}/"
                   f"{domain}/{region}")
            return '"' + hashlib.sha1(key.encode()).hexdigest() + '"'

        # --------------------------------------------------------- routes
        def do_GET(self):   # noqa: N802  (http.server API)
            url = urllib.parse.urlsplit(self.path)
            self._obs_endpoint = url.path if url.path in _KNOWN_ENDPOINTS \
                else "other"
            self._obs_status = 0      # 0 = aborted before any response
            self._obs_bytes = 0
            self._obs_done = False
            self._obs_t0 = time.perf_counter()
            q = {k: v[-1] for k, v in
                 urllib.parse.parse_qs(url.query).items()}
            try:
                if not self._authorized():
                    self._json({"error": "unauthorized",
                                "message": "missing or bad bearer token"},
                               code=401,
                               headers={"WWW-Authenticate": "Bearer"})
                    return
                self._route(url.path, q)
            except ServeOverloaded as e:
                # 4xx, not 5xx: the server is healthy, the client must
                # back off (admission control, not failure)
                self._json({"error": "overloaded",
                            "message": str(e),
                            "retry_after": e.retry_after},
                           code=429,
                           headers={"Retry-After":
                                    f"{e.retry_after:.3f}"})
            except (KeyError, FileNotFoundError) as e:
                # a step with no manifest is as absent as an unknown
                # reducer: both surface as KeyError on the client
                self._json({"error": "not_found", "message": str(e)},
                           code=404)
            except (ValueError, TypeError) as e:
                self._json({"error": "bad_request", "message": str(e)},
                           code=400)
            except BrokenPipeError:      # viewer went away mid-response
                pass
            except Exception as e:      # noqa: BLE001
                self._json({"error": "internal", "message": repr(e)},
                           code=500)
            finally:
                self._observe()       # aborted before any response

        @staticmethod
        def _param(q: dict, name: str) -> str:
            try:
                return q[name]
            except KeyError:
                # a client mistake, not an absent object: 400, not 404
                raise ValueError(
                    f"missing query parameter {name!r}") from None

        def _route(self, path: str, q: dict) -> None:
            if path == "/v1/manifest":
                steps = catalog.steps()
                self._json({"schema": "hx-catalog/1",
                            "kind": catalog.db.kind,
                            "steps": steps,
                            "latest": steps[-1] if steps else None})
            elif path == "/v1/steps":
                self._json(catalog.steps())
            elif path == "/v1/reducers":
                self._json(catalog.reducers(int(self._param(q, "step"))))
            elif path == "/v1/attrs":
                self._json(catalog.attrs(int(self._param(q, "step"))))
            elif path == "/v1/domains":
                self._json(catalog.domains(int(self._param(q, "step")),
                                           self._param(q, "reducer")))
            elif path == "/v1/stats":
                self._json(_stats_payload())
            elif path == "/metrics":
                # both registries: request-level (this handler's) and
                # the shared catalog's query/series latency families
                text = (obs.render_prometheus()
                        + catalog.obs.render_prometheus())
                self._send(200, text.encode(), PROMETHEUS_CTYPE)
            elif path == "/v1/query":
                domain = int(q["domain"]) if "domain" in q else None
                region = _parse_region(q["region"]) if "region" in q \
                    else None
                step = int(self._param(q, "step"))
                reducer = self._param(q, "reducer")
                tag = self._query_etag(step, reducer, domain,
                                       q.get("region"))
                inm = self.headers.get("If-None-Match")
                if inm is not None and tag in (
                        t.strip() for t in inm.split(",")):
                    # client already holds these exact bytes: headers
                    # only, no body (RFC 9110 §15.4.5) — revalidation
                    # never touches the serving queue
                    self._obs_status = 304
                    if obs_metrics.ENABLED:
                        m_304.inc()
                    self.send_response(304)
                    self.send_header("ETag", tag)
                    self.send_header("Content-Length", "0")
                    self._observe()
                    self.end_headers()
                    return
                if engine is not None:
                    arrays = engine.fetch(step, reducer, region=region,
                                          domain=domain,
                                          client=self._client_token())
                else:
                    arrays = catalog.query(step, reducer, region=region,
                                           domain=domain)
                if q.get("progressive") in ("1", "true", "yes"):
                    self._stream_progressive(arrays, tag)
                else:
                    self._frame(arrays, headers={"ETag": tag})
            elif path == "/v1/series":
                steps = [int(s) for s in q["steps"].split(",")] \
                    if "steps" in q else None
                out_steps, vals = catalog.series(self._param(q, "reducer"),
                                                 self._param(q, "name"),
                                                 steps=steps)
                frame = {"steps": np.asarray(out_steps, np.int64)}
                for i, v in enumerate(vals):
                    frame[f"value/{i}"] = v
                self._frame(frame)
            else:
                raise KeyError(f"no route {path!r}")

    return Handler


# ----------------------------------------------------------------- client

class CatalogBusy(RuntimeError):
    """The server's admission control answered 429 (back off and retry).

    ``retry_after`` carries the server's backoff hint in seconds.
    """

    def __init__(self, message: str, retry_after: float = 0.05):
        super().__init__(message)
        self.retry_after = float(retry_after)


class RemoteCatalog:
    """Viewer-side twin of :class:`Catalog` over a catalog server.

    ``query``/``series``/``domains`` (and the discovery surface) mirror
    the local catalog's signatures; merge-at-read happens server-side,
    so every viewer process shares the server's reduction cache.

    Queries keep a client-side ETag cache keyed on ``(step, reducer,
    region, domain)``: a revalidation that answers 304 costs one
    header-only round trip and **zero payload bytes** — the hot-viewer
    polling loop stops re-downloading unchanged reductions
    (``etag_hits``/``etag_misses``, :meth:`client_cache_info`).
    ``token`` adds ``Authorization: Bearer`` to every request; a 401
    surfaces as :class:`PermissionError`. A 429 from the server's
    admission control surfaces as :class:`CatalogBusy` — set
    ``busy_retries`` to have the client honor ``Retry-After`` and retry
    transparently. ``client_id`` names this viewer for the server's
    per-client fair queueing (defaults to one token per process).
    """

    def __init__(self, base_url: str, *, timeout: float = 30.0,
                 token: str | None = None, cache_entries: int = 32,
                 client_id: str | None = None, busy_retries: int = 0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.token = token
        self.cache_entries = cache_entries
        self.client_id = client_id if client_id is not None \
            else f"pid-{os.getpid()}"
        self.busy_retries = max(0, int(busy_retries))
        #: (step, reducer, domain, region) -> (etag, frozen arrays)
        self._etag_cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_lock = threading.Lock()
        self.etag_hits = 0
        self.etag_misses = 0

    # ------------------------------------------------------------- plumbing
    def _open(self, path: str, headers: dict | None = None, **params):
        """urlopen with auth + client-id headers; caller owns the body."""
        qs = urllib.parse.urlencode(
            {k: v for k, v in params.items() if v is not None})
        url = f"{self.base_url}{path}" + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, headers=dict(headers or {}))
        if self.token is not None:
            req.add_header("Authorization", f"Bearer {self.token}")
        req.add_header("X-Client-Id", self.client_id)
        return urllib.request.urlopen(req, timeout=self.timeout)

    @staticmethod
    def _raise_http(e: urllib.error.HTTPError):
        """Map an HTTP error to the local-catalog exception surface."""
        body = e.read()
        try:
            msg = json.loads(body.decode()).get("message", "")
        except Exception:
            msg = body.decode(errors="replace")
        if e.code == 404:
            raise KeyError(msg) from None
        if e.code == 401:
            raise PermissionError(
                f"catalog server refused the request: {msg}") from None
        if e.code == 429:
            try:
                after = float(e.headers.get("Retry-After", "0.05"))
            except ValueError:
                after = 0.05
            raise CatalogBusy(
                f"catalog server overloaded: {msg}",
                retry_after=after) from None
        raise RuntimeError(
            f"catalog server error {e.code}: {msg}") from None

    def _request(self, path: str, headers: dict | None = None,
                 **params) -> tuple[int, bytes, dict]:
        """One GET; returns (status, body, response headers).

        304 is a *result* here (ETag revalidation), not an error; 404
        maps to KeyError (local-catalog parity), 401 to PermissionError
        and 429 to :class:`CatalogBusy` — retried ``busy_retries``
        times, sleeping the server's ``Retry-After`` hint between
        attempts.
        """
        for attempt in range(self.busy_retries + 1):
            try:
                with self._open(path, headers, **params) as r:
                    return r.status, r.read(), dict(r.headers)
            except urllib.error.HTTPError as e:
                if e.code == 304:
                    e.read()
                    return 304, b"", dict(e.headers)
                try:
                    self._raise_http(e)
                except CatalogBusy as busy:
                    if attempt >= self.busy_retries:
                        raise
                    time.sleep(min(1.0, busy.retry_after))

    def _get(self, path: str, **params) -> bytes:
        return self._request(path, **params)[1]

    def _get_json(self, path: str, **params):
        return json.loads(self._get(path, **params).decode())

    def _get_frame(self, path: str, **params) -> dict[str, np.ndarray]:
        return unpack_frame(self._get(path, **params))

    # ------------------------------------------------------------ discovery
    def manifest(self) -> dict:
        return self._get_json("/v1/manifest")

    def steps(self) -> list[int]:
        return self._get_json("/v1/steps")

    def latest_step(self) -> int | None:
        return self.manifest()["latest"]

    def reducers(self, step: int) -> list[str]:
        return self._get_json("/v1/reducers", step=step)

    def attrs(self, step: int) -> dict:
        return self._get_json("/v1/attrs", step=step)

    def domains(self, step: int, reducer: str) -> list[int]:
        """Contributor domains holding parts of one reduced object."""
        return self._get_json("/v1/domains", step=step, reducer=reducer)

    def cache_info(self) -> dict:
        """The *server's* shared-cache counters (+ request telemetry)."""
        return self._get_json("/v1/stats")

    def metrics(self) -> str:
        """The server's Prometheus ``/metrics`` exposition text."""
        return self._get("/metrics").decode()

    def client_cache_info(self) -> dict:
        """This viewer's ETag-cache counters."""
        with self._cache_lock:
            return {"entries": len(self._etag_cache),
                    "etag_hits": self.etag_hits,
                    "etag_misses": self.etag_misses}

    # ---------------------------------------------------------------- query
    def query(self, step: int, reducer: str, *,
              region=None, domain: int | None = None
              ) -> dict[str, np.ndarray]:
        """Fetch one reduced object; ``domain=None`` merges server-side.

        Revalidates through the ETag cache: a 304 answer serves the
        cached arrays without transferring the payload again. Cached
        arrays are frozen (mutating callers take a ``.copy()``), like
        the local catalog's.
        """
        region = _normalize_region(region)
        key = (step, reducer, domain, region)
        with self._cache_lock:
            ent = self._etag_cache.get(key)
            if ent is not None:
                self._etag_cache.move_to_end(key)
        status, body, rh = self._request(
            "/v1/query",
            headers={"If-None-Match": ent[0]} if ent else None,
            step=step, reducer=reducer, domain=domain,
            region=_format_region(region) if region is not None else None)
        if status == 304:
            with self._cache_lock:
                self.etag_hits += 1
            return dict(ent[1])
        arrays = unpack_frame(body)
        for arr in arrays.values():
            arr.flags.writeable = False
        etag = {k.lower(): v for k, v in rh.items()}.get("etag")
        with self._cache_lock:
            self.etag_misses += 1
            if etag:
                self._etag_cache[key] = (etag, arrays)
                self._etag_cache.move_to_end(key)
                while len(self._etag_cache) > self.cache_entries:
                    self._etag_cache.popitem(last=False)
        return dict(arrays)

    def query_progressive(self, step: int, reducer: str, *,
                          region=None, domain: int | None = None):
        """Iterate coarse-to-fine reconstructions of one reduced object.

        Yields a ``{name: array}`` dict after every received frame: the
        first arrives after one coarse chunk (the ``fpdelta-pyramid``
        root level upsampled to full shape), later ones refine, and the
        final yield is **bit-exact** with :meth:`query` — the pyramid
        codec is lossless. Bypasses the ETag cache (the stream is the
        transfer-avoidance mechanism here).
        """
        region = _normalize_region(region)
        try:
            resp = self._open(
                "/v1/query", step=step, reducer=reducer, domain=domain,
                region=_format_region(region) if region is not None
                else None, progressive=1)
        except urllib.error.HTTPError as e:
            self._raise_http(e)
        asm = ProgressiveAssembler()
        with resp:
            while not asm.done:
                yield asm.feed(unpack_frame(_read_wire_frame(resp)))

    def series(self, reducer: str, name: str, *,
               steps: list[int] | None = None) -> tuple[np.ndarray, list]:
        """(steps, values) time series of one array across contexts."""
        frame = self._get_frame(
            "/v1/series", reducer=reducer, name=name,
            steps=",".join(str(s) for s in steps) if steps else None)
        out_steps = frame.pop("steps")
        vals = [frame[f"value/{i}"] for i in range(len(frame))]
        return out_steps, vals


def open_catalog(target: str, **kw):
    """``http(s)://...`` -> :class:`RemoteCatalog`, else a local Catalog."""
    if str(target).startswith(("http://", "https://")):
        return RemoteCatalog(str(target), **kw)
    return Catalog(target, **kw)


__all__ = ["CatalogServer", "RemoteCatalog", "CatalogBusy",
           "open_catalog", "pack_frame", "unpack_frame", "FRAME_SCHEMA"]
