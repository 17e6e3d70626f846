"""Catalog server CLI: ``python -m repro_torch.launch.catalog_serve ...``

Serves an in-transit HDep database to remote viewer processes over the
``hx-frame/1`` wire format (see ``repro_torch.insitu.server``): one process
holds the reduction cache and performs merge-at-read; every viewer —
``RemoteCatalog`` in Python, or anything that can parse a JSON header
plus raw codec bytes — shares it.

    python -m repro_torch.launch.catalog_serve --root <run root>
    python -m repro_torch.launch.catalog_serve --root ... --port 8265 --compress

``--selftest`` is the CI smoke: it generates a small 2-domain in-transit
database (unless ``--root`` points at an existing one), serves it on an
ephemeral port, and verifies that ``RemoteCatalog.query(domain=None)``
returns arrays equal to the local ``Catalog.query`` merge-at-read for
every reduced object — plus single-flight coalescing and progressive
(coarse-first) stream bit-exactness — then exits 0/1.

``--selftest --load N`` additionally runs the serving-engine load test:
N concurrent viewer clients hammer the server through cold-cache rounds
(thundering herds) and report sustained QPS, p99 latency, and the
engine's coalesce/batch/rejection counters. The step fails on any 5xx
response or when no request was ever coalesced or batched.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import threading
import time

import numpy as np


def _make_demo_db(root: str, *, domains: int = 2, steps: int = 2) -> None:
    """Small Sedov-based 2-domain in-transit database for the selftest."""
    from ..insitu import (InTransitEngine, LevelHistogramReducer,
                          LODCutReducer, ProjectionReducer, SliceReducer)
    from ..sim import amrgen, fields
    eng = InTransitEngine(root, [
        LODCutReducer(max_level=3),
        SliceReducer(field="density", axis=2, position=0.5, resolution=64),
        ProjectionReducer(field="density", axis=2, resolution=64),
        LevelHistogramReducer(field="density", bins=16, lo=0.0, hi=8.0),
    ], domains=domains).start()
    for s in range(1, steps + 1):
        r_shock = 0.1 + 0.25 * s / steps
        tree = amrgen.generate_tree(fields.sedov(r_shock=r_shock),
                                    min_level=2, max_level=5, threshold=1.2)
        eng.submit(s, tree)
    eng.close()


def _selftest(root: str | None, compress: bool,
              token: str | None = None, *, engine: bool = True,
              serve_workers: int = 4, max_pending: int = 256,
              max_connections: int = 32, load: int = 0) -> int:
    from ..insitu import Catalog, CatalogServer, RemoteCatalog
    tmp = None
    if root is None:
        tmp = tempfile.mkdtemp(prefix="hx_catalog_selftest_")
        root = tmp
        print(f"== selftest: generating 2-domain in-transit db in {root}")
        _make_demo_db(root)
    token = token or "selftest-secret"
    srv = CatalogServer(root, port=0, compress=compress, token=token,
                        engine=engine, serve_workers=serve_workers,
                        max_pending=max_pending,
                        max_connections=max_connections).start()
    local = Catalog(root)
    try:
        # auth: no/wrong token must bounce with 401 before touching data
        for bad in (RemoteCatalog(srv.url),
                    RemoteCatalog(srv.url, token="wrong")):
            try:
                bad.steps()
            except PermissionError:
                pass
            else:
                print("   FAIL: unauthenticated request was served")
                return 1
        rc = RemoteCatalog(srv.url, token=token)
        steps = rc.steps()
        print(f"== serving {srv.url}: steps={steps}")
        if steps != local.steps() or not steps:
            print("   FAIL: step listing mismatch")
            return 1
        checked = mismatched = 0
        for s in steps:
            for reducer in local.reducers(s):
                remote = rc.query(s, reducer)       # merge-at-read,
                ref = local.query(s, reducer)       # server-side
                for k, a in ref.items():
                    checked += 1
                    if not np.array_equal(a, remote[k], equal_nan=True):
                        mismatched += 1
                        print(f"   MISMATCH step={s} {reducer}/{k}")
                if rc.domains(s, reducer) != local.domains(s, reducer):
                    mismatched += 1
                    print(f"   MISMATCH domains step={s} {reducer}")
        # ETag revalidation: a re-query of every object must 304 and
        # serve from the client cache (zero payload bytes)
        requeries = 0
        t_304 = 0.0
        for s in steps:
            for reducer in local.reducers(s):
                t0 = time.perf_counter()
                rc.query(s, reducer)
                t_304 += time.perf_counter() - t0
                requeries += 1
        cinfo = rc.client_cache_info()
        if cinfo["etag_hits"] < requeries:
            print(f"   FAIL: expected {requeries} ETag revalidation "
                  f"hits, got {cinfo}")
            return 1
        # cold-vs-304 split: a fresh viewer (empty ETag cache, warm
        # server cache) pays the full payload transfer each query
        rc_cold = RemoteCatalog(srv.url, token=token)
        t_cold = 0.0
        for s in steps:
            for reducer in local.reducers(s):
                t0 = time.perf_counter()
                rc_cold.query(s, reducer)
                t_cold += time.perf_counter() - t0
        print(f"   latency split over {requeries} queries: full transfer "
              f"{1e3 * t_cold / requeries:.2f} ms/q vs ETag-304 "
              f"revalidation {1e3 * t_304 / requeries:.2f} ms/q")
        # observability surface: /metrics must expose the request and
        # catalog latency families, behind the same bearer auth
        text = rc.metrics()
        required = ("catalog_requests_total", "catalog_request_seconds",
                    "catalog_bytes_sent_total", "catalog_etag_304_total",
                    "catalog_query_seconds", "catalog_cache_hits")
        missing = [f for f in required if f"# TYPE {f} " not in text]
        if missing:
            print(f"   FAIL: /metrics missing families: {missing}")
            return 1
        try:
            RemoteCatalog(srv.url).metrics()
        except PermissionError:
            pass
        else:
            print("   FAIL: /metrics served without a bearer token")
            return 1
        info = rc.cache_info()
        sv = info["server"]
        if sv["etag_304"] < requeries:
            print(f"   FAIL: server counted {sv['etag_304']} 304s, "
                  f"expected >= {requeries}")
            return 1
        print(f"   /metrics: {len(text.splitlines())} lines, "
              f"{len(required)} required families present")
        print(f"   {checked} arrays compared, {mismatched} mismatched; "
              f"server cache: hits={info['hits']} misses={info['misses']}; "
              f"server 304s={sv['etag_304']} "
              f"query requests={sv['requests'].get('/v1/query')}; "
              f"client etag cache: {cinfo}")
        if mismatched or not checked:
            return 1
        # progressive stream: the chunked coarse-first frames must
        # reassemble to the same bytes as the buffered response
        prog_checked = 0
        for s in steps:
            for reducer in local.reducers(s):
                ref = local.query(s, reducer)
                final = None
                for final in rc.query_progressive(s, reducer):
                    pass
                for k, a in ref.items():
                    prog_checked += 1
                    if not np.array_equal(a, final[k], equal_nan=True):
                        print(f"   FAIL: progressive mismatch "
                              f"step={s} {reducer}/{k}")
                        return 1
        print(f"   progressive streams bit-exact "
              f"({prog_checked} arrays reassembled)")
        if engine:
            # the demo objects decode in well under a millisecond —
            # faster than HTTP arrival jitter, so concurrent requests
            # would rarely overlap an in-flight read. Pace the backend
            # to a production-sized decode+merge cost so the storm
            # phases below behave deterministically: 50 ms, since on a
            # loaded host 16 barrier-released clients arrive spread over
            # more than 5 ms and then never overlap a read.
            real_query = srv.catalog.query

            def _paced_query(*a, **kw):
                time.sleep(0.05)
                return real_query(*a, **kw)
            srv.catalog.query = _paced_query
            # thundering herd: identical cold-cache queries from many
            # fresh clients must collapse onto one backend read
            srv.catalog.clear_cache()
            s0, red0 = steps[0], local.reducers(steps[0])[0]
            before = srv.engine.stats()
            herd_errs: list[Exception] = []
            bar = threading.Barrier(16)

            def _herd(i: int) -> None:
                c = RemoteCatalog(srv.url, token=token,
                                  client_id=f"herd-{i}", busy_retries=8)
                bar.wait()
                try:
                    c.query(s0, red0)
                except Exception as exc:       # noqa: BLE001 — report all
                    herd_errs.append(exc)
            ts = [threading.Thread(target=_herd, args=(i,))
                  for i in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            after = srv.engine.stats()
            coalesced = after["coalesced"] - before["coalesced"]
            reads = after["backend_reads"] - before["backend_reads"]
            if herd_errs:
                print(f"   FAIL: herd errors: {herd_errs[:3]}")
                return 1
            if coalesced <= 0:
                print(f"   FAIL: no coalescing under a 16-client herd "
                      f"(stats={after})")
                return 1
            print(f"   herd of 16 identical queries: {reads} backend "
                  f"read(s), {coalesced} coalesced")
        if load:
            rcode = _load_test(srv, token, load)
            if rcode:
                return rcode
        return 0
    finally:
        srv.close()
        local.close()
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def _load_test(srv, token: str, n_clients: int, *, rounds: int = 3) -> int:
    """Concurrent-viewer load test against a live ``CatalogServer``.

    ``n_clients`` threads run ``rounds`` cold-cache rounds. Each round
    clears the server's reduction cache and barrier-releases every
    client at once (a thundering herd), so the serving engine must
    coalesce identical queries and batch the per-client region crops.
    Clients are re-created every round with empty ETag caches — a 304
    revalidation would bypass the engine and mask the storm.

    Fails (returns 1) on any 5xx/transport error, or when the engine
    never coalesced or never batched a read. 429s are retried
    client-side and the residue is reported as throttled, not failure.
    """
    from ..insitu import CatalogBusy, RemoteCatalog
    probe = RemoteCatalog(srv.url, token=token)
    steps = probe.steps()
    work = [(s, r) for s in steps for r in probe.reducers(s)]
    regions = [None, ((0, 32), (0, 32)), ((8, 48), (8, 48)),
               ((0, 16), (16, 64))]
    before = srv.engine.stats()
    lat: list[float] = []
    errors: list[str] = []
    throttled = [0]
    lock = threading.Lock()
    bar = threading.Barrier(n_clients)

    def _client(i: int) -> None:
        rc = RemoteCatalog(srv.url, token=token,
                           client_id=f"load-{i}", busy_retries=16)
        try:
            bar.wait()
        except threading.BrokenBarrierError:
            return
        my_lat, my_thr = [], 0
        for s, reducer in work:
            t0 = time.perf_counter()
            try:
                rc.query(s, reducer, region=regions[i % len(regions)])
            except CatalogBusy:
                my_thr += 1
                continue
            except Exception as exc:           # noqa: BLE001 — 5xx/socket
                with lock:
                    errors.append(f"{type(exc).__name__}: {exc}")
                continue
            my_lat.append(time.perf_counter() - t0)
        with lock:
            lat.extend(my_lat)
            throttled[0] += my_thr

    t_start = time.perf_counter()
    for rnd in range(rounds):
        srv.catalog.clear_cache()
        bar.reset()
        ts = [threading.Thread(target=_client, args=(i,))
              for i in range(n_clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        print(f"   round {rnd + 1}/{rounds}: {len(lat)} ok so far, "
              f"{throttled[0]} throttled, {len(errors)} errors")
    elapsed = time.perf_counter() - t_start
    after = srv.engine.stats()
    d = {k: after[k] - before[k] for k in
         ("coalesced", "batched_reads", "backend_reads", "rejections",
          "cache_serves")}
    qps = len(lat) / elapsed if elapsed > 0 else 0.0
    p99 = float(np.percentile(np.asarray(lat) * 1e3, 99)) if lat else 0.0
    requests = len(lat) + throttled[0]
    ratio = requests / max(1, d["backend_reads"])
    print(f"== load test: {n_clients} clients x {rounds} rounds x "
          f"{len(work)} queries")
    print(f"   {len(lat)} ok, {throttled[0]} throttled (429 after "
          f"retries), {len(errors)} errors in {elapsed:.2f}s")
    print(f"   sustained {qps:.0f} q/s, p99 {p99:.1f} ms; engine: "
          f"{d['backend_reads']} backend reads for {requests} requests "
          f"({ratio:.1f}x), {d['coalesced']} coalesced, "
          f"{d['batched_reads']} batched, {d['rejections']} rejected, "
          f"{d['cache_serves']} cache-served")
    if errors:
        print(f"   FAIL: {len(errors)} non-429 errors, first 3: "
              f"{errors[:3]}")
        return 1
    if d["coalesced"] <= 0 or d["batched_reads"] <= 0:
        print("   FAIL: engine never coalesced/batched under load "
              f"(stats delta: {d})")
        return 1
    if not lat:
        print("   FAIL: every request was throttled")
        return 1
    return 0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=None,
                   help="in-transit HDep database directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8265,
                   help="0 binds an ephemeral port")
    p.add_argument("--cache-entries", type=int, default=64,
                   help="shared reduction-cache capacity")
    p.add_argument("--compress", action="store_true",
                   help="fpdelta-pyramid-encode large float payloads")
    p.add_argument("--token", default=None,
                   help="require 'Authorization: Bearer <token>' on every "
                        "request (default: the HX_TOKEN environment "
                        "variable; unset = no auth, localhost only)")
    p.add_argument("--serve-workers", type=int, default=4,
                   help="serving-engine backend read workers")
    p.add_argument("--max-pending", type=int, default=256,
                   help="admission-control bound on queued backend reads")
    p.add_argument("--max-connections", type=int, default=32,
                   help="HTTP connection-worker pool size")
    p.add_argument("--no-engine", action="store_true",
                   help="bypass the serving engine (no coalescing, "
                        "batching, or admission control)")
    p.add_argument("--selftest", action="store_true",
                   help="serve a demo db on an ephemeral port, verify "
                        "RemoteCatalog == local Catalog (incl. bearer "
                        "auth, ETag revalidation, coalescing, and "
                        "progressive streams), exit")
    p.add_argument("--load", type=int, default=0, metavar="N",
                   help="with --selftest: also run the load test with N "
                        "concurrent clients")
    p.add_argument("--ledger", action="store_true",
                   help="write this server's telemetry (metrics, serve "
                        "events, health) into <root>/telemetry/ as its "
                        "own ledger domain, merged at read with the "
                        "trainer's flushes")
    p.add_argument("--ledger-interval", type=float, default=5.0,
                   help="seconds between background ledger flushes")
    args = p.parse_args(argv)

    import os
    token = args.token if args.token is not None \
        else os.environ.get("HX_TOKEN") or None
    if args.selftest:
        return _selftest(args.root, args.compress, token,
                         engine=not args.no_engine,
                         serve_workers=args.serve_workers,
                         max_pending=args.max_pending,
                         max_connections=args.max_connections,
                         load=args.load)
    if args.root is None:
        p.error("--root is required (or use --selftest)")
    from ..insitu import CatalogServer
    srv = CatalogServer(args.root, host=args.host, port=args.port,
                        cache_entries=args.cache_entries,
                        compress=args.compress, token=token,
                        engine=not args.no_engine,
                        serve_workers=args.serve_workers,
                        max_pending=args.max_pending,
                        max_connections=args.max_connections)
    ledger = None
    if args.ledger:
        from ..obs import RunLedger
        ledger = RunLedger(args.root, "server",
                           interval=args.ledger_interval)
        srv.bind_ledger(ledger)
    print(f"catalog server on {srv.url} (root={args.root}, "
          f"cache={args.cache_entries} entries, "
          f"compress={args.compress}, auth={'on' if token else 'off'}, "
          f"ledger={'on' if ledger else 'off'}) "
          f"— Ctrl-C to stop")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
        if ledger is not None:
            ledger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
