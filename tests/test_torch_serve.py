"""The port's catalog serving against its contract and the reference.

``repro_torch.insitu.{serve,server}`` and ``launch/catalog_serve.py``:
single-flight coalescing, crop batching, admission control and
fairness, progressive (coarse-first) frames, the HTTP surface (ETag/304,
bearer auth, 429 + busy retries, the bounded connection pool, the
``/metrics`` families), and the cross-package contracts: ``pack_frame``
bytes equal to ``repro``'s, a reference ``RemoteCatalog`` reading a port
``CatalogServer`` and the reverse (buffered and progressive streams,
ETag revalidation across the two servers), each equal to both packages'
``Catalog.query``; and the ``catalog_serve`` selftest as a user runs it.
"""
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import repro.insitu as ref_insitu
import repro.insitu.server as ref_server
import repro_torch.insitu as pt_insitu
from repro_torch.hercule import api
from repro_torch.hercule.database import HerculeDB
from repro_torch.insitu import (Catalog, CatalogBusy, CatalogServer,
                                InTransitEngine, LevelHistogramReducer,
                                LODCutReducer, ProgressiveAssembler,
                                ProjectionReducer, RemoteCatalog,
                                ServeEngine, ServeOverloaded, SliceReducer,
                                plan_progressive)
from repro_torch.insitu.server import pack_frame, unpack_frame
from repro_torch.sim import amrgen, fields

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# --------------------------------------------------------------- fakes

class FakeCatalog:
    """In-memory catalog double: countable, pace-able backend reads."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.reads = []
        self._lock = threading.Lock()
        self._cached = set()

    def peek(self, step, reducer, domain=None):
        return (step, reducer, domain) in self._cached

    def query(self, step, reducer, *, domain=None):
        if self.delay:
            time.sleep(self.delay)
        with self._lock:
            self.reads.append((step, reducer, domain))
        arr = np.arange(64 * 64, dtype=np.float64).reshape(64, 64) + step
        arr.flags.writeable = False
        return {"image": arr}


def _storm(n, call):
    """Barrier-release ``n`` threads through ``call(i)``; collect."""
    results, errors = [None] * n, [None] * n
    bar = threading.Barrier(n)

    def run(i):
        bar.wait(timeout=30)
        try:
            results[i] = call(i)
        except Exception as exc:              # noqa: BLE001 — assert later
            errors[i] = exc

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts), "storm threads hung"
    return results, errors


# ------------------------------------------------------- single flight

def test_thundering_herd_single_read():
    fake = FakeCatalog(delay=0.05)
    eng = ServeEngine(fake, workers=2, max_pending=64)
    try:
        res, errs = _storm(24, lambda i: eng.fetch(1, "slice"))
        assert not any(errs)
        assert len(fake.reads) == 1          # one decode+merge for 24
        ref = res[0]["image"]
        for r in res[1:]:                    # byte-identical responses
            assert r["image"].tobytes() == ref.tobytes()
        st = eng.stats()
        assert st["coalesced"] == 23
        assert st["backend_reads"] == 1
    finally:
        eng.close()


def test_batched_region_crops_one_read():
    fake = FakeCatalog(delay=0.05)
    eng = ServeEngine(fake, workers=2, max_pending=64)
    regions = [None, ((0, 16), (0, 16)), ((8, 24), (8, 24)),
               ((0, 32), (32, 64))]
    try:
        res, errs = _storm(
            16, lambda i: eng.fetch(1, "slice", region=regions[i % 4],
                                    client=f"c{i}"))
        assert not any(errs)
        assert len(fake.reads) == 1          # all crops share the read
        full = fake.query(1, "slice")["image"]
        for i, r in enumerate(res):
            reg = regions[i % 4]
            want = full if reg is None else \
                full[tuple(slice(lo, hi) for lo, hi in reg)]
            np.testing.assert_array_equal(r["image"], want)
        assert eng.stats()["batched_reads"] >= 1
    finally:
        eng.close()


def test_distinct_keys_not_coalesced():
    fake = FakeCatalog(delay=0.01)
    eng = ServeEngine(fake, workers=4, max_pending=64)
    try:
        res, errs = _storm(8, lambda i: eng.fetch(i, "slice"))
        assert not any(errs)
        assert len(fake.reads) == 8          # 8 distinct steps
        for i, r in enumerate(res):
            assert r["image"][0, 0] == float(i)
    finally:
        eng.close()


# --------------------------------------------------- admission control

def test_admission_rejects_with_retry_after():
    fake = FakeCatalog(delay=0.2)
    eng = ServeEngine(fake, workers=1, max_pending=1)
    try:
        t0 = threading.Thread(target=lambda: eng.fetch(1, "slice"))
        t0.start()
        time.sleep(0.05)                     # step 1 occupies the worker
        with pytest.raises(ServeOverloaded) as ei:
            # a distinct key cannot coalesce and must be rejected:
            # pending is already at max_pending
            eng.fetch(2, "slice")
        assert ei.value.retry_after > 0
        t0.join(timeout=30)
        assert eng.stats()["rejections"] == 1
    finally:
        eng.close()


def test_backpressure_shrinks_capacity():
    fake = FakeCatalog()
    eng = ServeEngine(fake, workers=1, max_pending=100,
                      pressure_fn=lambda: 1.0)
    other = ServeEngine(fake)
    try:
        # full staging pressure collapses admission to the ~10% floor
        assert 1 <= eng.capacity() <= 10
        assert eng.retry_after() > other.retry_after()
    finally:
        eng.close()
        other.close()


def test_cache_hit_bypasses_admission():
    fake = FakeCatalog(delay=0.2)
    fake._cached.add((7, "slice", None))
    eng = ServeEngine(fake, workers=1, max_pending=1,
                      pressure_fn=lambda: 1.0)
    try:
        t0 = threading.Thread(target=lambda: eng.fetch(1, "slice"))
        t0.start()
        time.sleep(0.05)
        # the queue is saturated, but step 7 is already cached: it must
        # be served inline, not 429'd
        out = eng.fetch(7, "slice")
        assert out["image"][0, 0] == 7.0
        t0.join(timeout=30)
        assert eng.stats()["cache_serves"] == 1
        assert eng.stats()["rejections"] == 0
    finally:
        eng.close()


def test_fairness_round_robin_across_clients():
    fake = FakeCatalog(delay=0.05)
    eng = ServeEngine(fake, workers=1, max_pending=64)
    done = {}
    lock = threading.Lock()

    def fetch(step, client):
        eng.fetch(step, "slice", client=client)
        with lock:
            done[(client, step)] = time.perf_counter()

    try:
        # client A floods the single worker with 6 distinct keys...
        blocker = threading.Thread(target=fetch, args=(0, "A"))
        blocker.start()
        time.sleep(0.02)                     # A's first read is running
        flood = [threading.Thread(target=fetch, args=(s, "A"))
                 for s in range(1, 6)]
        for t in flood:
            t.start()
        time.sleep(0.02)                     # A's queue is now deep
        b = threading.Thread(target=fetch, args=(100, "B"))
        b.start()
        for t in [blocker, *flood, b]:
            t.join(timeout=30)
        # ...yet B's single request is served round-robin: before A's
        # queue tail, not after it
        b_done = done[("B", 100)]
        a_after_b = [s for s in range(1, 6) if done[("A", s)] > b_done]
        assert a_after_b, "client B waited behind client A's whole backlog"
    finally:
        eng.close()


def test_close_fails_queued_flights():
    fake = FakeCatalog(delay=0.2)
    eng = ServeEngine(fake, workers=1, max_pending=32)
    errs = []

    def go(step):
        try:
            eng.fetch(step, "slice")
        except RuntimeError as exc:
            errs.append(exc)

    ts = [threading.Thread(target=go, args=(s,)) for s in range(4)]
    for t in ts:
        t.start()
    time.sleep(0.05)
    eng.close()
    for t in ts:
        t.join(timeout=30)
    # whatever had not completed was failed fast, not left hanging
    assert len(errs) + len(fake.reads) >= 4


# ---------------------------------------------------------- progressive

def _progressive_arrays():
    rng = np.random.default_rng(7)
    return {
        "image": np.cumsum(rng.standard_normal((96, 96)), axis=1),
        "field32": np.cumsum(rng.standard_normal(9000)).astype(np.float32),
        "counts": np.arange(500, dtype=np.int64),    # ints: frame 0 only
        "tiny": np.ones(16),                          # below min_size
    }


def test_progressive_plan_and_reassembly_bitexact():
    arrays = _progressive_arrays()
    frames = plan_progressive(arrays)
    assert len(frames) > 1
    assert "counts" in frames[0] and "tiny" in frames[0]
    assert "image@root" in frames[0]
    asm = ProgressiveAssembler()
    errs = []
    for fr in frames:
        cur = asm.feed(unpack_frame(pack_frame(fr)))
        errs.append(float(np.abs(cur["image"] - arrays["image"]).max()))
    assert asm.done
    # refinement is monotone: every chunk tightens the preview
    assert errs == sorted(errs, reverse=True)
    assert errs[-1] == 0.0
    final = asm.result()
    for name, arr in arrays.items():
        assert final[name].dtype == arr.dtype
        np.testing.assert_array_equal(final[name], arr)


def test_progressive_small_arrays_single_frame():
    frames = plan_progressive({"v": np.arange(10, dtype=np.float64)})
    assert len(frames) == 1                  # nothing worth refining
    asm = ProgressiveAssembler()
    asm.feed(unpack_frame(pack_frame(frames[0])))
    assert asm.done
    np.testing.assert_array_equal(asm.result()["v"], np.arange(10.0))


# ----------------------------------------------------- HTTP integration

def _sedov_tree(max_level=4):
    t = amrgen.generate_tree(fields.sedov(), min_level=2,
                             max_level=max_level, threshold=1.2)
    t.validate()
    return t


@pytest.fixture(scope="module")
def served_db(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve") / "db")
    eng = InTransitEngine(root, [
        SliceReducer(field="density", axis=2, position=0.5,
                     resolution=64),
        ProjectionReducer(field="density", axis=2, resolution=64),
        LevelHistogramReducer(field="density", bins=16, lo=0.0, hi=8.0),
    ], domains=2).start()
    assert eng.submit(1, _sedov_tree())
    eng.close()
    return root


class SlowCatalog:
    """Duck-typed pass-through catalog with paced, counted reads."""

    def __init__(self, inner, delay=0.05):
        self._inner = inner
        self.delay = delay
        self.backend_reads = 0
        self._count_lock = threading.Lock()

    def query(self, *a, **kw):
        time.sleep(self.delay)
        with self._count_lock:
            self.backend_reads += 1
        return self._inner.query(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_http_storm_coalesces_with_etag_interplay(served_db):
    slow = SlowCatalog(Catalog(served_db), delay=0.05)
    srv = CatalogServer(slow, port=0).start()
    try:
        name = RemoteCatalog(srv.url).reducers(1)[0]
        slow._inner.clear_cache()
        reads0 = slow.backend_reads

        def one(i):
            return RemoteCatalog(srv.url, client_id=f"c{i}").query(1, name)

        res, errs = _storm(16, one)
        assert not any(errs)
        # exactly one flight read the backend; a late-arriving client
        # may additionally be served inline from the warm cache
        assert srv.engine.stats()["backend_reads"] == 1
        assert slow.backend_reads - reads0 >= 1
        ref = {k: v.tobytes() for k, v in res[0].items()}
        for r in res[1:]:
            assert {k: v.tobytes() for k, v in r.items()} == ref
        assert srv.engine.stats()["coalesced"] > 0
        # a client that already holds the ETag revalidates with a 304
        # that never touches the serving queue
        rc = RemoteCatalog(srv.url)
        rc.query(1, name)
        reads1, inflight1 = slow.backend_reads, srv.engine.stats()
        rc.query(1, name)                    # -> 304
        assert rc.client_cache_info()["etag_hits"] == 1
        assert slow.backend_reads == reads1
        assert srv.engine.stats()["backend_reads"] == \
            inflight1["backend_reads"]
    finally:
        srv.close()
        slow._inner.close()


def test_http_429_and_busy_retries(served_db):
    slow = SlowCatalog(Catalog(served_db), delay=0.3)
    srv = CatalogServer(slow, port=0, serve_workers=1, max_pending=1)
    srv.start()
    try:
        names = RemoteCatalog(srv.url).reducers(1)
        slow._inner.clear_cache()
        t0 = threading.Thread(
            target=lambda: RemoteCatalog(srv.url).query(1, names[0]))
        t0.start()
        time.sleep(0.1)                      # names[0] holds the worker
        with pytest.raises(CatalogBusy) as ei:
            RemoteCatalog(srv.url).query(1, names[1])
        assert ei.value.retry_after > 0
        # with retries enabled the same request eventually lands
        out = RemoteCatalog(srv.url, busy_retries=20).query(1, names[1])
        assert out
        t0.join(timeout=30)
        assert srv.engine.stats()["rejections"] >= 1
        assert srv.telemetry()["serve"]["rejections"] >= 1
    finally:
        srv.close()
        slow._inner.close()


def test_http_progressive_stream_matches_buffered(served_db):
    srv = CatalogServer(served_db, port=0, compress=True).start()
    try:
        rc = RemoteCatalog(srv.url)
        for name in rc.reducers(1):
            buffered = RemoteCatalog(srv.url).query(1, name)
            stages = list(rc.query_progressive(1, name))
            final = stages[-1]
            for k, v in buffered.items():
                assert final[k].dtype == v.dtype
                np.testing.assert_array_equal(final[k], v)
    finally:
        srv.close()


def test_bounded_connection_pool(served_db):
    srv = CatalogServer(served_db, port=0, max_connections=2).start()
    try:
        name = RemoteCatalog(srv.url).reducers(1)[0]

        def one(i):
            return RemoteCatalog(srv.url, client_id=f"p{i}").query(1, name)

        # 12 concurrent connections through a 2-worker pool: all are
        # served (queued, not dropped), and saturation is observable
        res, errs = _storm(12, one)
        assert not any(errs)
        assert all(r is not None for r in res)
        text = srv.obs.render_prometheus()
        assert "server_conn_pool_size 2" in text
        assert "# TYPE server_conn_saturation_total counter" in text
    finally:
        srv.close()


# ------------------------------------- round trip, auth, ETag (lanes)

def _lane_reducers(res=48):
    # fixed histogram bounds: auto bounds cannot merge across domains
    return [LODCutReducer(max_level=3),
            SliceReducer(field="density", axis=2, position=0.5,
                         resolution=res),
            ProjectionReducer(field="density", axis=2, resolution=res),
            LevelHistogramReducer(field="density", bins=16, lo=0.0, hi=8.0)]


@pytest.fixture(scope="module")
def lane_db(tmp_path_factory):
    """A 2-domain, 3-step run of the port's host engine."""
    root = str(tmp_path_factory.mktemp("lanes") / "db")
    tree = _sedov_tree(max_level=5)
    eng = InTransitEngine(root, _lane_reducers(), domains=2).start()
    for s in (1, 2, 3):
        assert eng.submit(s, tree)
    eng.close()
    return root


def test_remote_catalog_round_trip(lane_db):
    """RemoteCatalog over a live ephemeral-port server returns arrays
    equal to the local merge-at-read for a 2-domain run."""
    local = Catalog(lane_db)
    srv = CatalogServer(local, port=0).start()
    try:
        rc = RemoteCatalog(srv.url)
        assert rc.steps() == local.steps() == [1, 2, 3]
        assert rc.latest_step() == 3
        assert rc.reducers(3) == local.reducers(3)
        assert rc.attrs(3)["insitu"]["domains"] == [0, 1]
        for reducer in rc.reducers(3):
            assert rc.domains(3, reducer) == local.domains(3, reducer)
            remote = rc.query(3, reducer)        # server-side merge
            ref = local.query(3, reducer)
            assert set(remote) == set(ref)
            for k, v in ref.items():
                assert remote[k].dtype == v.dtype
                assert np.array_equal(v, remote[k], equal_nan=True), \
                    (reducer, k)
            one = rc.query(3, reducer, domain=1)  # concrete domain part
            for k, v in local.query(3, reducer, domain=1).items():
                assert np.array_equal(v, one[k], equal_nan=True)
        # region crops are applied server-side on the cached object
        slicer = next(r for r in rc.reducers(3) if r.startswith("slice"))
        win = rc.query(3, slicer, region=((8, 24), (4, 20)))["image"]
        np.testing.assert_array_equal(
            win, local.query(3, slicer)["image"][8:24, 4:20])
        # series mirrors Catalog.series (steps + per-step arrays)
        st, vals = rc.series(slicer, "image")
        lst, lvals = local.series(slicer, "image")
        np.testing.assert_array_equal(st, lst)
        assert all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(vals, lvals))
        # many viewers, one cache: a repeated query revalidates
        # client-side (304, zero payload)...
        before_etag = rc.client_cache_info()["etag_hits"]
        rc.query(3, slicer)
        assert rc.client_cache_info()["etag_hits"] > before_etag
        # ...while a fresh viewer still shares the server's LRU cache
        before = rc.cache_info()
        RemoteCatalog(srv.url).query(3, slicer)
        assert rc.cache_info()["hits"] > before["hits"]
        # a missing object raises KeyError exactly like the local catalog
        with pytest.raises(KeyError):
            rc.query(3, "absent-reducer")
        with pytest.raises(KeyError):
            rc.reducers(99)
    finally:
        srv.close()
        local.close()


def test_server_bearer_token_auth(lane_db):
    """Requests without the exact bearer token get 401
    (PermissionError client-side); the right token is served."""
    srv = CatalogServer(lane_db, port=0, token="s3cret").start()
    try:
        with pytest.raises(PermissionError):
            RemoteCatalog(srv.url).steps()
        with pytest.raises(PermissionError):
            RemoteCatalog(srv.url, token="wrong").steps()
        rc = RemoteCatalog(srv.url, token="s3cret")
        assert rc.steps() == [1, 2, 3]
        assert rc.query(1, _lane_reducers()[2].name)["image"].shape == \
            (48, 48)
    finally:
        srv.close()


def test_remote_catalog_etag_cache(lane_db):
    """A repeated query revalidates via If-None-Match, gets a 304, and
    serves the cached arrays."""
    srv = CatalogServer(lane_db, port=0).start()
    try:
        rc = RemoteCatalog(srv.url)
        name = _lane_reducers()[2].name
        first = rc.query(1, name)
        assert rc.client_cache_info() == {"entries": 1, "etag_hits": 0,
                                          "etag_misses": 1}
        again = rc.query(1, name)
        info = rc.client_cache_info()
        assert info["etag_hits"] == 1 and info["etag_misses"] == 1
        np.testing.assert_array_equal(first["image"], again["image"])
        with pytest.raises(ValueError):      # frozen like the local's
            again["image"][0, 0] = 1.0
        # distinct (region/domain) keys are separate cache entries
        crop = rc.query(1, name, region=((0, 8), (0, 8)))
        assert crop["image"].shape == (8, 8)
        dom = rc.query(1, name, domain=0)
        assert rc.client_cache_info()["entries"] == 3
        np.testing.assert_array_equal(crop["image"], first["image"][:8, :8])
        fresh = RemoteCatalog(srv.url).query(1, name, domain=0)
        np.testing.assert_array_equal(dom["image"], fresh["image"])
    finally:
        srv.close()


def test_etag_rotates_and_cache_invalidates_on_context_rewrite(tmp_path):
    """A rewritten context must rotate the ETag AND drop the server's
    cached bytes."""
    root = str(tmp_path / "db")
    db = HerculeDB.create(root, kind="hdep", ncf=1)
    attrs = {"insitu": {"reducers": ["red"], "merge": {}, "n_domains": 1,
                        "domains": [0]}}
    ctx = db.begin_context(1)
    api.write_object(ctx, "reduced", 0, {"x": np.zeros(8)}, reducer="red")
    ctx.finalize(attrs=attrs)
    srv = CatalogServer(root, port=0).start()
    try:
        rc = RemoteCatalog(srv.url)
        np.testing.assert_array_equal(rc.query(1, "red")["x"], np.zeros(8))
        time.sleep(0.01)          # a distinct mtime_ns
        ctx = db.begin_context(1)
        api.write_object(ctx, "reduced", 0, {"x": np.ones(8)},
                         reducer="red")
        ctx.finalize(attrs=attrs)
        # revalidation must MISS (rotated tag) and serve the new bytes
        np.testing.assert_array_equal(rc.query(1, "red")["x"], np.ones(8))
        assert rc.client_cache_info()["etag_misses"] == 2
        np.testing.assert_array_equal(rc.query(1, "red")["x"], np.ones(8))
        assert rc.client_cache_info()["etag_hits"] == 1
    finally:
        srv.close()
        db.close()


# ------------------------------------------------------- server metrics

def test_server_metrics_and_stats(served_db):
    srv = CatalogServer(served_db, port=0, token="t0k").start()
    try:
        rc = RemoteCatalog(srv.url, token="t0k")
        name = rc.reducers(1)[0]
        rc.query(1, name)
        rc.query(1, name)            # ETag revalidation -> 304
        with pytest.raises(KeyError):
            rc.query(1, "absent")
        info = rc.cache_info()
        assert {"entries", "hits", "misses", "io_reads",
                "timing", "server"} <= set(info)
        assert info["timing"]["query_miss"]["count"] >= 1
        sv = info["server"]
        assert sv["etag_304"] == 1
        q = sv["requests"]["/v1/query"]
        assert q["200"] == 1 and q["304"] == 1 and q["404"] == 1
        assert sv["request_seconds"]["/v1/query"]["count"] == 3
        assert sv["bytes_sent"]["/v1/query"] > 0
        text = rc.metrics()
        for fam in ("catalog_requests_total", "catalog_request_seconds",
                    "catalog_bytes_sent_total", "catalog_etag_304_total",
                    "catalog_cache_hits", "catalog_query_seconds"):
            assert f"# TYPE {fam} " in text, fam
        inf = re.search(r'catalog_request_seconds_bucket\{endpoint='
                        r'"/v1/query",le="\+Inf"\} (\d+)', text)
        cnt = re.search(r'catalog_request_seconds_count\{endpoint='
                        r'"/v1/query"\} (\d+)', text)
        assert inf.group(1) == cnt.group(1) == "3"
        with pytest.raises(PermissionError):    # /metrics behind auth
            RemoteCatalog(srv.url).metrics()
        with pytest.raises(KeyError):
            rc._get("/v1/bogus")
        assert "other" in rc.cache_info()["server"]["requests"]
    finally:
        srv.close()


def test_server_counts_a_request_before_its_response_completes(
        served_db, monkeypatch):
    """A request's metrics land before its response is complete on the
    wire: the client's next request (a new connection, so another
    worker) counts it even when the first worker is slow to finish."""
    srv = CatalogServer(served_db, port=0).start()
    handler = srv.httpd.RequestHandlerClass
    send = handler._send

    def slow_send(self, *args, **kw):
        send(self, *args, **kw)
        time.sleep(0.3)      # the worker loses the CPU after its write

    monkeypatch.setattr(handler, "_send", slow_send)
    try:
        rc = RemoteCatalog(srv.url)
        rc.query(1, rc.reducers(1)[0])
        q = rc.cache_info()["server"]["requests"]
        assert q["/v1/reducers"] == {"200": 1}
        assert q["/v1/query"] == {"200": 1}
    finally:
        srv.close()


# --------------------------------------------------- across the packages

def _cross_reducers(mod, res):
    return [mod.SliceReducer(field="density", axis=2, position=0.5,
                             resolution=res),
            mod.ProjectionReducer(field="density", axis=2, resolution=res),
            mod.LevelHistogramReducer(field="density", bins=16, lo=0.0,
                                      hi=8.0),
            mod.LODCutReducer(max_level=3)]


@pytest.fixture(scope="module")
def device_db(tmp_path_factory):
    """What the device path reduced (its CPU twins): Sedov, 2 domains,
    R = 32, two steps, one seed."""
    root = str(tmp_path_factory.mktemp("cross") / "db")
    rng = np.random.default_rng(19)
    eng = InTransitEngine(root, _cross_reducers(pt_insitu, 32),
                          domains=2, policy="block", device_reduce=True,
                          device="cpu").start()
    for s in (1, 2):
        tree = amrgen.generate_tree(
            fields.sedov(r_shock=0.15 + 0.1 * rng.random()), min_level=2,
            max_level=5, threshold=1.1)
        assert eng.submit(s, tree.to_arrays())
    eng.close()
    assert eng.device_stats["fallback_snapshots"] == 0
    return root


PACKAGES = {"ref": ref_insitu, "port": pt_insitu}


def _assert_same(got: dict, want: dict, label):
    assert set(got) == set(want), label
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (label, k)
        assert got[k].shape == v.shape, (label, k)
        assert np.array_equal(got[k], v, equal_nan=True), (label, k)


@pytest.mark.parametrize("server,client", [("port", "ref"), ("ref", "port")])
def test_remote_catalog_across_packages(device_db, server, client):
    """A client of one package on a server of the other: buffered and
    progressive queries of every reducer, step and domain are equal to
    both packages' ``Catalog.query`` of the same database."""
    srv_mod, cli_mod = PACKAGES[server], PACKAGES[client]
    srv = srv_mod.CatalogServer(device_db, port=0, compress=True).start()
    cats = [PACKAGES[p].Catalog(device_db) for p in ("ref", "port")]
    try:
        rc = cli_mod.RemoteCatalog(srv.url, timeout=30.0)
        assert rc.steps() == cats[0].steps() == cats[1].steps() == [1, 2]
        n = 0
        for s in rc.steps():
            assert rc.reducers(s) == cats[1].reducers(s)
            for r in rc.reducers(s):
                for d in (None, 0, 1):
                    want = [c.query(s, r, domain=d) for c in cats]
                    _assert_same(want[1], want[0], (s, r, d))
                    got = rc.query(s, r, domain=d)
                    _assert_same(got, want[0], (s, r, d))
                    n += 1
                final = None
                for final in rc.query_progressive(s, r):
                    pass
                _assert_same(final, cats[0].query(s, r), (s, r, "prog"))
        assert n == 2 * 4 * 3
        # a revalidation from this client is answered 304 by the other
        # package's server: the ETag formula is the same
        name = cats[0].reducers(2)[0]
        rc.query(2, name)
        hits = rc.client_cache_info()["etag_hits"]
        rc.query(2, name)
        assert rc.client_cache_info()["etag_hits"] == hits + 1
    finally:
        srv.close()
        for c in cats:
            c.close()


def test_etags_equal_across_servers(device_db):
    """The two servers tag every query alike, so a tag from one
    revalidates (304) against the other over the same database."""
    srvs = [PACKAGES[p].CatalogServer(device_db, port=0).start()
            for p in ("ref", "port")]
    try:
        cat = Catalog(device_db)
        reducers = cat.reducers(1)
        cat.close()
        for r in reducers:
            for extra in ("", "&domain=1", "&region=0:8,0:8"):
                path = f"/v1/query?step=1&reducer={r}{extra}"
                if "region" in extra and r.startswith(("hist", "lod")):
                    continue
                tags = []
                for srv in srvs:
                    with urllib.request.urlopen(srv.url + path,
                                                timeout=30) as resp:
                        tags.append(resp.headers["ETag"])
                assert tags[0] == tags[1] and tags[0], (r, extra)
                req = urllib.request.Request(
                    srvs[1].url + path, headers={"If-None-Match": tags[0]})
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req, timeout=30)
                assert ei.value.code == 304
    finally:
        for srv in srvs:
            srv.close()


@pytest.mark.parametrize("compress", [False, True])
def test_pack_frame_bytes_equal_across_packages(device_db, compress):
    """hx-frame/1 bytes (header JSON and codec payloads) of the port are
    the reference's, buffered and for every progressive frame."""
    cat = Catalog(device_db)
    try:
        objs = [cat.query(s, r) for s in cat.steps()
                for r in cat.reducers(s)]
    finally:
        cat.close()
    objs.append(_progressive_arrays())
    for arrays in objs:
        port = pack_frame(arrays, compress=compress)
        assert port == ref_server.pack_frame(arrays, compress=compress)
        back = ref_server.unpack_frame(port)
        _assert_same(back, {k: np.asarray(v) for k, v in arrays.items()},
                     "frame")
        frames_pt = plan_progressive(arrays)
        frames_ref = ref_server.plan_progressive(arrays)
        assert len(frames_pt) == len(frames_ref)
        for a, b in zip(frames_pt, frames_ref):
            assert pack_frame(a) == ref_server.pack_frame(b)


# ----------------------------------------------------------------- CLI

@pytest.mark.parametrize("extra", [[], ["--load", "8"]])
def test_catalog_serve_selftest_cli(extra):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.catalog_serve",
         "--selftest", *extra], capture_output=True, text=True, env=env,
        timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 mismatched" in out.stdout
    assert "progressive streams bit-exact" in out.stdout
    if extra:
        assert "== load test: 8 clients" in out.stdout
        assert "0 errors" in out.stdout
