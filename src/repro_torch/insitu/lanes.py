"""Pluggable lane runtime: how contributor-group lanes actually execute.

The engine (``insitu/engine.py``) owns the *what*: cadence, partitioning,
the per-step part countdown and manifest finalize. A :class:`LaneBackend`
owns the *how*: the staging transport and the execution context in which
each group's lane drains its staging area, runs the reducer DAG and
lands its Hercule domain.

Two backends register here:

  * ``thread``  — PR-3 semantics, bit for bit: one ``StagingArea`` and
    ``workers`` daemon threads per group, reducing and writing in the
    engine's process through the shared ``ContextWriter``.
  * ``process`` — the paper's per-producer shape with real OS processes:
    each group's lane is a spawned process fed through a
    :class:`~repro_torch.insitu.staging.ShmStagingArea` (shared-memory slabs,
    pickle-free descriptor headers), so reduction *and* the Hercule
    domain writes run fully outside the producer's GIL. Lanes append to
    their own group files (``DomainWriter``) and report the record index
    over a small results queue; the engine commits one manifest per
    step and fsyncs exactly the referenced data files first.

``register_backend`` makes the runtime pluggable — a future MPI or RPC
lane transport slots in without touching the engine.
"""
from __future__ import annotations

import functools
import hashlib
import multiprocessing
import pickle
import queue
import threading
import traceback

from ..hercule import api
from ..hercule.database import DomainWriter, HerculeDB, Record
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs.trace import TRACER, Tracer, now_us
from .reducers import ReducerDAG
from .staging import ShmStagingArea, StagingArea, _CrashSafeCondition

BACKENDS: dict[str, type] = {}


def register_backend(name: str, cls: type) -> type:
    """Register (or replace) a lane backend under ``name``."""
    BACKENDS[name] = cls
    return cls


def make_backend(name: str, engine, **kw):
    if name not in BACKENDS:
        raise ValueError(f"unknown lane backend {name!r}; "
                         f"registered: {sorted(BACKENDS)}")
    return BACKENDS[name](engine, **kw)


class LaneBackend:
    """One lane-execution strategy; constructed by and bound to an engine.

    Contract: expose ``stages`` (one push-capable area per contributor
    group, wired to the engine's ``on_evict``), run each accepted part
    through the reducer DAG exactly once, settle it via the engine's
    ``_part_done``/record paths, and surface failures on
    ``engine._errors``. ``stop()`` must not return while a lane could
    still be writing.
    """

    name = ""

    def __init__(self, engine):
        self.engine = engine
        self.stages: list = []

    def start(self) -> None:
        raise NotImplementedError

    def stop(self, timeout: float = 30.0) -> None:
        """Close staging, stop lanes, reclaim transport resources."""
        raise NotImplementedError

    def pre_finalize(self, pend) -> None:
        """Durability hook before a context manifest commits."""

    def telemetry(self) -> dict:
        """Backend-specific counters for ``InTransitEngine.telemetry``."""
        return {}


def reducer_fingerprint(reducers) -> str:
    """Stable id of a reducer configuration (type + pickled state).

    Keys the lane-side DAG cache of the persistent pool: two borrows
    with identical reducer configs hash equal, so the resident lane
    reuses its rebuilt :class:`ReducerDAG` instead of re-unpickling
    and re-validating per borrow.
    """
    payload = pickle.dumps([
        (type(r).__module__, type(r).__qualname__, vars(r))
        for r in reducers])
    return hashlib.sha1(payload).hexdigest()


class ThreadLaneBackend(LaneBackend):
    """In-process worker threads (the original engine execution model).

    With ``engine.device_reduce=True`` the staging areas are
    :class:`~repro_torch.insitu.device.DeviceStagingArea` — snapshots stay on
    the accelerator and lanes run the DAG through the engine's
    :class:`~repro_torch.insitu.device.DeviceDAGRunner`; everything else
    (queue bounds, policies, eviction countdown) is identical.
    """

    name = "thread"

    def __init__(self, engine, *, workers: int, queue_capacity: int,
                 policy: str, lane_pool: bool = False):
        super().__init__(engine)
        del lane_pool   # validated engine-side: process-lane concern
        area_cls = StagingArea
        if engine.device_reduce is True:
            # mesh reduction stages on the host: the runner re-shards
            # each snapshot's leaf table over the devices itself, so a
            # single device-resident copy would only add a hop
            from .device import DeviceStagingArea
            area_cls = functools.partial(DeviceStagingArea,
                                         device=engine.device)
        self.stages = [
            area_cls(capacity=queue_capacity, policy=policy,
                     n_buffers=queue_capacity + max(1, workers) + 1,
                     on_evict=engine._on_evict)
            for _ in range(engine.n_domains)]
        self._threads = [
            threading.Thread(target=self._worker, args=(area,),
                             name=f"insitu-g{g}-{i}", daemon=True)
            for g, area in enumerate(self.stages)
            for i in range(max(1, workers))]

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def _worker(self, area: StagingArea):
        eng = self.engine
        while True:
            t0 = now_us() if TRACER.enabled else 0.0
            snap = area.pop(timeout=0.25)
            if snap is None:
                eng._run_deferred()
                eng._sweep_ttl()
                if area.closed and len(area) == 0:
                    return
                continue
            tctx = snap.meta.get("_trace")
            if tctx is not None:
                # dequeue latency: staged -> picked up by this lane
                TRACER.record("stage.pop", t0, now_us(), parent=tctx,
                              args={"step": snap.step,
                                    "group": snap.domain})
            try:
                eng._reduce_and_write(snap)
            except BaseException as e:   # surfaced on next submit/drain
                eng._errors.append(e)
                with eng._wlock:
                    eng._failed += 1
                eng._part_done(snap.step, None, None)
            finally:
                area.release(snap)
            eng._run_deferred()

    def stop(self, timeout: float = 30.0) -> None:
        for area in self.stages:
            area.close()
        for t in self._threads:
            if t.ident is not None:      # skip never-started lanes
                t.join(timeout=timeout)
        if any(t.is_alive() for t in self._threads):
            # never close the db under a still-writing worker — a
            # leaked daemon thread beats a corrupted context
            raise TimeoutError(
                "in-transit workers did not stop; database left open")

    def telemetry(self) -> dict:
        return {"kind": "thread", "n_lanes": len(self._threads),
                "lanes_alive": sum(t.is_alive() for t in self._threads)}


def _lane_main(handle, root: str, group: int, reducers, compress: bool,
               durable_parts: bool, results, lane_stats=None) -> None:
    """One process lane: attach shm staging, reduce, write own domain.

    Results-queue wire format (10-tuples; spans/timings/stats/events may
    be None): ``(tag, step, group, records, reducers, meta_or_tb, meta,
    spans, timings, events)`` for "done"; errors carry the traceback in
    slot 5; "exit" carries the lane's cumulative stats dict in slot 8.
    Slot 9 ships the lane's flight-recorder drain (its process-local
    event ring since the previous message — e.g. ``lane.error`` on a
    failed reduce), which the collector relays into the lane's own
    domain of the run ledger.

    ``reducers`` may be a prebuilt :class:`ReducerDAG` (pooled lanes
    pass their fingerprint-cached DAG) or a reducer list. When a popped
    snapshot's meta carries ``_trace`` (the parent's submit-span wire
    context), the lane records stage.pop/reduce/write spans against it
    and ships them home in the "done" message — cross-process parent
    linkage with no clock sync beyond the shared epoch.
    """
    area = ShmStagingArea.attach(handle)
    dag = reducers if isinstance(reducers, ReducerDAG) \
        else ReducerDAG(reducers)
    db = HerculeDB.open(root)
    tracer = Tracer(enabled=True)    # only used when _trace rides in
    # incremental drain of this process's event ring: each message home
    # carries only the events since the previous one (pooled lanes skip
    # events from earlier jobs by starting the mark at the current head)
    ev_mark = obs_events.EVENTS.drain_since(0)[0] if lane_stats else 0

    def drain_events():
        nonlocal ev_mark
        ev_mark, evs = obs_events.EVENTS.drain_since(ev_mark)
        return evs or None

    try:
        while True:
            t_pop = now_us()
            try:
                snap = area.pop(timeout=0.25)
            except BaseException:
                # a transport failure is fatal for the lane: report it
                # (a bare exit would look clean to the collector while
                # this group's queued steps never settle)
                obs_events.EVENTS.emit(obs_events.LANE_ERROR, step=-1,
                                       group=group, stage="transport")
                results.put(("error", -1, group, None, None,
                             traceback.format_exc(), None, None, None,
                             drain_events()))
                return
            if snap is None:
                if area.closed and len(area) == 0:
                    return
                continue
            tctx = snap.meta.get("_trace")
            try:
                r0 = now_us()
                outputs = dag.run(snap)
                r1 = now_us()
                if not outputs:
                    results.put(("skipped", snap.step, group, None, None,
                                 None, None, None, None, drain_events()))
                else:
                    ctx = DomainWriter(db, snap.step)
                    w0 = now_us()
                    for rname, arrays in outputs.items():
                        api.write_object(ctx, "reduced", group, arrays,
                                         reducer=rname, compress=compress)
                    # publish the appended bytes: page cache always (the
                    # manifest committer fsyncs by path), disk if this
                    # lane owns its own durability
                    db.flush_domain(group, sync=durable_parts)
                    w1 = now_us()
                    spans = None
                    if tctx is not None:
                        args = {"step": snap.step, "group": group}
                        tracer.record("stage.pop", t_pop, r0,
                                      parent=tctx, args=args)
                        tracer.record("reduce", r0, r1, parent=tctx,
                                      args=args)
                        tracer.record("write", w0, w1, parent=tctx,
                                      args=args)
                        spans = tracer.spans()
                        tracer.clear()
                    results.put((
                        "done", snap.step, group,
                        [r.to_json() for r in ctx.records],
                        sorted(outputs), snap.kind, snap.meta,
                        spans, ((r1 - r0) / 1e6, (w1 - w0) / 1e6),
                        drain_events()))
            except BaseException:
                obs_events.EVENTS.emit(obs_events.LANE_ERROR,
                                       step=snap.step, group=group,
                                       stage="reduce")
                results.put(("error", snap.step, group, None, None,
                             traceback.format_exc(), None, None, None,
                             drain_events()))
            finally:
                area.release(snap)
    finally:
        db.close()
        area.detach()
        results.put(("exit", None, group, None, None, None, None, None,
                     dict(lane_stats) if lane_stats else None,
                     drain_events()))


_DAG_CACHE_MAX = 8


def _pooled_lane_main(task_q, sync, results) -> None:
    """Resident pooled lane: serve staging-attach jobs until poisoned.

    Spawn+import cost is paid once; each task re-runs :func:`_lane_main`
    against a fresh shared-memory area rebuilt from a primitive-free
    spec plus the sync objects this process inherited at spawn
    (``ShmStagingArea.handle_from_spec``). ``None`` ends the lane.

    Tasks name their reducer config by :func:`reducer_fingerprint`; the
    rebuilt :class:`ReducerDAG` is cached here keyed by that fingerprint
    so repeat borrows with the same config skip the unpickle+rebuild
    entirely — the borrower then sends ``reducers=None``. Cache hits and
    rebuilds ride home in the "exit" message (cumulative over this
    lane's lifetime) and surface as ``insitu_lane_dag_*`` metrics.
    """
    dag_cache: dict[str, ReducerDAG] = {}
    stats = {"jobs": 0, "dag_rebuilds": 0, "dag_cache_hits": 0}
    while True:
        task = task_q.get()
        if task is None:
            return
        spec, root, group, fp, reducers, compress, durable_parts = task
        dag = dag_cache.get(fp)
        if dag is None:
            if reducers is None:
                # borrower believed we had this config cached but we
                # don't (fresh lane in a recycled entry): fail the job
                # loudly and report the per-job exit the collector awaits
                results.put(("error", -1, group, None, None,
                             f"pooled lane has no cached DAG for "
                             f"fingerprint {fp} and got no reducers",
                             None, None, None, None))
                results.put(("exit", None, group, None, None, None, None,
                             None, dict(stats), None))
                continue
            while len(dag_cache) >= _DAG_CACHE_MAX:   # bound residency
                dag_cache.pop(next(iter(dag_cache)))
            dag = dag_cache[fp] = ReducerDAG(reducers)
            stats["dag_rebuilds"] += 1
        else:
            stats["dag_cache_hits"] += 1
        stats["jobs"] += 1
        handle = ShmStagingArea.handle_from_spec(spec, sync)
        _lane_main(handle, root, group, dag, compress, durable_parts,
                   results, lane_stats=stats)


class _PooledLane:
    """One resident lane process plus its spawn-inherited plumbing."""

    def __init__(self, ctx, results, index: int):
        self.task_q = ctx.Queue()
        lock = ctx.Lock()
        self.sync = (lock, _CrashSafeCondition(lock, ctx),
                     _CrashSafeCondition(lock, ctx))
        self.proc = ctx.Process(target=_pooled_lane_main,
                                args=(self.task_q, self.sync, results),
                                name=f"insitu-pool-lane{index}",
                                daemon=True)


class _PoolEntry:
    """A reusable set of ``n`` lanes sharing one results queue."""

    def __init__(self, n: int):
        self.ctx = multiprocessing.get_context("spawn")
        self.results = self.ctx.Queue()
        self.lanes = [_PooledLane(self.ctx, self.results, i)
                      for i in range(n)]
        #: reducer fingerprints every lane of this entry has cached
        #: (lanes receive the same configs in lockstep at borrow time)
        self.known_fps: set[str] = set()
        for lane in self.lanes:
            lane.proc.start()

    def alive(self) -> bool:
        return all(lane.proc.is_alive() for lane in self.lanes)

    def terminate(self) -> None:
        for lane in self.lanes:
            lane.task_q.put(None)
        for lane in self.lanes:
            lane.proc.join(timeout=5.0)
            if lane.proc.is_alive():
                lane.proc.terminate()
                lane.proc.join(timeout=5.0)
        self.results.close()
        self.results.join_thread()


class LanePool:
    """Module-level pool of resident process lanes, keyed by group count.

    ``InTransitEngine(backend="process", lane_pool=True)`` borrows a
    matching entry (spawning one on first use) and returns it at
    ``close()``, so short-lived pipelines stop paying the ~1-2 s
    spawn+import per lane per engine. Lanes that failed to drain (or
    died) are discarded, never re-pooled. Call :func:`shutdown_pool`
    (or ``LANE_POOL.shutdown()``) to reclaim the resident processes.
    """

    def __init__(self):
        self._free: dict[int, list[_PoolEntry]] = {}
        self._lock = threading.Lock()
        #: borrow/spawn/release accounting (surfaced through
        #: ``ProcessLaneBackend.telemetry`` as insitu_lane_pool_*)
        self.stats = {"borrows": 0, "spawns": 0, "releases": 0,
                      "discards": 0}

    def acquire(self, n: int) -> _PoolEntry:
        dead: list[_PoolEntry] = []
        try:
            with self._lock:
                self.stats["borrows"] += 1
                entries = self._free.get(n, [])
                while entries:
                    entry = entries.pop()
                    if entry.alive():
                        return entry
                    dead.append(entry)   # a lane died while parked
                    self.stats["discards"] += 1
                self.stats["spawns"] += 1
            return _PoolEntry(n)
        finally:
            for entry in dead:           # joins run outside the lock
                entry.terminate()

    def release(self, entry: _PoolEntry) -> None:
        if not entry.alive():
            with self._lock:
                self.stats["discards"] += 1
            entry.terminate()
            return
        with self._lock:
            self.stats["releases"] += 1
            self._free.setdefault(len(entry.lanes), []).append(entry)

    def telemetry(self) -> dict:
        with self._lock:
            parked = sum(len(v) for v in self._free.values())
            return {**self.stats, "parked_entries": parked}

    def shutdown(self) -> None:
        """Terminate every parked lane (borrowed entries die with their
        engine's ``close``-time discard)."""
        with self._lock:
            entries = [e for lst in self._free.values() for e in lst]
            self._free.clear()
        for entry in entries:
            entry.terminate()


#: the process-lane pool (ISSUE 5: amortize lane spawn across engines)
LANE_POOL = LanePool()


def shutdown_pool() -> None:
    """Reclaim every parked pooled lane process."""
    LANE_POOL.shutdown()


class ProcessLaneBackend(LaneBackend):
    """One spawned OS process per contributor group over shm staging.

    The live-pipeline version of the paper's claim: every contributor
    writes its own domain with no shared interpreter lock. Each lane
    owns its group files exclusively, which requires one Hercule group
    per domain — the engine creates its database with ``ncf=1`` for
    this backend (and refuses a database where lanes would share a
    group file).

    Crash semantics: a lane dying mid-part leaves at most orphaned
    bytes in its own group file — the step's manifest never references
    them. The death is surfaced as an engine error on the next
    ``check_errors``; steps whose parts were queued to the dead lane
    finalize through the engine's step TTL (if enabled) with the
    surviving domains.
    """

    name = "process"

    def __init__(self, engine, *, workers: int, queue_capacity: int,
                 policy: str, lane_pool: bool = False):
        super().__init__(engine)
        db = engine.db
        if engine.n_domains > 1 and db.ncf != 1:
            raise ValueError(
                f"backend='process' needs one Hercule group per domain so "
                f"each lane owns its files; database has ncf={db.ncf} "
                f"(create the engine with ncf=1)")
        self._pooled = bool(lane_pool)
        self._entry = None
        if self._pooled:
            # borrow resident lanes; their sync primitives were
            # inherited at spawn, so the fresh staging areas adopt them
            self._entry = LANE_POOL.acquire(engine.n_domains)
            ctx = self._entry.ctx
            self.stages = [
                ShmStagingArea(capacity=queue_capacity, policy=policy,
                               n_slots=queue_capacity + 2,
                               on_evict=engine._on_evict, mp_context=ctx,
                               sync=lane.sync)
                for lane in self._entry.lanes]
            self._results = self._entry.results
            self._procs = [lane.proc for lane in self._entry.lanes]
        else:
            ctx = multiprocessing.get_context("spawn")
            self.stages = [
                ShmStagingArea(capacity=queue_capacity, policy=policy,
                               n_slots=queue_capacity + 2,
                               on_evict=engine._on_evict, mp_context=ctx)
                for _ in range(engine.n_domains)]
            self._results = ctx.Queue()
            reducers = list(engine.dag)
            self._procs = [
                ctx.Process(target=_lane_main,
                            args=(area.handle(), db.root, g, reducers,
                                  engine.compress, engine.durable_parts,
                                  self._results),
                            name=f"insitu-lane-g{g}", daemon=True)
                for g, area in enumerate(self.stages)]
        self._mp = ctx
        self._collector = threading.Thread(
            target=self._collect, name="insitu-collector", daemon=True)
        self._stopping = False
        self._exited: set[int] = set()
        #: lifetime DAG-cache accounting reported by pooled lanes in
        #: their "exit" messages, summed over this backend's lanes
        self.lane_stats = {"jobs": 0, "dag_rebuilds": 0,
                           "dag_cache_hits": 0}

    def start(self) -> None:
        if self._pooled:
            engine = self.engine
            reducers = list(engine.dag)
            # satellite fix: don't re-pickle the reducers on every
            # borrow — name the config by fingerprint and send the
            # payload only when the entry's lanes haven't cached it
            fp = reducer_fingerprint(reducers)
            payload = None if fp in self._entry.known_fps else reducers
            for g, (lane, area) in enumerate(zip(self._entry.lanes,
                                                 self.stages)):
                lane.task_q.put((area.spec(), engine.db.root, g, fp,
                                 payload, engine.compress,
                                 engine.durable_parts))
            self._entry.known_fps.add(fp)
        else:
            for p in self._procs:
                p.start()
        self._collector.start()

    # ------------------------------------------------------- result intake
    def _collect(self) -> None:
        eng = self.engine
        while True:
            try:
                msg = self._results.get(timeout=0.25)
            except (ValueError, OSError):
                return   # results queue torn down under a stuck stop
            except queue.Empty:
                eng._run_deferred()
                eng._sweep_ttl()
                if len(self._exited) == len(self._procs) or \
                        (self._stopping and
                         not any(p.is_alive() for p in self._procs)):
                    return
                if not self._stopping:
                    self._check_lanes()
                continue
            tag, step, group = msg[0], msg[1], msg[2]
            if len(msg) > 9 and msg[9]:
                self._relay_events(group, msg[9])
            if tag == "exit":
                self._exited.add(group)
                if msg[8]:               # pooled lane lifetime stats
                    for k, v in msg[8].items():
                        self.lane_stats[k] = \
                            self.lane_stats.get(k, 0) + v
                if len(self._exited) == len(self._procs):
                    eng._run_deferred()
                    return
            elif tag == "done":
                recs, reducers, kind, meta, spans, timings = msg[3:9]
                if spans:                # lane spans join the parent trace
                    TRACER.ingest(spans)
                if timings is not None and obs_metrics.ENABLED:
                    eng._h_reduce.labels(group).observe(timings[0])
                    eng._h_write.labels(group).observe(timings[1])
                eng._part_records(step, group,
                                  [Record.from_json(r) for r in recs],
                                  set(reducers), kind, meta)
            elif tag == "skipped":
                with eng._wlock:
                    eng._skipped += 1
                eng._part_done(step, None, None)
            elif tag == "error":
                eng._errors.append(RuntimeError(
                    f"process lane g{group} failed at step {step}:\n"
                    f"{msg[5]}"))
                with eng._wlock:
                    eng._failed += 1
                if step < 0:
                    # fatal transport failure: the lane is exiting; stop
                    # producers from queueing (or blocking) behind it
                    self.stages[group].close()
                else:
                    eng._part_done(step, None, None)
            eng._run_deferred()

    def _relay_events(self, group: int, evs: list) -> None:
        """Land a lane's flight-recorder drain: into its own ledger
        domain when a run ledger is bound, else into the engine-process
        ring so the events at least stay live-visible."""
        led = self.engine.ledger
        if led is not None:
            from ..obs.ledger import lane_domain
            led.ingest_domain(lane_domain(group), {"events": evs})
        else:
            obs_events.EVENTS.ingest(evs)

    def _check_lanes(self) -> None:
        """Surface lanes that died without reporting (crash semantics).

        A clean exit announces itself on the results queue; only a
        nonzero exit code is a crash (a zero-exit lane may simply have
        its "exit" message still queued).
        """
        for g, p in enumerate(self._procs):
            if g not in self._exited and p.exitcode not in (None, 0):
                self._exited.add(g)
                self.engine._errors.append(RuntimeError(
                    f"process lane g{g} died (exit code {p.exitcode}) "
                    f"without draining its staging area"))
                # fail fast instead of deadlocking a block-policy
                # producer against a lane that will never pop again
                self.stages[g].close()
                # flight recorder: a SIGKILLed lane reports nothing, so
                # the engine writes the crash event on its behalf and
                # forces a durable ledger flush (the ledger's dump hook)
                # with whatever partial attribution the dead lane's
                # steps have
                obs_events.EVENTS.emit(
                    obs_events.LANE_CRASH, group=g,
                    exitcode=p.exitcode)
                obs_events.EVENTS.dump("lane.crash", group=g,
                                       exitcode=p.exitcode)

    def telemetry(self) -> dict:
        out = {"kind": "process", "pooled": self._pooled,
               "n_lanes": len(self._procs),
               "lanes_exited": len(self._exited), **self.lane_stats}
        if self._pooled:
            out.update({f"pool_{k}": v
                        for k, v in LANE_POOL.telemetry().items()})
        return out

    # ------------------------------------------------------------ control
    def pre_finalize(self, pend) -> None:
        # lanes flushed their appends to the page cache; make exactly
        # the files this manifest references durable before the commit
        if pend.ctx is not None and pend.ctx.records:
            self.engine.db.fsync_files(r.file for r in pend.ctx.records)

    def stop(self, timeout: float = 30.0) -> None:
        for area in self.stages:
            area.close()
        if self._pooled:
            self._stop_pooled(timeout)
            return
        killed = []
        for p in self._procs:
            if p.pid is None:            # never-started lane
                continue
            p.join(timeout=timeout)
            if p.is_alive():
                # a stuck lane is its own process: killing it cannot
                # corrupt the parent; its un-reported bytes stay
                # orphaned (no manifest references them)
                p.terminate()
                p.join(timeout=5.0)
                killed.append(p.name)
        self._stopping = True
        if self._collector.ident is not None:
            self._collector.join(timeout=timeout)
        for area in self.stages:
            area.unlink()
        self._results.close()
        self._results.join_thread()
        if killed:
            self.engine._errors.append(TimeoutError(
                f"process lanes {killed} did not stop; terminated "
                f"(unreported parts lost)"))

    def _stop_pooled(self, timeout: float) -> None:
        """Wind down borrowed pooled lanes: wait for their per-job 'exit'
        reports (the lane process itself stays alive), then return the
        entry to the pool — or discard it if anything looks wrong."""
        clean = True
        if self._collector.ident is not None:
            self._collector.join(timeout=timeout)
            clean = (not self._collector.is_alive()
                     and len(self._exited) == len(self._procs))
        self._stopping = True
        for area in self.stages:
            area.unlink()
        if clean and self._entry.alive():
            LANE_POOL.release(self._entry)
        else:
            self._entry.terminate()
            self.engine._errors.append(TimeoutError(
                "pooled process lanes did not finish their jobs; "
                "lanes discarded (unreported parts lost)"))


register_backend("thread", ThreadLaneBackend)
register_backend("process", ProcessLaneBackend)
