"""Writer-lane backends for the async checkpoint manager (HProt flow).

The in-transit lane shape (``insitu/lanes.py``) applied to protection
data: the manager's gather thread streams encoded shards into one
staging area per Hercule contributor group, and a *writer lane* per
group drains it — append to the group's files, publish to the page
cache, report the :class:`~repro_torch.hercule.database.Record` home. Lanes
never fsync and never commit: durability belongs to the manifest
committer (``HerculeDB.commit_context``), exactly the split the
multi-domain in-transit engine uses.

Two backends register here, mirroring the ``insitu`` registry:

  * ``thread``  — one daemon thread per group over a pooled
    :class:`~repro_torch.insitu.staging.StagingArea`; writes run in the
    training process (simple, zero extra processes, the file-write
    syscalls release the GIL).
  * ``process`` — one spawned OS process per group fed through a
    :class:`~repro_torch.insitu.staging.ShmStagingArea` (shared-memory slabs,
    pickle-free): serialization and page-cache writes leave the
    producer's GIL entirely. Payloads cross as numpy ``uint8`` (already
    encoded on the host), so a lane process never touches CUDA.

Both run ``policy="block"`` — checkpoints are lossless; backpressure
stalls the *gather thread*, never the train step (the step only waits
when the snapshot queue itself is full, i.e. a whole previous
checkpoint is still gathering).

Crash semantics: a lane dying mid-checkpoint is
detected by the collector's exitcode poll, surfaced through
``manager._lane_failed`` — which fails every in-flight step (their
records can never all land) so no manifest commits for them — and the
dead lane's staging area is closed so a blocked gather push raises
instead of deadlocking ``wait()``.

Lanes are created lazily on first push to a group: the set of groups
is a function of the state's sharding, unknown at manager construction.
"""
from __future__ import annotations

import multiprocessing
import queue
import threading
import time
import traceback

from ..hercule.database import DomainWriter, HerculeDB, Record
from ..insitu.staging import ShmStagingArea, StagingArea
from ..obs import metrics as obs_metrics
from ..obs.trace import TRACER, Tracer, now_us

CKPT_BACKENDS: dict[str, type] = {}


def register_backend(name: str, cls: type) -> type:
    """Register (or replace) a checkpoint lane backend under ``name``."""
    CKPT_BACKENDS[name] = cls
    return cls


def make_backend(name: str, manager, **kw):
    if name not in CKPT_BACKENDS:
        raise ValueError(f"unknown checkpoint lane backend {name!r}; "
                         f"registered: {sorted(CKPT_BACKENDS)}")
    return CKPT_BACKENDS[name](manager, **kw)


class CkptLaneBackend:
    """One writer-lane strategy, bound to an AsyncCheckpointManager.

    Contract: :meth:`push` stages one encoded shard payload for the
    lane owning contributor group ``group`` (blocking when that lane is
    behind); the lane appends it via :class:`DomainWriter`, publishes
    the bytes to the page cache (``flush_domain(sync=False)``) and
    reports through ``manager._shard_landed``. Failures route through
    ``manager._lane_failed`` — never silently. ``stop()`` must not
    return while a lane could still be writing.
    """

    name = ""

    def __init__(self, manager, *, queue_capacity: int = 4):
        self.manager = manager
        self.queue_capacity = max(1, int(queue_capacity))
        #: group -> staging area (lazily created with its lane)
        self.stages: dict[int, object] = {}
        self._lock = threading.Lock()

    def push(self, group: int, step: int, payload, desc: dict) -> None:
        """Stage one encoded shard (uint8 payload + record descriptor)."""
        self._area(group).push(step, {"payload": payload}, kind="ckpt",
                               meta=desc)

    def _area(self, group: int):
        raise NotImplementedError

    def stop(self, timeout: float = 30.0) -> None:
        raise NotImplementedError

    def telemetry(self) -> dict:
        return {}


def _write_shard(db: HerculeDB, snap) -> list[Record]:
    """Append one staged shard to its group files; returns its records."""
    d = snap.meta
    w = DomainWriter(db, snap.step)
    w.write_bytes(int(d["domain"]), d["rec_name"],
                  bytes(snap.arrays["payload"]),
                  dtype=d["dtype"], shape=tuple(d["shape"]),
                  codec=d["codec"], meta=d["rec_meta"])
    db.flush_domain(int(d["domain"]), sync=False)
    return w.records


class ThreadCkptLanes(CkptLaneBackend):
    """One in-process writer thread per contributor group."""

    name = "thread"

    def __init__(self, manager, *, queue_capacity: int = 4):
        super().__init__(manager, queue_capacity=queue_capacity)
        self._threads: dict[int, threading.Thread] = {}

    def _area(self, group: int):
        with self._lock:
            area = self.stages.get(group)
            if area is None:
                area = StagingArea(capacity=self.queue_capacity,
                                   policy="block",
                                   n_buffers=self.queue_capacity + 2)
                t = threading.Thread(target=self._lane, args=(group, area),
                                     name=f"hprot-lane-g{group}",
                                     daemon=True)
                self.stages[group] = area
                self._threads[group] = t
                t.start()
            return area

    def _lane(self, group: int, area: StagingArea) -> None:
        mgr = self.manager
        while True:
            snap = area.pop(timeout=0.25)
            if snap is None:
                if area.closed and len(area) == 0:
                    return
                continue
            try:
                t0 = time.perf_counter()
                with TRACER.span("ckpt.write", cat="ckpt",
                                 parent=snap.meta.get("_trace"),
                                 args={"step": snap.step, "group": group}):
                    records = _write_shard(mgr.db, snap)
                mgr._shard_landed(snap.step, group, records,
                                  write_seconds=time.perf_counter() - t0)
            except BaseException as e:   # noqa: BLE001 — surfaced on wait
                mgr._lane_failed(group, e)
            finally:
                area.release(snap)

    def stop(self, timeout: float = 30.0) -> None:
        with self._lock:
            areas, threads = dict(self.stages), dict(self._threads)
        for area in areas.values():
            area.close()
        for t in threads.values():
            if t.ident is not None:
                t.join(timeout=timeout)
        if any(t.is_alive() for t in threads.values()):
            # never close the db under a still-writing lane — a leaked
            # daemon thread beats a corrupted group file
            raise TimeoutError(
                "checkpoint writer lanes did not stop; database left open")

    def telemetry(self) -> dict:
        return {"kind": "thread", "n_lanes": len(self._threads),
                "lanes_alive": sum(t.is_alive()
                                   for t in self._threads.values())}


def _ckpt_lane_main(handle, root: str, group: int, results) -> None:
    """One process writer lane: attach shm staging, append, report.

    Results-queue wire format (6-tuples): ``(tag, step, group,
    records_json, wall_or_tb, spans)`` — "done" carries the record
    index + write wall seconds (+ spans when the push rode a trace
    context), "error" carries the traceback in slot 4, "exit" announces
    a clean drain.
    """
    area = ShmStagingArea.attach(handle)
    db = HerculeDB.open(root)
    tracer = Tracer(enabled=True)    # only used when _trace rides in
    try:
        while True:
            try:
                snap = area.pop(timeout=0.25)
            except BaseException:    # noqa: BLE001 — transport failure
                results.put(("error", -1, group, None,
                             traceback.format_exc(), None))
                return
            if snap is None:
                if area.closed and len(area) == 0:
                    return
                continue
            try:
                w0 = now_us()
                records = _write_shard(db, snap)
                w1 = now_us()
                spans = None
                tctx = snap.meta.get("_trace")
                if tctx is not None:
                    tracer.record("ckpt.write", w0, w1, cat="ckpt",
                                  parent=tctx,
                                  args={"step": snap.step, "group": group})
                    spans = tracer.spans()
                    tracer.clear()
                results.put(("done", snap.step, group,
                             [r.to_json() for r in records],
                             (w1 - w0) / 1e6, spans))
            except BaseException:    # noqa: BLE001
                results.put(("error", snap.step, group, None,
                             traceback.format_exc(), None))
            finally:
                area.release(snap)
    finally:
        db.close()
        area.detach()
        results.put(("exit", None, group, None, None, None))


class ProcessCkptLanes(CkptLaneBackend):
    """One spawned OS process per contributor group over shm staging.

    The paper's per-producer protection shape: serialization already
    happened in the gather thread, so the lane's work — slab copy out,
    file append, page-cache flush — runs wholly outside the training
    process. A collector thread funnels record reports to the manager
    and polls lane liveness (see module docstring for crash semantics).
    """

    name = "process"

    def __init__(self, manager, *, queue_capacity: int = 4):
        super().__init__(manager, queue_capacity=queue_capacity)
        self._ctx = multiprocessing.get_context("spawn")
        self._results = self._ctx.Queue()
        self._procs: dict[int, object] = {}
        self._exited: set[int] = set()
        self._stopping = False
        self._collector = threading.Thread(
            target=self._collect, name="hprot-collector", daemon=True)
        self._collector.start()

    def _area(self, group: int):
        with self._lock:
            area = self.stages.get(group)
            if area is None:
                area = ShmStagingArea(capacity=self.queue_capacity,
                                      policy="block",
                                      n_slots=self.queue_capacity + 2,
                                      mp_context=self._ctx)
                p = self._ctx.Process(
                    target=_ckpt_lane_main,
                    args=(area.handle(), self.manager.db.root, group,
                          self._results),
                    name=f"hprot-lane-g{group}", daemon=True)
                self.stages[group] = area
                self._procs[group] = p
                p.start()
            return area

    # ------------------------------------------------------ result intake
    def _collect(self) -> None:
        mgr = self.manager
        while True:
            try:
                msg = self._results.get(timeout=0.25)
            except (ValueError, OSError):
                return   # results queue torn down under a stuck stop
            except queue.Empty:
                with self._lock:
                    procs = dict(self._procs)
                if self._stopping and all(
                        g in self._exited or not p.is_alive()
                        for g, p in procs.items()):
                    return
                if not self._stopping:
                    self._check_lanes(procs)
                continue
            tag, step, group = msg[0], msg[1], msg[2]
            if tag == "exit":
                self._exited.add(group)
            elif tag == "done":
                _, _, _, recs, wall, spans = msg
                if spans:            # lane spans join the parent trace
                    TRACER.ingest(spans)
                if obs_metrics.ENABLED:
                    mgr._h_write.labels(group).observe(wall)
                mgr._shard_landed(step, group,
                                  [Record.from_json(r) for r in recs],
                                  write_seconds=None)
            elif tag == "error":
                mgr._lane_failed(group, RuntimeError(
                    f"checkpoint lane g{group} failed at step {step}:\n"
                    f"{msg[4]}"))
                if step < 0:
                    # fatal transport failure: the lane is exiting; stop
                    # the gather from queueing (or blocking) behind it
                    with self._lock:
                        area = self.stages.get(group)
                    if area is not None:
                        area.close()

    def _check_lanes(self, procs) -> None:
        """Surface lanes that died without reporting (crash semantics).

        Only a nonzero exit code is a crash: a zero-exit lane may
        simply have its "exit" message still queued.
        """
        for g, p in procs.items():
            if g not in self._exited and p.exitcode not in (None, 0):
                self._exited.add(g)
                self.manager._lane_failed(g, RuntimeError(
                    f"checkpoint lane g{g} died (exit code {p.exitcode}) "
                    f"mid-checkpoint"))
                # fail fast instead of deadlocking the block-policy
                # gather against a lane that will never pop again
                with self._lock:
                    area = self.stages.get(g)
                if area is not None:
                    area.close()

    # ------------------------------------------------------------ control
    def stop(self, timeout: float = 30.0) -> None:
        with self._lock:
            areas, procs = dict(self.stages), dict(self._procs)
        for area in areas.values():
            area.close()
        killed = []
        for p in procs.values():
            if p.pid is None:
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
        for area in areas.values():
            area.unlink()
        self._results.close()
        self._results.join_thread()
        if killed:
            self.manager._errors.append(TimeoutError(
                f"checkpoint lanes {killed} did not stop; terminated "
                f"(unreported shards lost)"))

    def telemetry(self) -> dict:
        with self._lock:
            procs = dict(self._procs)
        return {"kind": "process", "n_lanes": len(procs),
                "lanes_exited": len(self._exited),
                "lanes_alive": sum(p.is_alive() for p in procs.values())}


register_backend("thread", ThreadCkptLanes)
register_backend("process", ProcessCkptLanes)
