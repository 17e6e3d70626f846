"""In-transit analysis engine (the paper's staging-node role).

``InTransitEngine`` sits between the compute flow and an HDep database:
compute calls :meth:`submit` (or :meth:`submit_state` for train states)
and returns immediately; lanes drain the staging areas, run the reducer
DAG and write each snapshot's reduced objects as one HDep context. The
engine has its *own* output frequency (``output_every``), independent of
HProt checkpoint cadence — the paper's "different output frequencies"
between the protection and post-processing flows.

With ``domains > 1`` the engine runs the paper's per-producer shape:
each submitted step is partitioned over contributor groups
(``insitu.partition``), every group owns its own staging area and lane,
and each group writes its part of the reduction as its *own Hercule
domain* within the shared per-step context — no single-writer funnel.
The context finalizes when the last group's part lands (or is dropped by
backpressure); reads merge the domains back
(``hercule.api.ReducedKind``), so a context with some parts dropped
still serves its surviving domains.

*How* lanes execute is pluggable (``insitu.lanes``): ``backend="thread"``
keeps every lane an in-process worker thread (PR-3 semantics, bit for
bit); ``backend="process"`` makes each group's lane an OS process fed
through shared-memory staging, so reduction and domain writes run
outside the producer's GIL — the live pipeline scales the way
``bench_insitu.run_multidomain`` demonstrates with separate processes.

``device_reduce=True`` keeps staged snapshots on ``device`` (the GPU
unless the caller passes ``device="cpu"``) and reduces them there through
``insitu.device``; only the reduced objects cross to the host.
``device_reduce="mesh"`` shards each snapshot's leaf table over
``mesh_devices`` (the GPUs unless the caller passes a sequence of
devices) through ``insitu.mesh_reduce``.

``step_ttl`` bounds the life of a partial step: when per-producer
submission (:meth:`submit_part`) loses a producer (crash, skipped
cadence), the step's context finalizes with the surviving domains after
``step_ttl`` seconds of inactivity — the same path drop-oldest eviction
takes — instead of leaking the pending context forever.

Contexts written here carry ``attrs["insitu"]`` with the reducer names,
the per-reducer merge strategies, the contributing domains and staging
statistics, so a catalog (or a human) can see what was reduced and what
back-pressure did to the cadence.
"""
from __future__ import annotations

import dataclasses
import threading
import time

from ..core.amr import AMRTree
from ..hercule import api
from ..hercule.database import HerculeDB
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs.trace import TRACER
from .lanes import make_backend
from .partition import partition_snapshot
from .reducers import Reducer, ReducerDAG
from .staging import Snapshot


@dataclasses.dataclass
class _PendingStep:
    """Countdown of contributor parts still in flight for one step."""
    remaining: int
    ctx: object = None                # ContextWriter, begun lazily
    kind: str = ""
    meta: dict = dataclasses.field(default_factory=dict)
    wrote: set = dataclasses.field(default_factory=set)      # domains
    reducers: set = dataclasses.field(default_factory=set)
    finalizing: bool = False          # countdown done, manifest pending
    touched: float = 0.0              # monotonic time of last activity
    writers: int = 0                  # lanes mid-write into ctx (TTL gate)
    trace: dict | None = None         # submit-span wire context (tracing)


class InTransitEngine:
    """Contributor-group lanes turning staged snapshots into reduced HDep."""

    def __init__(self, root: str | HerculeDB, reducers: list[Reducer], *,
                 output_every: int = 1, workers: int = 1,
                 queue_capacity: int = 4, policy: str = "drop-oldest",
                 ncf: int = 4, compress: bool = False, domains: int = 1,
                 durable_parts: bool = False, backend: str = "thread",
                 step_ttl: float | None = None,
                 device_reduce: bool | str = False, device=None,
                 mesh_devices=None, lane_pool: bool = False, ledger=None):
        from .lanes import BACKENDS
        if backend not in BACKENDS:   # before creating anything on disk
            raise ValueError(f"unknown lane backend {backend!r}; "
                             f"registered: {sorted(BACKENDS)}")
        self.n_domains = max(1, domains)
        if isinstance(device_reduce, str) and device_reduce != "mesh":
            raise ValueError(
                f"unknown device_reduce mode {device_reduce!r}; use "
                f"True (single device) or 'mesh' (sharded reduction over "
                f"a list of devices)")
        self.device_reduce = device_reduce if device_reduce == "mesh" \
            else bool(device_reduce)
        if mesh_devices is not None and self.device_reduce != "mesh":
            raise ValueError(
                "mesh_devices only applies with device_reduce='mesh'")
        if device is not None and self.device_reduce is not True:
            raise ValueError(
                "device only applies with device_reduce=True (for the "
                "mesh, pass mesh_devices as a sequence of devices)")
        if self.device_reduce and backend != "thread":
            # device tensors cannot cross to spawned lane processes; the
            # device path exists precisely to avoid such copies
            raise ValueError(
                f"device_reduce={self.device_reduce!r} requires "
                f"backend='thread' (device tensors and the device mesh "
                f"stay in the engine process)")
        #: where device_reduce=True stages and reduces (None otherwise)
        self.device = None
        if self.device_reduce is True:
            from .device import resolve_device
            self.device = resolve_device(device)
        if lane_pool and backend != "process":
            raise ValueError(
                "lane_pool=True only applies to backend='process' "
                "(thread lanes have no spawn cost to amortize)")
        if backend == "process" and self.n_domains > 1:
            ncf = 1   # each lane process must own its group files
        self.db = root if isinstance(root, HerculeDB) else \
            HerculeDB.create(root, kind="hdep", ncf=ncf)
        self.dag = ReducerDAG(reducers)
        #: device-reduce runner (None = host DAG execution); staging
        #: residency follows it — see lanes.ThreadLaneBackend
        self._device = None
        if self.device_reduce == "mesh":
            # sharded path: snapshots stage on the host (the leaf table
            # is Hilbert-sharded over the devices at reduce time), so the
            # staging area stays the plain host one — see lanes
            from .mesh_reduce import MeshDAGRunner
            self._device = MeshDAGRunner(self.dag, devices=mesh_devices)
        elif self.device_reduce:
            from .device import DeviceDAGRunner
            self._device = DeviceDAGRunner(self.dag)
        self.compress = compress
        self.output_every = max(1, output_every)
        #: fsync each group file from its own lane right after the part
        #: lands (parallel durability on storage with scalable sync);
        #: off = PR-1 semantics, durability at context finalize only
        self.durable_parts = durable_parts
        self.step_ttl = step_ttl
        self._merge_map = {r.name: r.merge for r in self.dag
                           if getattr(r, "merge", None)}
        self._errors: list[BaseException] = []
        self._pending: dict[int, _PendingStep] = {}
        #: completed steps whose finalize was deferred off the compute
        #: thread (eviction can complete a countdown inside submit();
        #: the manifest fsync must not run there)
        self._deferred: list[tuple[int, _PendingStep]] = []
        self._written: list[int] = []
        self._committed: set[int] = set()   # fast membership for _written
        self._failed = 0
        self._skipped = 0          # snapshot parts no reducer applied to
        self._ttl_expired = 0      # steps force-finalized by step_ttl
        self._wlock = threading.Lock()
        self._started = False
        #: the lane runtime: staging transport + execution context per
        #: contributor group (see insitu.lanes)
        self._backend = make_backend(backend, self, workers=workers,
                                     queue_capacity=queue_capacity,
                                     policy=policy, lane_pool=lane_pool)
        #: one staging area per contributor group; ``staging`` aliases
        #: group 0 for the single-group API the compute side always had
        self.stages = self._backend.stages
        self.staging = self.stages[0]
        #: per-engine metrics registry (engine instances never collide);
        #: hot-path observes are gated on obs.metrics.ENABLED, callback
        #: gauges sync the passive counters at collect time
        self.obs = obs_metrics.MetricsRegistry()
        self._h_submit = self.obs.histogram(
            "insitu_submit_seconds", "producer-side submit latency")
        self._h_reduce = self.obs.histogram(
            "insitu_reduce_seconds", "lane reducer-DAG latency",
            labels=("group",))
        self._h_write = self.obs.histogram(
            "insitu_write_seconds", "domain write latency",
            labels=("group",))
        self._h_commit = self.obs.histogram(
            "insitu_commit_seconds", "manifest commit latency")
        self.obs.register_callback(self._sync_obs)
        #: flight-recorder state: backpressure edge detection, one-shot
        #: crash dump, device-fallback event deltas
        self._bp_block_seen = 0.0
        self._bp_active = False
        self._fallback_seen = 0
        self._dumped = False
        self.ledger = None
        if ledger is not None:
            self.bind_ledger(ledger)

    @property
    def backend(self) -> str:
        return self._backend.name

    # ------------------------------------------------------------ run ledger
    def bind_ledger(self, ledger) -> None:
        """Attach a :class:`~repro_torch.obs.ledger.RunLedger`: the
        engine registers its metrics registry as a flush source and its
        health signals, and lane telemetry relayed over the results
        queue is forwarded into each lane's own ledger domain."""
        self.ledger = ledger
        ledger.add_source("engine", self.obs.snapshot)
        ledger.add_signal("staging_pressure", self._sig_staging_pressure)
        ledger.add_signal("backpressure", self._sig_backpressure)
        ledger.add_signal(
            "engine_failed",
            lambda: float(self._failed + len(self._errors)))
        if self._device is not None:
            # the device runner's own count of snapshots it had to
            # materialize on the host (DeviceRunStats.fallback_snapshots)
            ledger.add_signal(
                "device_fallbacks",
                lambda: float(self._device.stats.fallback_snapshots))

    def _sig_staging_pressure(self) -> float | None:
        """Worst queue-fill fraction across the contributor groups."""
        worst = None
        for area in self.stages:
            try:
                frac = len(area) / max(1, area.capacity)
            except Exception:           # noqa: BLE001 — unlinked shm area
                continue
            worst = frac if worst is None else max(worst, frac)
        return worst

    def _sig_backpressure(self) -> float:
        """Fraction of wall time producers spent blocked since the last
        sample (block policy; drop policies surface as evict events)."""
        now = time.monotonic()
        total = sum(a.stats.as_dict().get("block_seconds", 0.0)
                    for a in self.stages)
        last_t, last_b = getattr(self, "_bp_sample", (None, 0.0))
        self._bp_sample = (now, total)
        if last_t is None or now <= last_t:
            return 0.0
        return min(1.0, max(0.0, (total - last_b) / (now - last_t)))

    def _note_backpressure(self) -> None:
        """Edge-triggered backpressure events off the block-time stat:
        enter when a submit paid block time, exit on the first submit
        that didn't (runs on the producer thread, two counter reads)."""
        total = 0.0
        for area in self.stages:
            try:
                total += area.stats.block_seconds
            except Exception:           # noqa: BLE001 — unlinked shm area
                return
        if total > self._bp_block_seen:
            self._bp_block_seen = total
            if not self._bp_active:
                self._bp_active = True
                obs_events.EVENTS.emit(
                    obs_events.STAGING_BACKPRESSURE, state="enter",
                    block_seconds=round(total, 6))
        elif self._bp_active:
            self._bp_active = False
            obs_events.EVENTS.emit(
                obs_events.STAGING_BACKPRESSURE, state="exit",
                block_seconds=round(total, 6))

    # ----------------------------------------------------------- compute side
    def start(self) -> "InTransitEngine":
        if not self._started:
            self._started = True
            self._backend.start()
        return self

    def submit(self, step: int, payload, *, kind: str = "amr",
               meta: dict | None = None) -> bool:
        """Offer one step's state to the analysis flow.

        ``payload`` is an :class:`AMRTree`, or a dict of arrays (device or
        host). Steps off the engine's output cadence are ignored without
        staging cost; otherwise the payload is partitioned over the
        contributor groups and each part staged under the configured
        backpressure policy. Returns True iff any part was staged.
        """
        self.check_errors()
        if not self._started:
            self.start()
        if step % self.output_every != 0:
            return False
        self._sweep_ttl()
        t0 = time.perf_counter() if obs_metrics.ENABLED else 0.0
        with TRACER.span("submit", args={"step": step}) as sp:
            if isinstance(payload, AMRTree):
                payload = payload.to_arrays()
                kind = "amr"
            parts = partition_snapshot(payload, kind, self.n_domains)
            staged = self._stage_parts(step, parts, kind, meta,
                                       trace=sp.context())
        if obs_metrics.ENABLED:
            self._h_submit.observe(time.perf_counter() - t0)
            self._note_backpressure()
        return staged

    def submit_parts(self, step: int, parts, *, kind: str = "amr",
                     meta: dict | None = None) -> bool:
        """Per-producer hand-off: stage pre-partitioned contributor parts.

        ``parts`` holds one payload (array dict or :class:`AMRTree`) per
        contributor group — the shape real multi-producer runs have,
        where each producer already owns its domain and no runtime
        partition is needed. ``len(parts)`` must equal the engine's
        ``domains``. Cadence and backpressure behave exactly as in
        :meth:`submit`; returns True iff any part was staged.
        """
        self.check_errors()
        if not self._started:
            self.start()
        if step % self.output_every != 0:
            return False
        if len(parts) != self.n_domains:
            raise ValueError(
                f"got {len(parts)} parts for {self.n_domains} contributor "
                f"group(s)")
        self._sweep_ttl()
        t0 = time.perf_counter() if obs_metrics.ENABLED else 0.0
        with TRACER.span("submit", args={"step": step}) as sp:
            parts = [p.to_arrays() if isinstance(p, AMRTree) else p
                     for p in parts]
            staged = self._stage_parts(step, parts, kind, meta,
                                       trace=sp.context())
        if obs_metrics.ENABLED:
            self._h_submit.observe(time.perf_counter() - t0)
            self._note_backpressure()
        return staged

    def submit_part(self, step: int, domain: int, payload, *,
                    kind: str = "amr", meta: dict | None = None) -> bool:
        """One producer's hand-off of its own contributor part.

        The fully per-producer shape: each of the ``domains`` producers
        (e.g. one thread per simulated MPI rank) stages its own part
        into its own group's staging area, concurrently with the others
        — no shared hand-off thread. The step's context finalizes once
        all ``domains`` parts have settled; backpressure drops count as
        settled, and a producer that skips an on-cadence step is covered
        by ``step_ttl`` (the partial context finalizes with the
        surviving domains after the timeout; without a TTL it would
        wait forever). A part arriving *after* its step's context
        committed is rejected (returns False) — a lone straggler must
        not restart the countdown and overwrite the survivors' manifest.
        """
        self.check_errors()
        if not self._started:
            self.start()
        if step % self.output_every != 0:
            return False
        if not 0 <= domain < self.n_domains:
            raise ValueError(f"domain {domain} outside the engine's "
                             f"{self.n_domains} contributor group(s)")
        self._sweep_ttl()
        t0 = time.perf_counter() if obs_metrics.ENABLED else 0.0
        with TRACER.span("submit",
                         args={"step": step, "domain": domain}) as sp:
            tctx = sp.context()
            if isinstance(payload, AMRTree):
                payload = payload.to_arrays()
            with self._wlock:
                pend = self._pending.get(step)
                if (pend is not None and pend.finalizing) or \
                        (pend is None and step in self._committed):
                    # the step's context already committed (or is
                    # committing) — e.g. a TTL-finalized partial. A lone
                    # late part must not start a fresh countdown: it
                    # could only ever hold its own domain, and committing
                    # that would *overwrite* the manifest that carries
                    # the other survivors.
                    return False
                if pend is None:
                    self._pending[step] = _PendingStep(
                        remaining=self.n_domains, touched=time.monotonic(),
                        trace=tctx)
                else:
                    pend.touched = time.monotonic()
            if pend is None:
                obs_events.EVENTS.emit(obs_events.STEP_BEGIN, step=step,
                                       parts=self.n_domains, kind=kind)
            if tctx is not None:
                meta = {**(meta or {}), "_trace": tctx}
            with TRACER.span("stage.push", args={"step": step,
                                                 "group": domain}):
                ok = self.stages[domain].push(
                    step, payload, kind=kind, meta=meta, domain=domain,
                    n_domains=self.n_domains)
        if obs_metrics.ENABLED:
            self._h_submit.observe(time.perf_counter() - t0)
            self._note_backpressure()
        if not ok:
            self._part_done(step, None, None, defer_finalize=True)
        return ok

    def _stage_parts(self, step: int, parts, kind: str,
                     meta: dict | None, trace: dict | None = None) -> bool:
        # register before the first push: a fast worker lane may finish
        # its part while later parts are still being staged
        with self._wlock:
            pend = self._pending.get(step)
            fresh = pend is None or pend.finalizing
            if fresh:
                # a finalizing pend is already off the countdown: the
                # resubmission gets its own entry (and so its own
                # ContextWriter — never append to a mid-serialization
                # manifest); the stale entry pops itself by identity
                self._pending[step] = _PendingStep(
                    remaining=len(parts), touched=time.monotonic(),
                    trace=trace)
            else:                      # resubmitted step: extend the countdown
                pend.remaining += len(parts)
                pend.touched = time.monotonic()
        if fresh:
            obs_events.EVENTS.emit(obs_events.STEP_BEGIN, step=step,
                                   parts=len(parts), kind=kind)
        if trace is not None:
            # the submit span rides the snapshot meta across the lane
            # boundary (shm JSON header), so lane-side spans link to it
            meta = {**(meta or {}), "_trace": trace}
        staged_any = False
        for g, part in enumerate(parts):
            with TRACER.span("stage.push", args={"step": step,
                                                 "group": g}):
                ok = self.stages[g].push(step, part, kind=kind, meta=meta,
                                         domain=g,
                                         n_domains=self.n_domains)
            if ok:
                staged_any = True
            else:
                self._part_done(step, None, None, defer_finalize=True)
        return staged_any

    def submit_state(self, step: int, state, *, prefix: str = "params"
                     ) -> bool:
        """Stage the matrix-shaped leaves of a train-state tree.

        Leaves are named as HProt names them (``hercule.checkpoint.
        leaf_name``); tensors stay where they live (a sharded leaf is
        assembled on its first shard's device).
        """
        if step % self.output_every != 0:
            return False   # skip the tree walk on off-cadence steps
        from ..hercule.checkpoint import ShardedTensor, _leaf_paths, leaf_name
        sub = state[prefix] if isinstance(state, dict) and prefix in state \
            else state
        arrays = {}
        for path, leaf in _leaf_paths(sub):
            if getattr(leaf, "ndim", 0) < 2:
                continue
            arrays[leaf_name(path)] = leaf.full() \
                if isinstance(leaf, ShardedTensor) else leaf
        return self.submit(step, arrays, kind="tensors")

    # ---------------------------------------------------------- analysis side
    def _on_evict(self, snap: Snapshot) -> None:
        """A queued part was displaced by drop-oldest backpressure.

        Runs on the pushing (compute) thread, so a completed countdown
        is deferred — lanes (or :meth:`drain`) commit it.
        """
        obs_events.EVENTS.emit(obs_events.STAGING_EVICT, step=snap.step,
                               group=snap.domain)
        self._part_done(snap.step, None, None, defer_finalize=True)

    def _reduce_and_write(self, snap: Snapshot):
        """Thread-backend execution of one part (in the engine process)."""
        obs_on = obs_metrics.ENABLED
        tctx = snap.meta.get("_trace")
        t0 = time.perf_counter() if obs_on else 0.0
        with TRACER.span("reduce", parent=tctx,
                         args={"step": snap.step, "group": snap.domain}):
            outputs = self._device.run(snap) if self._device is not None \
                else self.dag.run(snap)
        if obs_on:
            self._h_reduce.labels(snap.domain).observe(
                time.perf_counter() - t0)
        if not outputs:
            # no reducer accepted this snapshot kind — don't litter the
            # database with empty contexts; surface it via stats instead
            with self._wlock:
                self._skipped += 1
            self._part_done(snap.step, None, None)
            return
        with self._wlock:
            pend = self._pending.get(snap.step)
            ctx = None
            if pend is not None and not pend.finalizing:
                if pend.ctx is None:
                    pend.ctx = self.db.begin_context(snap.step)
                    pend.kind = snap.kind
                    pend.meta = snap.meta
                ctx = pend.ctx
                # holding a writer claim keeps the TTL sweep from
                # finalizing (and serializing) this manifest while the
                # records below are still being appended
                pend.writers += 1
        if ctx is None:   # lone part of a settled (or TTL-expired) step:
            return        # never write into a mid-serialization manifest
        try:
            t1 = time.perf_counter() if obs_on else 0.0
            with TRACER.span("write", parent=tctx,
                             args={"step": snap.step,
                                   "group": snap.domain}):
                for rname, arrays in outputs.items():
                    api.write_object(ctx, "reduced", snap.domain, arrays,
                                     reducer=rname, compress=self.compress)
                if self.durable_parts:
                    # each lane makes its own group durable: group fsyncs
                    # overlap across lanes instead of queueing serially
                    # behind finalize
                    self.db.flush_domain(snap.domain)
            if obs_on:
                self._h_write.labels(snap.domain).observe(
                    time.perf_counter() - t1)
        except BaseException:
            with self._wlock:
                pend.writers -= 1
            raise          # the lane settles the part via its error path
        # release the writer claim atomically with the settle, so the
        # countdown can never finalize between the two
        self._part_done(snap.step, snap.domain, set(outputs),
                        release_writer=True)

    def _part_records(self, step: int, domain: int, records, reducers: set,
                      kind: str, meta: dict | None) -> None:
        """Process-backend intake: a lane landed its part, records arrive.

        The lane already appended the payload bytes to its own group
        files; the engine only collects the record index into the shared
        per-step context for the manifest commit.
        """
        with self._wlock:
            pend = self._pending.get(step)
            live = pend is not None and not pend.finalizing
            if live:
                if pend.ctx is None:
                    pend.ctx = self.db.begin_context(step)
                    pend.kind = kind
                    pend.meta = dict(meta or {})
                pend.ctx.records.extend(records)
                # claim a writer until the settle below: a TTL sweep
                # between the two lock holds must not commit a manifest
                # carrying these records but not their domain/reducers
                pend.writers += 1
        if not live:      # late part of a TTL-expired step: its bytes
            return        # stay orphaned (no manifest references them)
        self._part_done(step, domain, reducers, release_writer=True)

    def _part_done(self, step: int, domain: int | None,
                   reducers: set | None, *,
                   defer_finalize: bool = False,
                   release_writer: bool = False) -> None:
        """One contributor part settled (written, dropped, or failed).

        The pending entry survives until the manifest is committed, so
        :meth:`drain` cannot return while a context is mid-finalize.
        """
        with self._wlock:
            pend = self._pending.get(step)
            if pend is None or pend.finalizing:
                return
            if release_writer:
                pend.writers -= 1
            pend.remaining -= 1
            pend.touched = time.monotonic()
            if domain is not None:
                pend.wrote.add(domain)
                pend.reducers |= reducers
            if pend.remaining > 0:
                return
            if pend.writers > 0:
                # a lane is still appending records into this context
                # (possible when a TTL sweep consumed the countdown):
                # that writer's own settle re-enters here with
                # writers == 0 and commits — its records included
                return
            pend.finalizing = True
            if pend.ctx is None:        # every part dropped/skipped: no
                del self._pending[step]  # context, nothing to commit
                return
            if defer_finalize:
                self._deferred.append((step, pend))
                return
        self._finalize_step(step, pend)

    def _sweep_ttl(self) -> None:
        """Force-settle steps inactive past ``step_ttl`` (partial commit).

        A producer that skipped an on-cadence step (or died) leaves the
        step's countdown short forever; after ``step_ttl`` seconds with
        no part activity the missing parts are settled through the same
        path as drop-oldest eviction, so the context commits with the
        surviving domains only. A step with a lane mid-write into its
        context (``writers > 0``) is never swept — the TTL targets
        missing producers, not slow reductions; a part the sweep beat
        to the *start* of its write finds the context finalizing and
        skips cleanly.
        """
        if self.step_ttl is None:
            return
        now = time.monotonic()
        with self._wlock:
            expired = [(step, pend.remaining)
                       for step, pend in self._pending.items()
                       if not pend.finalizing and pend.remaining > 0
                       and pend.writers == 0
                       and now - pend.touched > self.step_ttl]
            self._ttl_expired += len(expired)
        for step, missing in expired:
            for _ in range(missing):
                self._part_done(step, None, None, defer_finalize=True)

    def _finalize_step(self, step: int, pend: _PendingStep) -> None:
        """Commit one completed context; errors surface via check_errors."""
        staging = self.stages[0].stats.as_dict() if self.n_domains == 1 \
            else [a.stats.as_dict() for a in self.stages]
        # the trace context is transport metadata, not context attrs
        meta = {k: v for k, v in pend.meta.items() if k != "_trace"}
        obs_on = obs_metrics.ENABLED
        t0 = time.perf_counter() if obs_on else 0.0
        try:
            with TRACER.span("manifest.commit", parent=pend.trace,
                             args={"step": step,
                                   "domains": sorted(pend.wrote)}):
                self._backend.pre_finalize(pend)
                pend.ctx.finalize(attrs={"insitu": {
                    "kind": pend.kind,
                    "reducers": sorted(pend.reducers),
                    "merge": {r: self._merge_map[r]
                              for r in sorted(pend.reducers)
                              if r in self._merge_map},
                    "n_domains": self.n_domains,
                    "domains": sorted(pend.wrote),
                    "staging": staging,
                    **meta,
                }})
            if obs_on:
                self._h_commit.observe(time.perf_counter() - t0)
        except BaseException as e:
            self._errors.append(e)
            with self._wlock:
                self._failed += 1
                if self._pending.get(step) is pend:   # a resubmission
                    del self._pending[step]           # may own the slot
            obs_events.EVENTS.dump("engine.commit_failed", step=step,
                                   error=repr(e))
            return
        with self._wlock:
            self._written.append(step)
            self._committed.add(step)
            if self._pending.get(step) is pend:
                del self._pending[step]
        obs_events.EVENTS.emit(obs_events.STEP_COMMIT, step=step,
                               domains=sorted(pend.wrote),
                               partial=len(pend.wrote) < self.n_domains)

    def _run_deferred(self) -> None:
        """Commit contexts whose countdown completed on a compute thread."""
        while True:
            with self._wlock:
                if not self._deferred:
                    return
                step, pend = self._deferred.pop()
            self._finalize_step(step, pend)

    # ----------------------------------------------------------------- admin
    @property
    def written_steps(self) -> list[int]:
        with self._wlock:
            return sorted(self._written)

    @property
    def skipped_snapshots(self) -> int:
        """Snapshot parts whose kind no reducer in the DAG accepted."""
        with self._wlock:
            return self._skipped

    @property
    def ttl_expired_steps(self) -> int:
        """Steps force-finalized (partial) by the step TTL."""
        with self._wlock:
            return self._ttl_expired

    @property
    def device_stats(self) -> dict | None:
        """Device→host transfer accounting (None unless device_reduce)."""
        return None if self._device is None else \
            self._device.stats.as_dict()

    def _staging_per_group(self) -> list[dict]:
        # shm areas share their counter words with the lane process, so
        # the producer-side view already carries consumer increments
        # (popped/released); after unlink the frozen copy answers
        return [a.stats.as_dict() for a in self.stages]

    def telemetry(self) -> dict:
        """One merged observability snapshot across every pipeline layer.

        Aggregates what used to be scattered over ``stages[i].stats``,
        ``device_stats`` and backend internals (all kept as thin views):
        staging per group + totals, lane/backend state, device-reduce
        accounting, write/commit progress, and the engine's metric
        registry. Identical shape for thread and process backends; for
        shm staging the producer and consumer sides are merged through
        the shared control words.
        """
        with self._wlock:
            lanes = {"written_steps": len(self._written),
                     "failed": self._failed,
                     "skipped_parts": self._skipped,
                     "ttl_expired_steps": self._ttl_expired,
                     "pending_steps": len(self._pending)}
            last = max(self._written, default=None)
        per_group = self._staging_per_group()
        totals = {k: sum(d[k] for d in per_group) for k in per_group[0]}
        queued = [len(a) if getattr(a, "_words", True) is not None
                  else None for a in self.stages]   # None once unlinked
        lanes.update(self._backend.telemetry())
        return {
            "backend": self._backend.name,
            "staging": {"per_group": per_group, "totals": totals,
                        "queued": queued},
            "lanes": lanes,
            "device": self.device_stats,
            "writes": {"contexts_committed": lanes["written_steps"],
                       "last_step": last},
            "trace": {"spans_dropped": TRACER.spans_dropped,
                      "max_spans": TRACER.max_spans,
                      "events_dropped": obs_events.EVENTS.dropped},
            "ledger": None if self.ledger is None
            else self.ledger.telemetry(),
            "metrics": self.obs.snapshot(),
        }

    def _sync_obs(self) -> None:
        """Collect-time gauge sync (MetricsRegistry callback): mirrors
        the passive counters into the registry without touching any hot
        path."""
        with self._wlock:
            state = {"steps_written": len(self._written),
                     "steps_failed": self._failed,
                     "parts_skipped": self._skipped,
                     "steps_ttl_expired": self._ttl_expired,
                     "steps_pending": len(self._pending)}
        for k, v in state.items():
            self.obs.gauge(f"insitu_{k}", "engine progress counter").set(v)
        per_group = self._staging_per_group()
        for k in per_group[0]:
            self.obs.gauge(f"insitu_staging_{k}",
                           "staging counter, summed over groups").set(
                sum(d[k] for d in per_group))
        for k, v in self._backend.telemetry().items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.obs.gauge(f"insitu_lane_{k}",
                               "lane backend counter").set(v)
        if self._device is not None:
            for k, v in self._device.stats.as_dict().items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self.obs.gauge(f"insitu_device_{k}",
                                   "device reduce counter").set(v)
            n_fallback = self._device.stats.fallback_snapshots
            if n_fallback > self._fallback_seen:
                obs_events.EVENTS.emit(
                    obs_events.DEVICE_FALLBACK,
                    snapshots=n_fallback - self._fallback_seen,
                    total=n_fallback)
                self._fallback_seen = n_fallback

    def check_errors(self) -> None:
        if self._errors:
            if not self._dumped:
                # first surfacing of an engine failure: flush the flight
                # recorder so the postmortem has the final window on disk
                self._dumped = True
                obs_events.EVENTS.dump(
                    "engine.failed", error=repr(self._errors[0]))
            raise RuntimeError("in-transit reduction failed") \
                from self._errors[0]

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every accepted part was reduced (or dropped)."""
        deadline = time.perf_counter() + timeout
        while True:
            self.check_errors()
            self._run_deferred()
            self._sweep_ttl()
            with self._wlock:
                if not self._pending:
                    return
            if time.perf_counter() > deadline:
                raise TimeoutError("in-transit engine did not drain")
            time.sleep(0.005)

    def settle_through(self, step: int, timeout: float = 60.0) -> None:
        """Block until every accepted part of the steps up to ``step`` was
        reduced (or dropped) and its context committed. Safe to call off
        the compute thread: a checkpoint's commit waits here, so a
        checkpoint at ``step`` is never durable before the analyses of
        the steps it covers."""
        deadline = time.perf_counter() + timeout
        while True:
            self._run_deferred()
            with self._wlock:
                if not any(s <= step for s in self._pending):
                    return
            if time.perf_counter() > deadline:
                raise TimeoutError(f"in-transit steps up to {step} did not "
                                   f"settle in {timeout} s")
            time.sleep(0.005)

    def close(self, *, drain: bool = True) -> None:
        err: BaseException | None = None
        if drain and self._started:
            try:
                self.drain()
            except BaseException as e:
                err = e
        if self._started:
            self._backend.stop(timeout=30.0)
        else:
            self._backend.stop(timeout=0.0)
        self._run_deferred()   # evict-completed contexts with no lane left
        self.db.close()
        if err is not None:
            raise err
        self.check_errors()
