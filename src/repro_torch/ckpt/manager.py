"""HProt async sharded checkpoint manager with delta checkpoints.

The paper's protection flow, rebuilt on this repo's staging + lane
machinery (DESIGN.md §16). One save decomposes into four pipeline
stages, each its own span:

  ``ckpt.snapshot``  (train thread, *the only stall*) — a
      snapshot-consistent cut of the state: every owned shard is
      cloned (``clone()``) on the caller's current stream of its device, and
      one CUDA event per device is recorded after the clones. Work the
      caller queues later on that stream (in-place optimizer updates)
      runs after the cut, so the optimizer may overwrite the source
      tensors the moment save returns, and ``save`` never waits for the
      device. No host transfer, no serialization.
  ``ckpt.stage``     (gather thread) — tensors cross to the host *one
      at a time* (bounded host memory): the gather waits on the cut's
      event on a copy stream of its own, copies the clone into fresh
      pinned host memory, waits for that copy and only then drops the
      clone (so the caching allocator cannot hand its memory out while
      the copy reads it). Each host copy is its own array, so it can be
      kept as the next delta predictor. It is then delta- or
      raw-encoded, CRC32-stamped and pushed into the owning contributor
      group's staging area.
  ``ckpt.write``     (writer lanes, thread or process) — append to the
      group's Hercule files and publish to the page cache
      (``flush_domain(sync=False)``); no fsync here.
  ``ckpt.commit``    — once every shard of the *oldest* in-flight step
      has landed, the referenced files are fsynced and the manifest
      atomically replaced (``HerculeDB.commit_context``). Commits are
      strictly save-ordered so a delta context can never become
      readable before its predecessor.

A crash anywhere before the commit leaves no manifest: restart falls
back to the previous complete step (``restore.latest_complete_step``).
A writer-lane crash fails every in-flight step and surfaces on the
next ``save``/``wait`` — never a silent half-checkpoint, never a
deadlocked barrier.

Delta checkpoints (``delta_every=K``): checkpoint k in each cycle of
K+1 stores each float tensor as an ``fpdelta-delta`` residual against
the previous checkpoint (temporal father–son, the paper's time-chained
objects), with a periodic *full rebase* bounding every restore chain
at K links. Restore replays the chain bit-exactly through the
checksum-verifying decoder in :mod:`.restore`.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import zlib

import numpy as np
import torch

from ..core import pyramid as pyr
from ..hercule import api, codecs
from ..hercule.checkpoint import (_FLOATY, _global_shape, _leaf_paths,
                                  _owned, _slices_json, restore_tree)
from ..hercule.database import HerculeDB
from ..obs import events as obs_events
from ..obs import metrics as obs_metrics
from ..obs.trace import TRACER
from .lanes import make_backend
from .restore import latest_complete_step, verified_reader

_SENTINEL = object()


@dataclasses.dataclass
class _PendingSave:
    """One in-flight step between snapshot and manifest commit."""
    step: int
    attrs: dict
    tctx: dict | None                 # ckpt.snapshot span wire context
    fence: object = None              # called before the commit
    expected: int | None = None       # shard count; None until gathered
    landed: int = 0
    records: list = dataclasses.field(default_factory=list)
    committing: bool = False          # commit claimed by some thread


class AsyncCheckpointManager:
    """Async sharded HProt checkpoints over staged writer lanes.

    Drop-in for :class:`~repro_torch.hercule.checkpoint.CheckpointManager`
    (``save``/``wait``/``close``/``latest_step``/``restore``), but the
    train step only pays for the device-side snapshot; encoding, file
    I/O and durability all happen behind the staging areas.
    """

    def __init__(self, root: str, *, ncf: int = 8,
                 max_file_bytes: int = 2 << 30, delta_every: int = 0,
                 lane_backend: str = "thread", queue_capacity: int = 4,
                 io_threads: int = 4, registry=None):
        self.db = HerculeDB.create(root, kind="hprot", ncf=ncf,
                                   max_file_bytes=max_file_bytes,
                                   io_threads=io_threads)
        self.delta_every = max(0, int(delta_every))
        # delta predictors: last checkpoint's host tensors (only kept
        # when delta encoding is on — they cost one state copy of RAM)
        self._prev: dict[tuple[str, int], np.ndarray] = {}
        self._prev_step: int | None = None
        self._deltas_since_full = 0

        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._pending: dict[int, _PendingSave] = {}
        self._order: list[int] = []          # steps in save order
        self._errors: list[BaseException] = []
        self._committed = 0
        self._stall_total = 0.0
        self._closed = False
        # the gather's own copy stream per CUDA device, and what it moved
        self._copy_streams: dict[torch.device, torch.cuda.Stream] = {}
        self._d2h_bytes = 0
        self._d2h_seconds = 0.0
        self._encode_seconds = 0.0

        self.obs = registry if registry is not None \
            else obs_metrics.MetricsRegistry()
        self._h_stall = self.obs.histogram(
            "ckpt_stall_seconds", "train-step stall per save (snapshot)")
        self._h_gather = self.obs.histogram(
            "ckpt_gather_seconds", "host gather+encode time per save")
        self._h_commit = self.obs.histogram(
            "ckpt_commit_seconds", "fsync + manifest commit time")
        self._h_write = self.obs.histogram(
            "ckpt_write_seconds", "lane write time per shard",
            labels=("group",))
        self._c_bytes = self.obs.counter(
            "ckpt_bytes_written_total", "encoded shard bytes staged",
            labels=("codec",))
        self._c_records = self.obs.counter(
            "ckpt_records_total", "checkpoint shard records staged")
        self._c_saves = self.obs.counter(
            "ckpt_saves_total", "checkpoints gathered", labels=("mode",))

        self._backend = make_backend(lane_backend, self,
                                     queue_capacity=queue_capacity)
        # depth-1 hand-off: a save whose *predecessor* is still
        # gathering blocks — the paper's barrier on the previous flush
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._gather = threading.Thread(target=self._gather_main,
                                        name="hprot-gather", daemon=True)
        self._gather.start()

    # --------------------------------------------------------------- save
    def save(self, step: int, state, *, attrs: dict | None = None,
             wait: bool = False, fence=None) -> None:
        """Cut a snapshot (the only synchronous part) and hand it off.
        ``fence``, if given, is called on the gather thread once the
        shards are handed to the lanes; the step commits only after it
        returns (an exception fails the save)."""
        self.check_errors()
        step = int(step)
        t0 = time.perf_counter()
        with TRACER.span("ckpt.snapshot", cat="ckpt",
                         args={"step": step}) as sp:
            tctx = sp.context()
            cut = self._snapshot(state)
        pend = _PendingSave(step=step, attrs=dict(attrs or {}), tctx=tctx,
                            fence=fence)
        with self._lock:
            if step in self._pending:
                raise ValueError(f"step {step} already in flight")
            self._pending[step] = pend
            self._order.append(step)
        self._q.put((step, cut))   # blocks while previous gather runs
        stall = time.perf_counter() - t0
        with self._lock:
            self._stall_total += stall
        if obs_metrics.ENABLED:
            self._h_stall.observe(stall)
        if wait:
            self.wait()

    def _snapshot(self, state) -> list:
        """Consistent cut: device clones on the caller's streams, one
        event per CUDA device after them; no host traffic, no wait."""
        cut, devices = [], set()
        for name, leaf in _leaf_paths(state):
            for domain, index, data in _owned(leaf):
                if isinstance(data, torch.Tensor):
                    data = data.detach().clone()
                    if data.is_cuda:
                        devices.add(data.device)
                else:
                    data = np.array(data, copy=True)
                gshape = _global_shape(leaf, data)
                cut.append([name, domain, _slices_json(index, gshape),
                            gshape, data])
        events = {}
        for dev in devices:
            events[dev] = ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        for entry in cut:
            data = entry[4]
            entry.append(events.get(data.device)
                         if isinstance(data, torch.Tensor) else None)
        return cut

    def _download(self, data, event) -> tuple[np.ndarray, str]:
        """One cut entry on the host: its own array and dtype name."""
        if not isinstance(data, torch.Tensor):
            return pyr.host_bits(data)
        if data.is_cuda:
            t0 = time.perf_counter()
            stream = self._copy_streams.get(data.device)
            if stream is None:
                stream = self._copy_streams[data.device] = \
                    torch.cuda.Stream(data.device)
            with torch.cuda.stream(stream):
                stream.wait_event(event)        # the cut, then the copy
                host = torch.empty(data.shape, dtype=data.dtype,
                                   pin_memory=True)
                host.copy_(data, non_blocking=True)
            stream.synchronize()
            self._d2h_bytes += host.numel() * host.element_size()
            self._d2h_seconds += time.perf_counter() - t0
            data = host
        return pyr.host_bits(data)   # a CPU clone is already our own

    # ------------------------------------------------------------- gather
    def _gather_main(self) -> None:
        while True:
            job = self._q.get()
            if job is _SENTINEL:
                self._q.task_done()
                return
            step, cut = job
            try:
                self._gather_one(step, cut)
            except BaseException as e:   # noqa: BLE001 — surfaced on wait
                self._save_failed(step, e)
            finally:
                self._q.task_done()

    def _gather_one(self, step: int, cut: list) -> None:
        with self._lock:
            pend = self._pending.get(step)
        if pend is None:       # step already failed (e.g. lane crash)
            return
        full = (self.delta_every == 0 or self._prev_step is None
                or self._deltas_since_full >= self.delta_every)
        keep_prev = self.delta_every > 0
        new_prev: dict | None = {} if keep_prev else None
        g0 = time.perf_counter()
        count = 0
        for entry in cut:
            name, domain, slices, gshape, data, event = entry
            domain = int(domain)
            with TRACER.span("ckpt.stage", cat="ckpt", parent=pend.tctx,
                             args={"step": step, "tensor": name}):
                # one tensor on the host at a time; the device clone is
                # released only after its copy completed
                host, dtype = self._download(data, event)
                entry[4] = data = None
                e0 = time.perf_counter()
                codec, payload, meta = self._encode(name, domain, host,
                                                    dtype, full=full)
                self._encode_seconds += time.perf_counter() - e0
                crc = zlib.crc32(payload) & 0xFFFFFFFF
                desc = {
                    "rec_name": api.HPROT_SHARD.record_name(name),
                    "domain": domain, "dtype": dtype,
                    "shape": list(host.shape), "codec": codec,
                    "rec_meta": {**meta, "slices": slices,
                                 "global_shape": list(gshape),
                                 "crc32": int(crc)},
                    "_trace": pend.tctx,
                }
                self._backend.push(self.db.group_of(domain), step,
                                   np.frombuffer(payload, np.uint8), desc)
            count += 1
            if obs_metrics.ENABLED:
                self._c_bytes.labels(codec).inc(len(payload))
                self._c_records.inc()
            if keep_prev:
                new_prev[(name, domain)] = host
        mode = "full" if full else "delta"
        if full and self.delta_every > 0 and self._prev_step is not None:
            # a *scheduled* full over an existing delta chain = a rebase
            obs_events.EVENTS.emit(obs_events.CKPT_REBASE, step=step,
                                   chain_len=self._deltas_since_full)
        if keep_prev:
            self._prev = new_prev
            self._prev_step = step
            self._deltas_since_full = 0 if full else \
                self._deltas_since_full + 1
        if obs_metrics.ENABLED:
            self._h_gather.observe(time.perf_counter() - g0)
            self._c_saves.labels(mode).inc()
        if pend.fence is not None:
            pend.fence()
        with self._lock:
            pend.attrs["mode"] = mode
            pend.expected = count
        self._try_commit()

    def _encode(self, name: str, domain: int, data: np.ndarray,
                dtype: str, *, full: bool):
        """(codec, payload, meta) for one shard; delta when it pays."""
        raw = np.ascontiguousarray(data).tobytes()
        if not full:
            prev = self._prev.get((name, domain))
            if dtype in _FLOATY and data.size >= 64 \
                    and prev is not None and prev.shape == data.shape \
                    and prev.dtype == data.dtype:
                dc = pyr.encode_delta(data, prev, dtype=dtype)
                payload = codecs.encode_delta(dc)
                if len(payload) < len(raw):
                    return ("fpdelta-delta", payload,
                            {"pred_step": self._prev_step, "pad": dc.pad})
        return "raw", raw, {}

    # -------------------------------------------------- lane-side reports
    def _shard_landed(self, step: int, group: int, records,
                      write_seconds: float | None = None) -> None:
        """One shard durable-in-page-cache; called from lane threads."""
        if write_seconds is not None and obs_metrics.ENABLED:
            self._h_write.labels(group).observe(write_seconds)
        with self._lock:
            pend = self._pending.get(step)
            if pend is None:
                return    # step failed after this shard was staged
            pend.records.extend(records)
            pend.landed += 1
        self._try_commit()

    def _lane_failed(self, group: int, exc: BaseException) -> None:
        """A writer lane crashed: no in-flight step can ever complete."""
        with self._lock:
            self._errors.append(exc)
            self._pending.clear()     # their manifests must never commit
            self._order.clear()
            self._done.notify_all()

    def _save_failed(self, step: int, exc: BaseException) -> None:
        with self._lock:
            self._errors.append(exc)
            self._pending.pop(step, None)
            if step in self._order:
                self._order.remove(step)
            self._done.notify_all()

    # -------------------------------------------------------------- commit
    def _try_commit(self) -> None:
        """Commit the oldest step once all its shards landed.

        Strictly save-ordered (head of ``_order`` only): a delta
        context becomes readable only after its predecessor's manifest
        exists. The ``committing`` flag serializes racing lane threads;
        the fsync+rename runs outside the manager lock.
        """
        while True:
            with self._lock:
                if not self._order:
                    return
                step = self._order[0]
                pend = self._pending.get(step)
                if pend is None:          # defensive: orphaned order slot
                    self._order.pop(0)
                    continue
                if pend.committing or pend.expected is None \
                        or pend.landed < pend.expected:
                    return
                pend.committing = True
                records = list(pend.records)
                attrs = dict(pend.attrs)
                tctx = pend.tctx
            try:
                c0 = time.perf_counter()
                with TRACER.span("ckpt.commit", cat="ckpt", parent=tctx,
                                 args={"step": step,
                                       "n_records": len(records)}):
                    self.db.commit_context(step, records, attrs=attrs)
                if obs_metrics.ENABLED:
                    self._h_commit.observe(time.perf_counter() - c0)
                with self._lock:
                    self._pending.pop(step, None)
                    if step in self._order:
                        self._order.remove(step)
                    self._committed += 1
                    self._done.notify_all()
                obs_events.EVENTS.emit(
                    obs_events.CKPT_COMMIT, step=step,
                    mode=attrs.get("mode", "full"),
                    n_records=len(records))
            except BaseException as e:    # noqa: BLE001
                self._save_failed(step, e)
                return

    # ---------------------------------------------------------------- sync
    def wait(self, timeout: float | None = None) -> None:
        """Barrier: every accepted save is committed (or failed)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._order and not self._errors:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"checkpoint steps {list(self._order)} still in "
                        f"flight after {timeout}s")
                self._done.wait(timeout=0.25 if remaining is None
                                else min(0.25, remaining))
        self.check_errors()

    def check_errors(self) -> None:
        with self._lock:
            errs = list(self._errors)
        if errs:
            raise RuntimeError(
                f"async checkpoint failed ({len(errs)} error(s)); "
                f"first: {errs[0]}") from errs[0]

    def close(self) -> None:
        """Drain, stop lanes, close the database. Idempotent; does not
        raise on previously accumulated errors (use ``wait`` for that)."""
        if self._closed:
            return
        self._closed = True
        self._q.join()
        self._q.put(_SENTINEL)
        self._gather.join()
        try:
            self._backend.stop()
        except TimeoutError as e:
            with self._lock:
                self._errors.append(e)
            return   # a lane may still be writing: leave the db open
        self.db.close()

    # -------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        """Newest *complete* step (manifest + every payload + delta chain)."""
        return latest_complete_step(self.db)

    def restore(self, template, step: int | None = None):
        """Verified elastic restore into ``template``'s topology.

        Every payload read is checksum-verified and delta chains replay
        through :func:`.restore.decode_verified` — corruption raises
        :class:`.restore.CorruptShardError` instead of restoring wrong
        weights. Returns ``(state, attrs)``.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no complete checkpoint context found")
        view = self.db.view(step)
        kind = api.HPROT_SHARD
        return restore_tree(template, view, kind, kind.record_name,
                            reader=verified_reader(self.db, step)), \
            view.attrs

    # ------------------------------------------------------------ telemetry
    def bind_ledger(self, ledger) -> None:
        """Register this manager with a run ledger: its metrics become
        a flush source and ``ckpt_stall_ratio`` — the fraction of wall
        time the train thread spent stalled in ``save()`` since the
        previous ledger sample — feeds the health rules."""
        ledger.add_source("ckpt", self.obs.snapshot)
        sample = {"t": time.monotonic(), "stall": 0.0}

        def stall_ratio():
            now = time.monotonic()
            total = self.stall_seconds_total
            dt, dstall = now - sample["t"], total - sample["stall"]
            sample["t"], sample["stall"] = now, total
            if dt <= 0:
                return None
            return min(1.0, max(0.0, dstall / dt))

        ledger.add_signal("ckpt_stall_ratio", stall_ratio)

    @property
    def stall_seconds_total(self) -> float:
        """Cumulative train-thread time spent inside ``save()``."""
        with self._lock:
            return self._stall_total

    def telemetry(self) -> dict:
        with self._lock:
            return {"committed": self._committed,
                    "pending": len(self._order),
                    "errors": len(self._errors),
                    "stall_seconds_total": self._stall_total,
                    "delta_every": self.delta_every,
                    "deltas_since_full": self._deltas_since_full,
                    "bytes_to_host": self._d2h_bytes,
                    "d2h_seconds": self._d2h_seconds,
                    "encode_seconds": self._encode_seconds,
                    "backend": self._backend.telemetry()}
