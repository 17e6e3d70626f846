"""Device→host staging area for in-transit analysis (paper fig. 1).

Models Hercule's staging nodes: the compute flow hands a snapshot to the
staging area and immediately continues; the analysis flow drains it at
its own pace. Three pieces:

  * **double-buffered host buffers** — a small pool of reusable host-side
    buffer sets. The push copies device (or live host) arrays into a free
    buffer set, so compute may mutate its arrays right after ``push``
    returns and steady-state pushes reuse memory instead of allocating
    (classic double buffering: one set being filled while others are in
    flight through the queue/workers).
  * **bounded queue** — at most ``capacity`` staged snapshots wait for the
    engine; in-flight snapshots (popped, being reduced) hold their buffer
    set until :meth:`release`.
  * **explicit backpressure policy** when the queue (or buffer pool) is
    full:
      - ``block``       compute waits for space (lossless, may stall);
      - ``drop-oldest`` evict the oldest waiting snapshot, accept the new
        one (viewers always see the freshest data; compute never stalls);
      - ``subsample``   adaptively decimate the accepted cadence: a
        PID-style controller (:class:`StrideController`) watches the
        observed queue depth and steers the stride between accepted
        snapshots toward the consumer's actual drain rate (compute never
        stalls, surviving snapshots are evenly spaced in step number).
"""
from __future__ import annotations

import dataclasses
import json
import math
import multiprocessing
import os
import struct
import threading
import time

import numpy as np
import torch

POLICIES = ("block", "drop-oldest", "subsample")


class StrideController:
    """PID-style subsample-stride control from observed queue depth.

    Replaces the old heuristic (double on overflow, halve on sustained
    slack), whose step response hunted between extremes. The plant
    state is the queue fill fraction; the setpoint keeps the queue
    half full — enough slack to absorb bursts, enough depth that the
    consumer never starves. The control signal moves ``log2(stride)``,
    so corrections are multiplicative and the stride stays a positive
    integer; under constant load it converges to the consumer's service
    ratio instead of oscillating (asserted by
    ``tests/test_insitu.py::test_subsample_stride_converges``).

    ``observe(depth)`` runs once per push attempt; ``overflow()`` adds
    a hard kick when the queue actually overflowed (the integral is
    also floored at zero there — anti-windup, so a long full-queue
    episode does not leave a huge stride to unwind).

    Gain note: the output is an *increment* to log2(stride), so each
    term acts one integration higher than its name — the P term is the
    loop's integral action (the queue depth already integrates the
    accept−drain rate mismatch) and the D term its proportional
    damping. ``ki`` therefore defaults to 0: a true double-integral
    path destabilizes high service ratios; the term stays available
    for plants with persistent depth bias.
    """

    MAX_STRIDE = 1 << 16

    def __init__(self, capacity: int, *, setpoint: float = 0.5,
                 kp: float = 0.03, ki: float = 0.0, kd: float = 0.5):
        self.capacity = max(1, int(capacity))
        self.setpoint = setpoint
        self.kp, self.ki, self.kd = kp, ki, kd
        self._log = 0.0                    # log2 of the stride
        self._integral = 0.0
        self._prev: float | None = None

    @property
    def stride(self) -> int:
        return max(1, int(round(2.0 ** self._log)))

    def observe(self, depth: int) -> int:
        """Update from the current queue depth; returns the new stride."""
        err = depth / self.capacity - self.setpoint
        self._integral = min(max(self._integral + err, -4.0), 4.0)
        deriv = 0.0 if self._prev is None else err - self._prev
        self._prev = err
        u = self.kp * err + self.ki * self._integral + self.kd * deriv
        self._log = min(max(self._log + u, 0.0),
                        math.log2(self.MAX_STRIDE))
        return self.stride

    def overflow(self) -> None:
        """The queue/pool actually overflowed: step the stride up hard."""
        self._log = min(self._log + 1.0, math.log2(self.MAX_STRIDE))
        self._integral = max(self._integral, 0.0)


#: shared stride-controller state words appended to the ShmStagingArea
#: control segment: log2(stride), PID integral, previous error — Q31.32
#: fixed point in int64, with INT64_MIN marking "no sample yet"
N_CTRL_WORDS = 3
_CTRL_SCALE = float(1 << 32)
_CTRL_UNSET = np.iinfo(np.int64).min


class SharedStrideController(StrideController):
    """StrideController whose state lives in shared int64 control words.

    The multi-producer subsample fix (ROADMAP carried-over item): every
    process bound to a :class:`ShmStagingArea` — the creating producer
    and each :meth:`ShmStagingArea.attach` side — views the *same*
    three state words, so the decimation stride converges once for the
    whole producer fleet instead of independently per process (which
    made survivors unevenly spaced and double-corrected shared queue
    depth). All mutations happen inside ``_push`` under the area's
    cross-process lock; construction never resets the words, so an
    attaching producer adopts whatever stride the fleet has already
    converged to.
    """

    def __init__(self, capacity: int, words, *, setpoint: float = 0.5,
                 kp: float = 0.03, ki: float = 0.0, kd: float = 0.5):
        self._w = words
        self.capacity = max(1, int(capacity))
        self.setpoint = setpoint
        self.kp, self.ki, self.kd = kp, ki, kd

    @property
    def _log(self) -> float:
        return float(self._w[0]) / _CTRL_SCALE

    @_log.setter
    def _log(self, v: float) -> None:
        self._w[0] = int(round(v * _CTRL_SCALE))

    @property
    def _integral(self) -> float:
        return float(self._w[1]) / _CTRL_SCALE

    @_integral.setter
    def _integral(self, v: float) -> None:
        self._w[1] = int(round(v * _CTRL_SCALE))

    @property
    def _prev(self) -> float | None:
        w = int(self._w[2])
        return None if w == _CTRL_UNSET else w / _CTRL_SCALE

    @_prev.setter
    def _prev(self, v: float | None) -> None:
        self._w[2] = _CTRL_UNSET if v is None \
            else int(round(v * _CTRL_SCALE))

    def freeze(self) -> StrideController:
        """Plain host-side copy (survives segment detach/unlink)."""
        plain = StrideController(self.capacity, setpoint=self.setpoint,
                                 kp=self.kp, ki=self.ki, kd=self.kd)
        plain._log, plain._integral = self._log, self._integral
        plain._prev = self._prev
        return plain


def host_array(x) -> np.ndarray:
    """One array (torch tensor on any device, or numpy) on the host.

    ``np.asarray`` raises on a CUDA tensor, so tensors go through
    ``.cpu()`` (a no-op for CPU tensors, which are then shared). numpy
    has no bfloat16: a bfloat16 tensor lands as its float32 values,
    exactly.
    """
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def to_host(arrays: dict) -> dict[str, np.ndarray]:
    """Materialize a dict of arrays (torch or numpy) on the host."""
    return {k: host_array(v) for k, v in arrays.items()}


@dataclasses.dataclass
class Snapshot:
    """One staged unit of work: host copies of the arrays of one step.

    ``domain``/``n_domains`` identify the contributor group this part
    belongs to when the step was partitioned over groups (engine
    ``domains > 1``); reducers use them to contribute each owned element
    exactly once so per-group outputs merge back to the global answer.
    """
    step: int
    kind: str                         # "amr" (tree arrays) | "tensors"
    arrays: dict[str, np.ndarray]
    meta: dict = dataclasses.field(default_factory=dict)
    domain: int = 0                   # contributor group of this part
    n_domains: int = 1                # groups the step was split into
    _bufset: "_BufferSet | None" = None
    _slot: int | None = None          # shm slot (ShmStagingArea consumers)


class _BufferSet:
    """One reusable set of host buffers (name -> ndarray)."""

    def __init__(self):
        self.buffers: dict[str, np.ndarray] = {}

    def fill(self, arrays: dict):
        """Copy ``arrays`` (host or device) in, reusing allocations.

        Returns (staged arrays, reuses, allocs, bytes) — the caller
        folds the counters into the shared stats under its own lock.
        Subclass hook: :class:`~repro_torch.insitu.device.DeviceStagingArea`
        swaps in a device-resident buffer set with the same contract.
        """
        out = {}
        reuses = allocs = nbytes = 0
        for name, raw in arrays.items():
            src = host_array(raw)          # device arrays land here once
            dst = self.buffers.get(name)
            if dst is not None and dst.shape == src.shape \
                    and dst.dtype == src.dtype:
                np.copyto(dst, src)
                reuses += 1
            else:
                dst = np.array(src, copy=True)
                self.buffers[name] = dst
                allocs += 1
            nbytes += dst.nbytes
            out[name] = dst
        # drop buffers for names that disappeared (AMR trees change size)
        for name in list(self.buffers):
            if name not in arrays:
                del self.buffers[name]
        return out, reuses, allocs, nbytes


#: StagingStats field order — also the shm control-word stats layout of
#: :class:`_ShmStats` (one int64 word per field, block_seconds stored
#: as integer nanoseconds; DESIGN.md §15)
STAT_FIELDS = ("pushed", "accepted", "dropped", "evicted",
               "buffer_reuses", "buffer_allocs", "bytes_staged",
               "block_seconds", "popped", "released")
N_STAT_WORDS = len(STAT_FIELDS)


@dataclasses.dataclass
class StagingStats:
    pushed: int = 0
    accepted: int = 0
    dropped: int = 0          # incoming snapshots rejected (subsample/full)
    evicted: int = 0          # queued snapshots displaced (drop-oldest)
    buffer_reuses: int = 0
    buffer_allocs: int = 0
    bytes_staged: int = 0
    block_seconds: float = 0.0
    popped: int = 0           # snapshots taken by a consumer
    released: int = 0         # popped snapshots whose buffers returned

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def freeze(self) -> "StagingStats":
        return self          # already host-resident (detach idempotence)


class _ShmStats:
    """StagingStats view over shared control words (ShmStagingArea).

    Producer and every attached consumer bind the *same* int64 words,
    so counters incremented on either side of the process boundary are
    visible to both — ``stats`` is truthful from any end. All mutations
    happen under the area's cross-process lock; reads are single-word
    int64 loads (torn values impossible). ``block_seconds`` is stored
    as integer nanoseconds so it shares the int64 word layout.
    """

    __slots__ = ("_w",)

    def __init__(self, words):
        object.__setattr__(self, "_w", words)

    def __getattr__(self, name):
        try:
            i = STAT_FIELDS.index(name)
        except ValueError:
            raise AttributeError(name) from None
        v = int(self._w[i])
        return v / 1e9 if name == "block_seconds" else v

    def __setattr__(self, name, value):
        i = STAT_FIELDS.index(name)   # raises ValueError on foreign attrs
        self._w[i] = int(round(value * 1e9)) \
            if name == "block_seconds" else int(value)

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in STAT_FIELDS}

    def freeze(self) -> StagingStats:
        """Materialize a plain StagingStats (survives segment unlink)."""
        return StagingStats(**self.as_dict())


class StagingArea:
    """Bounded, policy-governed hand-off between compute and analysis."""

    #: buffer-set factory — subclasses swap the staging residency
    #: (``DeviceStagingArea`` keeps snapshots as torch tensors)
    BUFFER_SET: type = _BufferSet

    def __init__(self, *, capacity: int = 4, policy: str = "drop-oldest",
                 n_buffers: int | None = None, on_evict=None):
        assert policy in POLICIES, policy
        assert capacity >= 1
        self.capacity = capacity
        self.policy = policy
        #: called with each evicted Snapshot *after* the area lock is
        #: released (drop-oldest displacement only; push-time rejections
        #: are visible to the caller through push's return value)
        self.on_evict = on_evict
        # enough sets for every queue slot + one being filled + one being
        # reduced per consumer; sized generously by the engine.
        self._free: list[_BufferSet] = [
            self.BUFFER_SET() for _ in range(n_buffers or capacity + 2)]
        self._queue: list[Snapshot] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        self._ctrl = StrideController(capacity)   # subsample decimation
        self.stats = StagingStats()

    @property
    def stride(self) -> int:
        """Current subsample decimation stride (1 = accept every step)."""
        return self._ctrl.stride

    # -------------------------------------------------------------- push
    def push(self, step: int, arrays: dict, *, kind: str = "amr",
             meta: dict | None = None, domain: int = 0,
             n_domains: int = 1) -> bool:
        """Stage one snapshot; returns False if it was dropped.

        Never blocks unless ``policy == "block"``. The arrays are copied
        into a pooled host buffer set before return. ``on_evict``
        callbacks for drop-oldest victims fire after the lock is
        released, before push returns.
        """
        victims: list[Snapshot] = []
        try:
            return self._push(step, arrays, kind, meta, domain, n_domains,
                              victims)
        finally:
            if self.on_evict is not None:
                for v in victims:
                    self.on_evict(v)

    def _push(self, step, arrays, kind, meta, domain, n_domains,
              victims: list) -> bool:
        with self._lock:
            if self._closed:
                raise RuntimeError("staging area is closed")
            self.stats.pushed += 1
            if self.policy == "subsample":
                stride = self._ctrl.observe(len(self._queue))
                if step % stride != 0:
                    self.stats.dropped += 1
                    return False
            while len(self._queue) >= self.capacity or not self._free:
                if self.policy == "block":
                    t0 = time.perf_counter()
                    self._not_full.wait(timeout=0.5)
                    self.stats.block_seconds += time.perf_counter() - t0
                    if self._closed:
                        raise RuntimeError("staging area is closed")
                    continue
                if self.policy == "drop-oldest" and self._queue:
                    victim = self._queue.pop(0)
                    self._reclaim(victim)
                    self.stats.evicted += 1
                    victims.append(victim)
                    continue
                # subsample overflow (or drop-oldest with everything
                # in-flight): reject the incoming snapshot
                if self.policy == "subsample":
                    self._ctrl.overflow()
                self.stats.dropped += 1
                return False
            bufset = self._free.pop()
        # the (possibly large) staging copy runs without the lock so
        # consumers keep popping/releasing; the buffer set is reserved
        try:
            host, reuses, allocs, nbytes = bufset.fill(arrays)
        except BaseException:
            with self._lock:       # failed copy must not leak the pool
                self._free.append(bufset)
                self._not_full.notify()
            raise
        snap = Snapshot(step=step, kind=kind, arrays=host,
                        meta=dict(meta or {}), domain=domain,
                        n_domains=n_domains, _bufset=bufset)
        with self._lock:
            self.stats.buffer_reuses += reuses
            self.stats.buffer_allocs += allocs
            self.stats.bytes_staged += nbytes
            if len(self._queue) >= self.capacity:
                # another producer filled the queue during our copy
                if self.policy == "drop-oldest":
                    victim = self._queue.pop(0)
                    self._reclaim(victim)
                    self.stats.evicted += 1
                    victims.append(victim)
                elif self.policy != "block":
                    self._reclaim(snap)
                    self.stats.dropped += 1
                    return False
                else:
                    while len(self._queue) >= self.capacity:
                        if self._closed:
                            self._reclaim(snap)
                            raise RuntimeError("staging area is closed")
                        t0 = time.perf_counter()
                        self._not_full.wait(timeout=0.5)
                        self.stats.block_seconds += \
                            time.perf_counter() - t0
            self._queue.append(snap)
            self.stats.accepted += 1
            self._not_empty.notify()
            return True

    # --------------------------------------------------------------- pop
    def pop(self, timeout: float | None = None) -> Snapshot | None:
        """Take the oldest staged snapshot; None on timeout/close."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            while not self._queue:
                if self._closed:
                    return None
                remaining = None if deadline is None else \
                    deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(timeout=remaining if remaining is not None
                                     else 0.5)
            snap = self._queue.pop(0)
            # a queue slot opened up for block-policy producers; the
            # buffer set stays owned by the snapshot until release()
            self.stats.popped += 1
            self._not_full.notify()
            return snap

    def release(self, snap: Snapshot) -> None:
        """Return a popped snapshot's buffer set to the pool."""
        if snap._bufset is None:
            return
        with self._lock:
            self._free.append(snap._bufset)
            snap._bufset = None
            self.stats.released += 1
            self._not_full.notify()

    def _reclaim(self, snap: Snapshot) -> None:
        # caller holds the lock
        if snap._bufset is not None:
            self._free.append(snap._bufset)
            snap._bufset = None

    # ------------------------------------------------------------- admin
    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed


# ===================================================================== shm
#
# Cross-process twin of StagingArea: the slabs live in
# ``multiprocessing.shared_memory`` so a *process* lane pops snapshots
# without the producer's GIL and without any pickle round trip of the
# bulk data. Layout:
#
#   control segment (int64 words):
#     [0] closed   [1] q_head   [2] q_count   [3] n_slots
#     [4          .. 4+n)   queue ring of slot ids (oldest at q_head)
#     [4+n        .. 4+2n)  per-slot state (FREE/RESERVED/QUEUED/INFLIGHT)
#     [4+2n       .. 4+6n)  per-slot meta: step, generation, domain, kind
#     [4+6n       .. 4+6n+N_STAT_WORDS)  shared StagingStats counters
#       (STAT_FIELDS order, block_seconds as integer ns): producer and
#       consumer mutate the same words under the lock, so stats() is
#       truthful from either side of the process boundary
#     [4+6n+N_STAT_WORDS .. +N_CTRL_WORDS)  SharedStrideController state
#       (log2-stride, integral, prev-error as Q31.32 fixed point) —
#       every bound producer shares one subsample policy
#
#   one data segment per slot, resized (new generation) when a snapshot
#   outgrows it — steady-state pushes reuse the mapping, the
#   double-buffer discipline of ``_BufferSet`` carried across processes:
#     [u64 header_len][JSON header][pad to 64][array payloads, 64-aligned]
#
# The JSON header (descriptor table: name/dtype/shape/offset per array,
# plus kind/meta) is the only non-raw bytes crossing the boundary — no
# pickle anywhere on the push/pop path. push() copies each array exactly
# once, straight into the mapped slab; pop() returns zero-copy views.
#
# _push deliberately mirrors StagingArea._push's backpressure machine
# rather than sharing it: the two sit on different primitives (pooled
# ndarray buffers + threading.Condition vs shm slot states +
# multiprocessing.Condition). Keep their policy semantics in lockstep —
# tests/test_lane_backend.py enforces drop-oldest parity.

_FREE, _RESERVED, _QUEUED, _INFLIGHT = 0, 1, 2, 3
_KIND_CODES = {"amr": 0, "tensors": 1}
_KIND_NAMES = {v: k for k, v in _KIND_CODES.items()}
_ALIGN = 64


def _align(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _attach_shm(name: str, untrack: bool = False):
    """Attach an existing shared-memory segment without tracker churn.

    ``untrack`` marks an attach from a process that did not create the
    segment: on 3.13+ it skips resource-tracker registration outright
    (``track=False``). On 3.10-3.12 lane processes share the parent's
    tracker, where the duplicate registration is a set-add no-op and
    the creating side's ``unlink`` clears the single cache entry — so
    no explicit unregister is needed (or safe: it would strip the
    parent's registration, bpo-39959's other edge).
    """
    from multiprocessing import shared_memory
    if untrack:
        try:
            return shared_memory.SharedMemory(name=name, track=False)
        except TypeError:   # track= is 3.13+
            pass
    return shared_memory.SharedMemory(name=name)


class _CrashSafeCondition:
    """Condition-shaped wakeup channel a SIGKILLed waiter cannot poison.

    ``multiprocessing.Condition.notify`` blocks on a ``_woken_count``
    handshake: after releasing a sleeper it waits for that sleeper to
    acknowledge. A lane killed with SIGKILL while parked in ``wait()``
    never acknowledges, so the *notifier* — the parent, holding the
    area lock — hangs forever (and everyone behind the lock with it).
    This wrapper keeps Condition's call shape (wait under the lock,
    notify/notify_all) but signals through a bare semaphore whose
    ``release`` can never block. The trade: no exact-wakeup accounting
    — a notify with no waiter leaves a stale token (one future
    spurious wakeup), and notify_all releases a fixed burst. Both are
    harmless here because every wait site loops on its predicate with
    a bounded timeout.
    """

    def __init__(self, lock, ctx):
        self._lock = lock
        self._sem = ctx.Semaphore(0)

    def wait(self, timeout: float | None = None) -> bool:
        self._lock.release()
        try:
            return self._sem.acquire(True, timeout)
        finally:
            self._lock.acquire()

    def notify(self, n: int = 1) -> None:
        for _ in range(n):
            self._sem.release()

    def notify_all(self) -> None:
        self.notify(16)


@dataclasses.dataclass
class ShmHandle:
    """Picklable attach spec for a lane process (see ShmStagingArea)."""
    uid: str
    pid: int                 # creating process (attach untracks elsewhere)
    control: str
    n_slots: int
    capacity: int
    lock: object
    not_empty: object
    not_full: object


class ShmStagingArea:
    """StagingArea over shared memory: producer in-parent, consumer anywhere.

    Same bounded-queue/backpressure semantics as :class:`StagingArea`
    (the policies, stats and ``on_evict`` contract are identical); the
    buffer pool is a ring of shared-memory slots so the consumer side
    may be an OS process. The parent constructs it and pushes; a lane
    process calls :meth:`attach` on :meth:`handle` and pops. ``close``
    only signals; :meth:`unlink` reclaims the segments once every
    consumer detached (the owning backend calls it after joining lanes).
    """

    def __init__(self, *, capacity: int = 4, policy: str = "drop-oldest",
                 n_slots: int | None = None, on_evict=None,
                 min_slot_bytes: int = 1 << 16, mp_context=None,
                 sync=None):
        from multiprocessing import shared_memory
        assert policy in POLICIES, policy
        assert capacity >= 1
        self.capacity = capacity
        self.policy = policy
        self.on_evict = on_evict
        self.min_slot_bytes = min_slot_bytes
        n = n_slots or capacity + 2
        ctx = mp_context or multiprocessing.get_context("spawn")
        self._uid = f"hx{os.getpid():x}_{os.urandom(4).hex()}"
        self._shm = shared_memory.SharedMemory(
            create=True,
            size=(4 + 6 * n + N_STAT_WORDS + N_CTRL_WORDS) * 8,
            name=f"{self._uid}ctl")
        if sync is not None:
            # externally owned primitives (the persistent lane pool:
            # a pooled lane inherited them at spawn, long before this
            # area existed — see insitu.lanes.LanePool)
            self._lock, self._not_empty, self._not_full = sync
        else:
            self._lock = ctx.Lock()
            self._not_empty = _CrashSafeCondition(self._lock, ctx)
            self._not_full = _CrashSafeCondition(self._lock, ctx)
        self._bind(self._shm, n)
        self._words[:] = 0
        self._words[3] = n
        self._ctrl._prev = None   # restore the "no sample yet" sentinel
        #: producer-side segment cache: slot -> (gen, SharedMemory)
        self._segs: dict[int, tuple[int, object]] = {}
        self._consumer = False
        self._untrack = False

    @property
    def stride(self) -> int:
        """Current subsample decimation stride (1 = accept every step).

        Shared across every bound producer: the controller state lives
        in the segment's control words (:class:`SharedStrideController`).
        """
        return self._ctrl.stride

    def _bind(self, ctrl, n: int) -> None:
        self.n_slots = n
        self._words = np.ndarray(
            (4 + 6 * n + N_STAT_WORDS + N_CTRL_WORDS,), np.int64,
            buffer=ctrl.buf)
        self._ring = self._words[4:4 + n]
        self._state = self._words[4 + n:4 + 2 * n]
        self._meta = self._words[4 + 2 * n:4 + 6 * n].reshape(n, 4)
        # both ends mutate the same counters (under the shared lock)
        self.stats = _ShmStats(
            self._words[4 + 6 * n:4 + 6 * n + N_STAT_WORDS])
        # ... and the same subsample-stride state (multi-producer policy)
        self._ctrl = SharedStrideController(
            self.capacity, self._words[4 + 6 * n + N_STAT_WORDS:])

    # ---------------------------------------------------------- handle
    def handle(self) -> ShmHandle:
        return ShmHandle(uid=self._uid, pid=os.getpid(),
                         control=self._shm.name,
                         n_slots=self.n_slots, capacity=self.capacity,
                         lock=self._lock, not_empty=self._not_empty,
                         not_full=self._not_full)

    def spec(self) -> dict:
        """Primitive-free attach spec (queue-transportable).

        ``multiprocessing`` locks/conditions only pickle during process
        *creation* — a handle sent over a queue to an already-running
        pooled lane must not carry them. The lane rebuilds a full
        :class:`ShmHandle` from this spec plus the sync primitives it
        inherited at spawn (the same objects this area was constructed
        with via ``sync=``; see ``insitu.lanes.LanePool``).
        """
        return {"uid": self._uid, "pid": os.getpid(),
                "control": self._shm.name, "n_slots": self.n_slots,
                "capacity": self.capacity}

    @staticmethod
    def handle_from_spec(spec: dict, sync) -> ShmHandle:
        """Rebuild an attachable handle from :meth:`spec` + inherited sync."""
        lock, not_empty, not_full = sync
        return ShmHandle(uid=spec["uid"], pid=spec["pid"],
                         control=spec["control"], n_slots=spec["n_slots"],
                         capacity=spec["capacity"], lock=lock,
                         not_empty=not_empty, not_full=not_full)

    @classmethod
    def attach(cls, handle: ShmHandle) -> "ShmStagingArea":
        """Consumer-side view (a lane process): pop/release/close only."""
        self = cls.__new__(cls)
        self._uid = handle.uid
        self.capacity = handle.capacity
        self._untrack = handle.pid != os.getpid()
        self._shm = _attach_shm(handle.control, self._untrack)
        self._lock = handle.lock
        self._not_empty = handle.not_empty
        self._not_full = handle.not_full
        self._bind(self._shm, handle.n_slots)
        self._segs = {}
        self.on_evict = None
        self._consumer = True
        return self

    # -------------------------------------------------------------- push
    def push(self, step: int, arrays: dict, *, kind: str = "amr",
             meta: dict | None = None, domain: int = 0,
             n_domains: int = 1) -> bool:
        victims: list[Snapshot] = []
        try:
            return self._push(step, arrays, kind, meta, domain, n_domains,
                              victims)
        finally:
            if self.on_evict is not None:
                for v in victims:
                    self.on_evict(v)

    def _evict_oldest(self, victims: list) -> None:
        # caller holds the lock; q_count > 0
        slot = int(self._ring[self._words[1]])
        vstep, _, vdom, vkind = (int(x) for x in self._meta[slot])
        self._words[1] = (self._words[1] + 1) % self.n_slots
        self._words[2] -= 1
        self._state[slot] = _FREE
        self.stats.evicted += 1
        victims.append(Snapshot(step=vstep, arrays={},
                                kind=_KIND_NAMES.get(vkind, "amr"),
                                domain=vdom))

    def _data_name(self, slot: int, gen: int) -> str:
        return f"{self._uid}s{slot}g{gen}"

    def _wait_block(self) -> None:
        t0 = time.perf_counter()
        self._not_full.wait(timeout=0.5)
        self.stats.block_seconds += time.perf_counter() - t0

    def _push(self, step, arrays, kind, meta, domain, n_domains,
              victims: list) -> bool:
        with self._lock:
            if self._words[0]:
                raise RuntimeError("staging area is closed")
            self.stats.pushed += 1
            if self.policy == "subsample":
                stride = self._ctrl.observe(int(self._words[2]))
                if step % stride != 0:
                    self.stats.dropped += 1
                    return False
            while True:
                free = np.flatnonzero(self._state == _FREE)
                if self._words[2] < self.capacity and free.size:
                    break
                if self.policy == "block":
                    self._wait_block()
                    if self._words[0]:
                        raise RuntimeError("staging area is closed")
                    continue
                if self.policy == "drop-oldest" and self._words[2]:
                    self._evict_oldest(victims)
                    continue
                if self.policy == "subsample":
                    self._ctrl.overflow()
                self.stats.dropped += 1
                return False
            slot = int(free[0])
            self._state[slot] = _RESERVED
        # the (possibly large) copy into the slab runs without the lock
        try:
            gen, nbytes, reused = self._fill(slot, step, arrays, kind,
                                             meta, domain, n_domains)
        except BaseException:
            with self._lock:
                self._state[slot] = _FREE
                self._not_full.notify()
            raise
        with self._lock:
            self.stats.buffer_reuses += int(reused)
            self.stats.buffer_allocs += int(not reused)
            self.stats.bytes_staged += nbytes
            if self._words[2] >= self.capacity:
                # another producer filled the queue during our copy
                if self.policy == "drop-oldest":
                    self._evict_oldest(victims)
                elif self.policy != "block":
                    self._state[slot] = _FREE
                    self.stats.dropped += 1
                    return False
                else:
                    while self._words[2] >= self.capacity:
                        if self._words[0]:
                            self._state[slot] = _FREE
                            raise RuntimeError("staging area is closed")
                        self._wait_block()
            self._meta[slot] = (step, gen, domain,
                                _KIND_CODES.get(kind, 0))
            self._ring[(self._words[1] + self._words[2]) % self.n_slots] \
                = slot
            self._words[2] += 1
            self._state[slot] = _QUEUED
            self.stats.accepted += 1
            self._not_empty.notify()
            return True

    def _fill(self, slot: int, step, arrays, kind, meta, domain,
              n_domains) -> tuple[int, int, bool]:
        """Copy one snapshot into the slot's slab; returns (gen, bytes,
        reused) — ``reused`` False when the slab had to grow."""
        from multiprocessing import shared_memory
        host = [(name, np.ascontiguousarray(a))
                for name, a in to_host(arrays).items()]
        descs, off = [], 0
        for name, a in host:
            off = _align(off)
            descs.append({"name": name, "dtype": str(a.dtype),
                          "shape": list(a.shape), "offset": off})
            off += a.nbytes
        header = json.dumps({
            "step": int(step), "kind": kind, "meta": dict(meta or {}),
            "domain": int(domain), "n_domains": int(n_domains),
            "arrays": descs}).encode()
        base = _align(8 + len(header))
        total = base + off
        ent = self._segs.get(slot)
        reused = ent is not None and ent[1].size >= total
        if not reused:
            gen = ent[0] + 1 if ent else 0
            if ent:
                ent[1].close()
                ent[1].unlink()
            size = max(total + total // 4, self.min_slot_bytes)
            seg = shared_memory.SharedMemory(
                create=True, size=size, name=self._data_name(slot, gen))
            self._segs[slot] = (gen, seg)
        gen, seg = self._segs[slot]
        buf = seg.buf
        struct.pack_into("<Q", buf, 0, len(header))
        buf[8:8 + len(header)] = header
        nbytes = 0
        for d, (_, a) in zip(descs, host):
            dst = np.ndarray(a.shape, a.dtype, buffer=buf,
                             offset=base + d["offset"])
            np.copyto(dst, a)
            nbytes += a.nbytes
        return gen, nbytes, reused

    # --------------------------------------------------------------- pop
    def _slot_views(self, slot: int, gen: int):
        ent = self._segs.get(slot)
        if ent is None or ent[0] != gen:
            if ent is not None:
                # a released-but-still-referenced snapshot (the lane
                # loop's previous iteration) may export views of the old
                # generation; tolerate it — the mapping falls with the
                # last view
                self._close_seg(ent[1])
            seg = _attach_shm(self._data_name(slot, gen), self._untrack)
            self._segs[slot] = (gen, seg)
        _, seg = self._segs[slot]
        buf = seg.buf
        (hlen,) = struct.unpack_from("<Q", buf, 0)
        head = json.loads(bytes(buf[8:8 + hlen]).decode())
        base = _align(8 + hlen)
        arrays = {}
        for d in head["arrays"]:
            arrays[d["name"]] = np.ndarray(
                tuple(d["shape"]), np.dtype(d["dtype"]), buffer=buf,
                offset=base + d["offset"])
        return head, arrays

    def pop(self, timeout: float | None = None) -> Snapshot | None:
        """Oldest queued snapshot as zero-copy views into its slab."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            while not self._words[2]:
                if self._words[0]:
                    return None
                remaining = None if deadline is None else \
                    deadline - time.perf_counter()
                if remaining is not None and remaining <= 0:
                    return None
                self._not_empty.wait(
                    timeout=remaining if remaining is not None else 0.5)
            slot = int(self._ring[self._words[1]])
            self._words[1] = (self._words[1] + 1) % self.n_slots
            self._words[2] -= 1
            self._state[slot] = _INFLIGHT
            gen = int(self._meta[slot][1])
            self.stats.popped += 1
            self._not_full.notify()
        head, arrays = self._slot_views(slot, gen)
        return Snapshot(step=head["step"], kind=head["kind"], arrays=arrays,
                        meta=head["meta"], domain=head["domain"],
                        n_domains=head["n_domains"], _slot=slot)

    def release(self, snap: Snapshot) -> None:
        """Return a popped snapshot's slab to the ring.

        The snapshot's arrays are views into the slab — they must not be
        used after release (the producer may refill the slot at once).
        """
        if snap._slot is None:
            return
        with self._lock:
            self._state[snap._slot] = _FREE
            snap._slot = None
            self.stats.released += 1
            self._not_full.notify()

    # ------------------------------------------------------------- admin
    def __len__(self) -> int:
        with self._lock:
            return int(self._words[2])

    @property
    def closed(self) -> bool:
        return bool(self._words[0])

    def close(self) -> None:
        """Signal producers/consumers; segments survive until unlink()."""
        with self._lock:
            self._words[0] = 1
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @staticmethod
    def _close_seg(seg) -> None:
        try:
            seg.close()
        except BufferError:
            pass   # a live view still exports the mapping; unlink works

    def detach(self) -> None:
        """Consumer side: drop the segment mappings (no unlink)."""
        for _, seg in self._segs.values():
            self._close_seg(seg)
        self._segs.clear()
        # drop numpy views before closing the mapping they alias; stats
        # and stride state stay readable as frozen host-side copies
        self.stats = self.stats.freeze()
        self._ctrl = self._ctrl.freeze()
        self._words = self._ring = self._state = self._meta = None
        self._close_seg(self._shm)

    def unlink(self) -> None:
        """Owner side: reclaim every shared-memory segment.

        Call after all consumers detached (on Linux their live mappings
        stay valid; the names are gone for new attaches).
        """
        if self._consumer:
            raise RuntimeError("only the creating side may unlink")
        for _, seg in self._segs.values():
            self._close_seg(seg)
            seg.unlink()
        self._segs.clear()
        self.stats = self.stats.freeze()
        self._ctrl = self._ctrl.freeze()
        self._words = self._ring = self._state = self._meta = None
        self._close_seg(self._shm)
        self._shm.unlink()
