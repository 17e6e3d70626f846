"""Training loop with Hercule HProt checkpointing and fault tolerance.

Fault-tolerance surface (DESIGN.md §6):
  * periodic checkpoints (contexts) + atomic finalize, synchronous
    (``hercule.checkpoint.CheckpointManager``, which copies every shard
    to the host in ``save``) or asynchronous
    (``ckpt.AsyncCheckpointManager``, which clones on the caller's
    stream): either way the optimizer may update the state in place the
    moment ``save`` returns;
  * restore-latest on startup -> crash/restart continues bit-exactly
    (data pipeline is a pure function of step; the step counter is in
    the state; every op of the step is deterministic on the card);
  * SIGTERM/SIGINT -> synchronous final checkpoint (preemption grace);
  * optional induced crash (env TRAIN_CRASH_AT) for the supervisor demo;
  * straggler monitor: EWMA step-time watchdog, events surfaced in logs
    and metrics (on a real cluster this feeds the scheduler; here it is
    observable behavior under test).

While ``obs.TRACER`` is enabled each step leaves the spans
:meth:`Trainer._traced_step` names, with ``args["step"]`` the number
that ``submit_state`` gives the step.

The trainer runs on ``device`` (the GPU unless the caller passes
``device="cpu"``; without a GPU it raises, it never falls back), which
must be the LM's. Its state's parameters are the LM's own tensors, on
a fresh start and after a restore.
"""
from __future__ import annotations

import contextlib
import functools
import os
import signal
import tempfile
import time

import torch

from ..data.pipeline import DataConfig, TokenPipeline
from ..hercule.checkpoint import CheckpointManager
from ..insitu.device import resolve_device
from ..models import probe
from ..models.transformer import LM
from ..obs.trace import TRACER
from . import optim, step as step_lib, syncs as syncs_lib


class StragglerMonitor:
    """Flags steps slower than ``factor`` x the EWMA of recent steps."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.2, warmup: int = 3):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ewma = None
        self.count = 0
        self.events: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = self.count > self.warmup and dt > self.factor * self.ewma
        if slow:
            self.events.append((step, dt, self.ewma))
        # stragglers don't poison the baseline
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class Trainer:
    def __init__(self, lm: LM, *, opt_cfg: optim.OptConfig | None = None,
                 data_cfg: DataConfig | None = None,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 ckpt_mode: str = "raw", ncf: int = 8,
                 ckpt_async: bool = False, ckpt_delta_every: int = 0,
                 ckpt_lane_backend: str = "thread",
                 seed: int = 0, log_every: int = 10,
                 hdep_dir: str | None = None, hdep_every: int = 0,
                 insitu_dir: str | None = None, insitu_every: int = 0,
                 insitu_reducers=None, insitu_policy: str = "drop-oldest",
                 insitu_domains: int = 1, insitu_backend: str = "thread",
                 insitu_device_reduce: bool = False,
                 insitu_device_mesh=0,
                 insitu_trace_out: str | None = None,
                 ledger: bool = False, ledger_interval: float = 2.0,
                 metrics_port: int | None = None, device=None):
        """``insitu_device_mesh``: 0 (off), a shard count (N shards on
        ``device`` when one is given, else the first N GPUs) or a list of
        devices. ``ckpt_dir`` defaults to ``hx_ckpt`` in the temp
        directory."""
        self.device = resolve_device(device)
        if lm.device != self.device:
            raise ValueError(f"the LM's parameters are on {lm.device}, the "
                             f"trainer's device is {self.device}")
        self.lm = lm
        self.cfg = lm.cfg
        self.opt_cfg = opt_cfg or optim.OptConfig()
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=lm.cfg.vocab_size, seq_len=256, global_batch=8, seed=seed)
        self.pipeline = TokenPipeline(self.data_cfg)
        if ckpt_dir is None:
            ckpt_dir = os.path.join(tempfile.gettempdir(), "hx_ckpt")
        if ckpt_async:
            # HProt flow: device-side snapshot is the only train-thread
            # cost; encode/write/fsync run behind staged writer lanes,
            # with optional delta checkpoints every K saves (DESIGN.md §16)
            from ..ckpt import AsyncCheckpointManager
            self.ckpt = AsyncCheckpointManager(
                ckpt_dir, ncf=ncf, delta_every=ckpt_delta_every,
                lane_backend=ckpt_lane_backend)
        else:
            self.ckpt = CheckpointManager(ckpt_dir, ncf=ncf, mode=ckpt_mode)
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.hdep_every = hdep_every
        self.hdep = None
        if hdep_dir and hdep_every:
            from ..hercule.database import HerculeDB
            self.hdep = HerculeDB.create(hdep_dir, kind="hdep", ncf=ncf)
        self.insitu = None
        if insitu_dir and insitu_every:
            from ..insitu import (InTransitEngine, SpectraReducer,
                                  TensorNormReducer)
            reducers = insitu_reducers if insitu_reducers is not None else \
                [TensorNormReducer(), SpectraReducer(k=8)]
            # device_reduce stages the state's leaves on the trainer's
            # device (a device-to-device clone) and only the reduced
            # tensor summaries cross to the host
            mesh = insitu_device_mesh
            if isinstance(mesh, int) and mesh and device is not None:
                mesh = [self.device] * mesh
            self.insitu = InTransitEngine(
                insitu_dir, reducers, output_every=insitu_every,
                policy=insitu_policy, ncf=ncf, domains=insitu_domains,
                backend=insitu_backend,
                device_reduce="mesh" if mesh else insitu_device_reduce,
                device=self.device if insitu_device_reduce and not mesh
                else None,
                mesh_devices=mesh or None)
        # the step's spans and the engine's, written at the end
        self.insitu_trace_out = insitu_trace_out
        if insitu_trace_out:
            TRACER.enable()
        self.ledger = None
        if ledger:
            # the run ledger lives with the run's analysis output when
            # there is one, else beside the checkpoints
            from ..obs import RunLedger
            TRACER.enable()
            self.ledger = RunLedger(
                insitu_dir if self.insitu is not None else ckpt_dir,
                "trainer", interval=ledger_interval)
            if self.insitu is not None:
                self.insitu.bind_ledger(self.ledger)
            if hasattr(self.ckpt, "bind_ledger"):
                self.ckpt.bind_ledger(self.ledger)
        self.metrics_server = None
        if metrics_port is not None:
            from ..obs import serve_metrics
            self.metrics_server = serve_metrics(metrics_port)
            print(f"metrics endpoint: {self.metrics_server.url}",
                  flush=True)
        self.monitor = StragglerMonitor()
        self.seed = seed
        self._stop = False
        self.metrics_log: list[dict] = []
        self._probe = probe.StepProbe(self.device)
        self._syncs = syncs_lib.SyncCounter()

    def _install_signals(self) -> dict:
        """Set the stop handler; returns the handlers it replaced."""
        def handler(signum, frame):
            self._stop = True
        old = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not main thread (tests)
        return old

    def init_or_restore(self):
        """(state, first step): the latest complete checkpoint restored
        onto the trainer's device, else a fresh init from ``seed``."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            template = step_lib.abstract_state(self.lm, self.device)
            state, _ = self.ckpt.restore(template)
            self.lm.load_param_tree(state["params"])
            state["params"] = self.lm.param_tree()
            return state, int(latest)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        return step_lib.init_state(self.lm, gen), 0

    def _batch(self, s: int) -> dict:
        """Step ``s``'s batch on the trainer's device (int32, as the
        pipeline makes it; ``LM.loss_fn`` takes it so)."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipeline.batch(s).items()}

    def _traced_step(self, train_step, state, s: int):
        """Step ``s`` under ``TRACER``: ``train.step`` from the batch's
        build to the return of the last ``float()`` of its metrics, with
        two children, ``train.dispatch`` (the host builds the batch and
        queues the forward, backward and AdamW) and ``train.sync`` (the
        ``float()``s: the host waits for the card; mirrored into the
        profiler). ``train.step`` carries ``host_syncs`` (the card only:
        the step's synchronizing CUDA calls, ``train.syncs``) and, where
        the model routes tokens, ``moe_assigned`` and ``moe_dropped``,
        read at its end. After it, one span per marked region
        (``models.probe``), with ``args`` ``device_ms`` (the stream's
        time in the region, idle included, summed over its layers) and
        ``calls``. A region span starts at the host time of the region's
        first stamp; its length is that sum, not an interval."""
        n = s + 1
        pr = self._probe
        syncs = self._syncs.counting() if pr.cuda else \
            contextlib.nullcontext(None)
        with TRACER.span("train.step", cat="train", args={"step": n}) as sp:
            with syncs as counter, pr.active():
                with TRACER.span("train.dispatch", cat="train",
                                 args={"step": n}):
                    state, metrics = train_step(state, self._batch(s))
                with TRACER.span("train.sync", cat="train",
                                 args={"step": n}, mirror=True):
                    metrics = {k: float(v) for k, v in metrics.items()}
            if counter is not None:
                sp.set(host_syncs=counter.count)
            sp.set(**pr.moe_counts())
        for region, (ms, calls, t0) in pr.device_times().items():
            TRACER.record(region, t0, t0 + ms * 1e3, cat="train",
                          parent=sp.context(),
                          args={"step": n, "device_ms": ms,
                                "calls": calls})
        return state, metrics

    def run(self, num_steps: int, *, crash_at: int | None = None):
        old_handlers = self._install_signals()
        crash_at = crash_at if crash_at is not None else \
            int(os.environ.get("TRAIN_CRASH_AT", "0")) or None
        try:
            state, start = self.init_or_restore()
            # the step updates the state in place: nothing to donate
            train_step = step_lib.make_train_step(self.lm, self.opt_cfg)
            for s in range(start, num_steps):
                t0 = time.perf_counter()
                if TRACER.enabled:
                    state, metrics = self._traced_step(train_step, state, s)
                else:
                    state, metrics = train_step(state, self._batch(s))
                    metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                slow = self.monitor.observe(s, dt)
                metrics.update(step=s + 1, dt=dt, straggler=bool(slow))
                self.metrics_log.append(metrics)
                if self.log_every and (s + 1) % self.log_every == 0:
                    print(f"step {s+1:5d} loss {metrics['loss']:.4f} "
                          f"lr {metrics['lr']:.2e} gnorm "
                          f"{metrics['grad_norm']:.2f} {dt*1e3:.0f} ms"
                          f"{' [straggler]' if slow else ''}", flush=True)
                if crash_at and (s + 1) == crash_at:
                    print(f"induced crash at step {s+1}", flush=True)
                    os._exit(17)
                if self.insitu is not None:
                    # in-transit flow: engine decides cadence +
                    # backpressure; compute never stalls under a
                    # non-blocking policy
                    self.insitu.submit_state(s + 1, state)
                if (s + 1) % self.ckpt_every == 0 or (s + 1) == num_steps \
                        or self._stop:
                    # the checkpoint commits only once the analyses of
                    # the steps it covers did: a restart from it never
                    # leaves a hole in the catalog
                    fence = None if self.insitu is None else \
                        functools.partial(self.insitu.settle_through, s + 1)
                    self.ckpt.save(s + 1, state, fence=fence,
                                   attrs={"loss": metrics["loss"]})
                if self.hdep is not None and (s + 1) % self.hdep_every == 0:
                    self._dump_analysis(s + 1, state)
                if self._stop:
                    print(f"signal received: checkpointed at step {s+1}, "
                          f"exiting", flush=True)
                    break
            self.ckpt.wait()
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            self._syncs.uninstall()
            self._close()
        return state

    def _close(self) -> None:
        self.ckpt.close()
        if self.hdep is not None:
            self.hdep.close()
        if self.insitu is not None:
            self.insitu.close()
        if self.insitu_trace_out:
            n = TRACER.write_chrome_trace(self.insitu_trace_out)
            print(f"trace: {n} spans -> {self.insitu_trace_out}",
                  flush=True)
        if self.ledger is not None:
            verdict = self.ledger.verdict()
            self.ledger.close()
            print(f"run ledger: {self.ledger.flushes} flushes, "
                  f"verdict={verdict} -> {self.ledger.dir}", flush=True)
        if self.metrics_server is not None:
            self.metrics_server.close()

    def _dump_analysis(self, step: int, state):
        """HDep flow at its own frequency (paper fig. 1): the matrix
        parameters' host copies (``hercule.checkpoint.host_copy``:
        bfloat16 as its uint16 bits, as HProt writes it)."""
        from ..hercule import api as hercule_api
        from ..hercule.checkpoint import _leaf_paths, host_copy, leaf_name
        ctx = self.hdep.begin_context(step)
        stats = {}
        for path, leaf in _leaf_paths(state["params"]):
            if leaf.ndim >= 2:
                stats[leaf_name(path)] = host_copy(leaf)[0]
        hercule_api.write_object(ctx, "analysis", 0, stats)
        ctx.finalize(attrs={"step": step})
