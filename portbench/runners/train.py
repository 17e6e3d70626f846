"""The runner of training mixes: one trainer in a closed loop.

It builds the port's ``Trainer`` as ``repro_torch.launch.train`` does,
with the benchmark's own weights (drawn on the device from the seed by
the reference's ``make_params``) and token stream, and with the
in-transit engine that the mix's ``insitu`` table names (its reducers by
their class names in ``repro_torch.insitu``; no table, no engine). Each
reducer's output is checked by ``portbench/outputs/<class>.py``.
``Trainer.run`` is the timed call:
its first ``warm_steps`` steps are set-up, and the window takes the
steps after them until ``--seconds`` have passed. The trainer's own
clock hook (``Trainer.monitor``, called after each step's ``float()``
sync) marks each step's end; the window ends at the end of the last
step that finished in time, and the trainer stops at the first
in-transit step after that, so the last output holds the final state.
After the window the program is freed and the plain reference retrains
the warm steps from the same seed.
"""
from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time

import torch

from portbench import harness, yardstick


class _NoSave:
    """Stands in for the trainer's checkpoint manager: the mix makes no
    HProt saves (a save of the state is 16-20 GB, past a run's disk
    allowance), so the save the trainer makes when it stops does
    nothing."""

    def save(self, step, state, *, fence=None, attrs=None):
        pass

    def wait(self):
        pass

    def close(self):
        pass


class _Clock:
    """The trainer's step hook (``observe(step index, dt)``): takes the
    first-step and set-up readings, opens and closes the window."""

    def __init__(self, job, trainer, stream_params, every: int):
        self.job, self.trainer = job, trainer
        self.remake = stream_params          # () -> the seed's weights
        self.warm = job.traffic["warm_steps"]
        self.every = every                   # 0: no in-transit steps
        self.ends: list[float] = []          # window step ends, host clock
        self.start = self.deadline = None
        self.closed_at = None        # steps done when the window closed
        self.grad_norm: dict = {}
        self.change_norm: dict = {}
        self.setup_peak = self.window_peak = 0
        self.prof = self.marker = None
        self.reading_s = 0.0                 # set-up spent on readings

    def _sync(self):
        if self.job.device.type == "cuda":
            torch.cuda.synchronize(self.job.device)

    @torch.no_grad()
    def _first_step(self, state):
        t = time.perf_counter()
        b1 = self.job.traffic["optimizer"]["b1"]
        for path, mu in _leaves(state["mu"]):
            self.grad_norm[path] = float(mu.double().norm()) / (1 - b1)
        self.reading_s += time.perf_counter() - t

    @torch.no_grad()
    def _set_up_done(self, state):
        t = time.perf_counter()
        p0 = self.remake()
        for path, p in _leaves(state["params"]):
            self.change_norm[path] = float((p - p0[path]).double().norm())
        del p0
        self.reading_s += time.perf_counter() - t

    def observe(self, s: int, dt: float) -> bool:
        n = s + 1
        state = self.trainer.bench_state
        if n == 1:
            self._first_step(state)
        if self.job.trace and n == self.warm - 1:
            # the profiler starts inside set-up, so its own start-up
            # (CUPTI) is not in the window
            self.prof = _profiler(self.job.device)
            self.prof.start()
        if n == self.warm:
            self._set_up_done(state)
            self._sync()
            if self.job.device.type == "cuda":
                self.setup_peak = torch.cuda.max_memory_allocated(
                    self.job.device)
                torch.cuda.reset_peak_memory_stats(self.job.device)
            if self.prof is not None:
                self.marker = torch.autograd.profiler.record_function(
                    "portbench.window")
                self.marker.__enter__()
            self.start = time.perf_counter()
            self.deadline = self.start + self.job.seconds
            return False
        if self.start is None:
            return False
        now = time.perf_counter()
        if self.closed_at is None:
            if now <= self.deadline:
                self.ends.append(now)
                return False
            self.closed_at = n
            if self.job.device.type == "cuda":
                self.window_peak = torch.cuda.max_memory_allocated(
                    self.job.device)
            if self.prof is not None:
                self.marker.__exit__(None, None, None)
                self.prof.stop()
        if not self.every or n % self.every == 0:
            self.trainer._stop = True
        return False


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _leaves(tree, path: str = ""):
    if not isinstance(tree, dict):
        return [(path, tree)]
    out = []
    for k in sorted(tree):
        out += _leaves(tree[k], f"{path}.{k}" if path else k)
    return out


def _trace_readings(prof) -> dict:
    """Busy time, idle gaps and the heaviest device ops of the window
    marked ``portbench.window`` in a profiler run, read from Kineto's
    raw events (building the profiler's own event tree takes minutes
    for a window of a MoE model's kernels)."""
    from torch.autograd import DeviceType
    mark = "portbench.window"
    lo = hi = None
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name, s, t = e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            # the window's own range is mirrored on the device's track
            if name != mark and not e.is_user_annotation():
                dev.append((s, t, name))
        elif name == mark:
            lo, hi = s, t
        else:
            host.append((s, t, name, e.start_thread_id()))
    if lo is None or not dev:
        return {}
    iv = [(s, t) for s, t, _ in dev]
    ops = [(n, min(t, hi) - max(s, lo)) for s, t, n in dev
           if min(t, hi) > max(s, lo)]
    host = yardstick.HostOps(yardstick.outermost(host))
    gaps = [(host.during(g), g[1] - g[0])
            for g in yardstick.idle_gaps(iv, lo, hi)]
    return {"busy_s": yardstick.union_length(iv, lo, hi),
            "trace_window_s": hi - lo,
            "device_ops": [[n[:160], v] for n, v in
                           yardstick.top_by_name(ops)],
            "idle_gaps": [[n[:160], v] for n, v in
                          yardstick.top_by_name(gaps)]}


def run(job) -> dict:
    """One run of a training cell: returns the run's readings for the
    harness (metric context, attempted/failed, compared numbers)."""
    import repro_torch.insitu as insitu
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import LM
    from repro_torch.obs.trace import TRACER
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer

    tr, m, ref = job.traffic, job.model, job.reference
    dev = job.device
    tmp = tempfile.mkdtemp(prefix="portbench-")
    phase, t = {}, time.perf_counter()
    try:
        stream = yardstick.TokenStream(m["vocab_size"], tr["seq_len"],
                                       tr["global_batch"], job.seed,
                                       tr["zipf"])

        def weights():
            return ref.make_params(m, job.seed, dev)

        cfg = ModelConfig(**m)
        lm = LM(cfg, device=dev)
        w = weights()
        lm.load_param_tree(ref.nest(w))
        del w
        phase["model_and_weights"] = time.perf_counter() - t
        t = time.perf_counter()

        class _Trainer(Trainer):
            def init_or_restore(self):
                # the benchmark's weights, already in the LM: a fresh
                # start, no restore and no init of the trainer's own
                params = self.lm.param_tree()
                self.bench_state = {"params": params,
                                    **optim.init_opt_state(params)}
                return self.bench_state, 0

        ins = tr.get("insitu")               # no table: no engine
        classes = ins["reducers"] if ins else []
        reducers = [getattr(insitu, c)() for c in classes]
        outputs = {r.name: harness.load_module(
            job.root / "portbench" / "outputs" / f"{c}.py")
            for r, c in zip(reducers, classes)}
        every = ins["every"] if ins else 0
        if ins and not 0 < every <= tr["warm_steps"]:
            raise ValueError("the mix's first in-transit output must fall "
                             "in its warm steps, which the reference "
                             "follows")
        engine = dict(insitu_dir=os.path.join(tmp, "insitu"),
                      insitu_every=every, insitu_reducers=reducers,
                      insitu_policy=ins["policy"],
                      insitu_device_reduce=ins["device_reduce"]) \
            if ins else {}
        trainer = _Trainer(
            lm, opt_cfg=optim.OptConfig(**tr["optimizer"]),
            data_cfg=DataConfig(vocab_size=m["vocab_size"],
                                seq_len=tr["seq_len"],
                                global_batch=tr["global_batch"],
                                seed=job.seed, zipf=tr["zipf"]),
            ckpt_dir=os.path.join(tmp, "ckpt"), log_every=0,
            seed=job.seed, device=dev, **engine)
        trainer.ckpt.close()
        trainer.ckpt = _NoSave()
        trainer.pipeline = stream
        clock = _Clock(job, trainer, weights, every)
        trainer.monitor = clock
        phase["trainer"] = time.perf_counter() - t
        if job.trace:
            TRACER.clear()
            TRACER.enable()
        t_steps = time.perf_counter()
        trainer.run(10 ** 9)
        TRACER.disable()
        phase.update(warm_steps=clock.start - t_steps - clock.reading_s,
                     setup_readings=clock.reading_s,
                     past_window=time.perf_counter() - clock.deadline)
        state = trainer.bench_state
        losses = [x["loss"] for x in trainer.metrics_log]
        last = len(losses)          # the final step (an in-transit one)
        counted = len(clock.ends)
        window_steps = range(clock.warm + 1, clock.warm + counted + 1)

        # every in-transit step must be committed and read back
        due = list(range(every, last + 1, every)) if every else []
        due_window = [s for s in window_steps if s in due]
        committed = set()
        first_out = final_out = {}
        if ins:
            cat = insitu.Catalog(os.path.join(tmp, "insitu"))
            committed = set(cat.steps())

            def read_outputs(step):
                made = cat.reducers(step) if step in committed else ()
                return {n: chk.table(cat.query(step, n))
                        for n, chk in outputs.items() if n in made}
            first_out, final_out = read_outputs(every), read_outputs(last)
            cat.close()
        missing = [s for s in due if s not in committed]
        final_flat = dict(_leaves(state["params"]))
        final_ref = {n: chk.expect(final_flat)
                     for n, chk in outputs.items()}
        del final_flat
        flops = tr["global_batch"] * tr["seq_len"] * \
            ref.train_flops_per_token(m, tr["seq_len"])
        ctx = {"setup_end": clock.start, "window_ends": list(clock.ends),
               "tokens_per_step": tr["global_batch"] * tr["seq_len"],
               "flops_per_step": flops,
               "window_peak_bytes": clock.window_peak}
        if job.trace:
            ctx["spans"] = [sp for sp in TRACER.spans()
                            if sp["args"].get("step") in due_window]
            if clock.prof is not None:
                t = time.perf_counter()
                ctx.update(_trace_readings(clock.prof))
                phase["trace_reading"] = time.perf_counter() - t
        TRACER.clear()
        peak = max(clock.setup_peak, clock.window_peak)
        window_losses = losses[clock.warm:clock.warm + counted]
        attempted = counted + len(due_window)
        failed = sum(not math.isfinite(x) for x in window_losses) + \
            sum(s in missing for s in due_window)
        prog = {"loss": losses[:clock.warm], "grad_norm": clock.grad_norm,
                "change_norm": clock.change_norm}

        # the program is freed before the reference runs
        del state, trainer, lm, clock
        TRACER.clear()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        batches = []
        for s in range(tr["warm_steps"]):
            b = stream.batch(s)
            batches.append((torch.from_numpy(b["tokens"]).to(dev),
                            torch.from_numpy(b["labels"]).to(dev)))

        def observe(step, params):
            if step != every:
                return None
            return {n: chk.expect(params) for n, chk in outputs.items()}
        t = time.perf_counter()
        r = ref.train(m, tr["optimizer"], weights(), batches,
                      observe=observe)
        phase["reference"] = time.perf_counter() - t
        med = sorted(r["grad_norm"].values())[len(r["grad_norm"]) // 2]
        moved = {k for k, v in r["grad_norm"].items() if v >= 1e-3 * med}
        checks = {
            "loss_gap": yardstick.rel_gap(prog["loss"], r["loss"]),
            "grad_gap": yardstick.gap_of_norms(prog["grad_norm"],
                                               r["grad_norm"]),
            "change_gap": yardstick.gap_of_norms(prog["change_norm"],
                                                 r["change_norm"], moved),
        }
        for n, chk in outputs.items():
            checks[f"{n}_gap"] = chk.gap(first_out.get(n, {}),
                                         r["observed"][every][n])
            checks[f"{n}_final_gap"] = chk.gap(final_out.get(n, {}),
                                               final_ref[n])
        if ins:
            checks["outputs_missing"] = float(len(missing))
        device = {"memory_peak_bytes": int(peak)}
        return {"ctx": ctx, "phase_s": phase, "attempted": attempted,
                "failed": failed, "checks": checks, "device": device,
                "excluded": sorted(set(r["grad_norm"]) - moved)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
