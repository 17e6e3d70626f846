"""Readings that the limits of ``correct`` are set from; not part of a
benchmark run.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--out FILE]

Every reading is one run of the cell through ``harness.run_cell`` with a
window of 0 s (the trainer stops at the first in-transit step after
set-up), and reports the run's ``correct`` and the numbers it compared.
``--seeds`` run the program as it is. ``--control-seeds`` run it with
the control planted: the reference, in its ``CONTROL`` precision, in the
program's place underneath ``Trainer.run``. ``--fault-seeds`` run it
with each of :data:`FAULTS` planted. One JSON line per reading; the last
line sums them up (the largest of each number over the program's seeds,
the smallest over the control's and each fault's).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    _ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from portbench import harness  # noqa: E402

#: faults a training cell can have, planted underneath the timed path
FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def _flat(tree, path: str = "") -> list:
    if not isinstance(tree, dict):
        return [(path, tree)]
    out = []
    for k in sorted(tree):
        out += _flat(tree[k], f"{path}.{k}" if path else k)
    return out


@contextlib.contextmanager
def plant(fault: str, job):
    """Break the port underneath the timed path while the block runs:
    ``control``: each step's loss and gradients come from ``job``'s
    reference in its ``CONTROL`` precision, on the program's parameters
    and batch (the program's AdamW, trainer and engine stay);
    ``state_unchanged``: the optimizer step leaves parameters and moments
    as they were; ``half_batch``: each step's loss and gradients come
    from the first half of the batch's rows, the mean taken over them;
    ``answer_altered``: the in-transit norm reducer's output swaps its
    first two rows."""
    import torch
    from repro_torch.insitu import TensorNormReducer
    from repro_torch.train import optim, step
    saved = []

    def swap(obj, name, new):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, new)

    if fault == "control":
        ref, m = job.reference, job.model

        def lowered(lm, params, batch):
            paths, flat = zip(*_flat(params))
            leaves = {p: x.detach().requires_grad_(True)
                      for p, x in zip(paths, flat)}
            nll, aux = ref.loss(leaves, batch["tokens"], batch["labels"], m,
                                ref.CONTROL)
            grads = torch.autograd.grad(nll + 0.01 * aux,
                                        list(leaves.values()))
            return ({"loss": nll.detach(), "aux": aux.detach()},
                    ref.nest(dict(zip(paths, grads))))
        swap(step, "loss_and_grads", lowered)
    elif fault == "state_unchanged":
        def frozen(params, grads, opt_state, cfg):
            with torch.no_grad():
                gnorm = optim.global_norm(grads)
            s = opt_state["step"] + 1
            return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                            "step": s}, {"lr": optim.wsd_schedule(s, cfg),
                                         "grad_norm": gnorm}
        swap(optim, "adamw_step", frozen)
    elif fault == "half_batch":
        real = step.loss_and_grads

        def half(lm, params, batch):
            return real(lm, params, {k: v[:v.shape[0] // 2]
                                     for k, v in batch.items()})
        swap(step, "loss_and_grads", half)
    elif fault == "answer_altered":
        real = TensorNormReducer.reduce

        def altered(self, snap, upstream):
            out = real(self, snap, upstream)
            if len(out["stats"]) > 1:
                out["stats"] = out["stats"][[1, 0, *range(2,
                                                          len(out["stats"]))]]
            return out
        swap(TensorNormReducer, "reduce", altered)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, name, old in reversed(saved):
            setattr(obj, name, old)


def readings(root: Path, workload: str, device, seeds=(), control_seeds=(),
             fault_seeds=(), emit=print, faults=FAULTS) -> dict:
    """Run the readings; ``emit`` gets one dict per reading. Returns
    {"program": {number: largest}, "control": {number: smallest},
    fault: {number: smallest}}, each with ``runs`` and ``correct_runs``,
    the runs of that kind and how many of them were correct."""
    import gc

    import torch
    bench = harness.validate(harness.load_json(root / "BENCHMARK.json"))
    runs = [("program", s) for s in seeds] + \
        [("control", s) for s in control_seeds] + \
        [(f, s) for s in fault_seeds for f in faults]
    summary: dict = {}
    for kind, seed in runs:
        t0 = time.perf_counter()
        job = harness.make_job(root, bench, workload, seed, 0.0, False,
                               device)[0]
        with contextlib.nullcontext() if kind == "program" else \
                plant(kind, job):
            out = harness.run_cell(root, workload, seed, 0.0, False,
                                   device, t0)
        checks = {k: float(c["value"]) for k, c in out["checks"].items()}
        emit({"kind": kind, "seed": seed, "correct": out["correct"],
              "checks": checks, "seconds": time.perf_counter() - t0})
        agg = summary.setdefault(kind, {"runs": 0, "correct_runs": 0})
        agg["runs"] += 1
        agg["correct_runs"] += out["correct"]
        pick = max if kind == "program" else min
        for k, v in checks.items():
            agg[k] = pick(agg.get(k, v), v)
        del job, out
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return summary


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default=",".join(FAULTS),
                   help="the faults to plant (default: all)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]
    if not torch.cuda.is_available():
        print("calibration reads the card; no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps({"workload": args.workload, **rec})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()
    try:
        summary = readings(harness.ROOT, args.workload,
                           torch.device("cuda", 0), ints(args.seeds),
                           ints(args.control_seeds), ints(args.fault_seeds),
                           emit, [f for f in args.faults.split(",") if f])
        emit({"kind": "summary", "summary": summary})
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
