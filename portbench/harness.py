"""portbench's harness: finds a cell's files by name, runs it once,
reduces the run to metrics and decides ``correct``.

Everything particular to one cell, configuration, traffic mix or metric
sits in a file of its own, found by the name that ``BENCHMARK.json``
gives it:

- ``portbench/cells/<workload>.json``: the limits of the numbers
  compared (``{"limits": {name: limit}}``);
- the configuration's ``file``: the ``model`` table the port's
  ``ModelConfig`` is built from, its ``source``, ``reduced``,
  ``assumed``, and the ``reference`` module under
  ``portbench/reference/`` that computes it plainly;
- ``portbench/traffic/<traffic>.json``: the mix's parameters, with the
  ``runner`` under ``portbench/runners/`` that drives them; a runner
  may find more files by the names its mix gives (the training runner:
  ``portbench/outputs/<reducer class>.py``);
- ``portbench/metrics/<metric>.py``: ``read(ctx)`` gives the metric's
  value from the run's readings, or ``None`` where it finds nothing.

A new cell, configuration, mix or metric is new files and new entries
in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WATCHDOG_S = 340          # a run ends within 360 s

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}
FILE_KEYS = {"cell": {"limits"},
             "config": {"name", "source", "reduced", "assumed", "reference",
                        "model"},
             "traffic": {"runner"}}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class BenchError(ValueError):
    """A benchmark file that breaks the harness's rules."""


def _name(x, what: str) -> str:
    if not isinstance(x, str) or not NAME.fullmatch(x):
        raise BenchError(f"{what}: {x!r} is not a name (letters, digits, "
                         f"_ . -, at most 64, not starting with . or -)")
    return x


def validate(bench: dict) -> dict:
    """``bench`` (BENCHMARK.json) if it keeps the rules the harness
    relies on, else :class:`BenchError`."""
    if set(bench) != TOP_KEYS:
        raise BenchError(f"BENCHMARK.json keys {sorted(bench)}, want "
                         f"{sorted(TOP_KEYS)}")
    for group, (need, may) in ENTRY_KEYS.items():
        names = set()
        for e in bench[group]:
            keys = set(e)
            if not need <= keys or keys - need - may:
                raise BenchError(f"{group} entry {e.get('name')!r}: keys "
                                 f"{sorted(keys)}, want {sorted(need)} "
                                 f"(+ {sorted(may)})")
            names.add(_name(e["name"], f"{group} name"))
            if "unit" in e and not (isinstance(e["unit"], str)
                                    and UNIT.fullmatch(e["unit"])):
                raise BenchError(f"{e['name']}: unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                raise BenchError(f"{e['name']}: better {e['better']!r}")
            if "source" in e and group != "configs" and \
                    e["source"] not in SOURCES:
                raise BenchError(f"{e['name']}: source {e['source']!r}")
            for key in ("config", "traffic"):
                if key in e:
                    _name(e[key], f"{e['name']} {key}")
            for key in e.get("reduced", ()):
                _name(key, f"{e['name']} reduced")
        if len(names) != len(bench[group]):
            raise BenchError(f"{group}: a name appears twice")
    configs = {c["name"] for c in bench["configs"]}
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        if w["config"] not in configs:
            raise BenchError(f"{w['name']}: no configuration "
                             f"{w['config']!r}")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if not set(m.get("workloads", ())) <= cells:
            raise BenchError(f"{m['name']}: unknown workloads")
        if "moves" in m and m["moves"] not in e2e:
            raise BenchError(f"{m['name']}: moves {m['moves']!r}")
    return bench


def load_json(path: Path, kind: str | None = None) -> dict:
    doc = json.loads(path.read_text())
    if kind is not None and not FILE_KEYS[kind] <= set(doc):
        raise BenchError(f"{path}: a {kind} file needs the keys "
                         f"{sorted(FILE_KEYS[kind])}")
    return doc


def load_module(path: Path):
    """The Python file at ``path`` as a module of its own."""
    if not path.is_file():
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + re.sub(r"\W", "_", str(path)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones,
    or with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Job:
    """What a runner gets: one cell's files, read, and the run's flags."""
    root: Path
    workload: dict
    config: dict
    traffic: dict
    cell: dict
    reference: object
    seed: int
    seconds: float
    trace: bool
    device: object

    @property
    def model(self) -> dict:
        return self.config["model"]


def make_job(root: Path, bench: dict, workload: str, seed: int,
             seconds: float, trace: bool, device) -> tuple:
    """(Job, runner module) of ``workload``, every file found by name."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload),
              None)
    if wl is None:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    centry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    pb = root / "portbench"
    config = load_json(root / centry["file"], "config")
    traffic = load_json(pb / "traffic" / f"{wl['traffic']}.json", "traffic")
    cell = load_json(pb / "cells" / f"{workload}.json", "cell")
    reference = load_module(pb / "reference" /
                            f"{_name(config['reference'], 'reference')}.py")
    runner = load_module(pb / "runners" /
                         f"{_name(traffic['runner'], 'runner')}.py")
    return Job(root, wl, config, traffic, cell, reference, int(seed),
               float(seconds), bool(trace), device), runner


def power_limit(index: int) -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float) -> dict:
    """One run of ``workload``: the result line as a dict (its keys in
    the order printed; ``checks`` last)."""
    import torch
    bench = validate(load_json(root / "BENCHMARK.json"))
    job, runner = make_job(root, bench, workload, seed, seconds, trace,
                           device)
    chosen = metrics_of(bench, workload, trace)
    readers = {m["name"]: load_module(root / "portbench" / "metrics" /
                                      f"{m['name']}.py") for m in chosen}
    started = time.perf_counter()
    out = runner.run(job)
    phases = {"before_runner": started - t0, **out.get("phase_s", {})}
    print(f"phases (s): {json.dumps(phases)}", file=sys.stderr)
    print(f"leaves left out of change_gap (reference gradient under 1e-3 "
          f"of the median leaf's): {out.get('excluded', [])}",
          file=sys.stderr)
    ctx = dict(out["ctx"], t0=t0)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": job.workload["chips"], **out["device"]}
    ctx["device_kind"] = dev["kind"]
    if trace and "busy_s" in ctx:
        dev.update(busy_s=ctx["busy_s"], window_s=ctx["trace_window_s"])
    metrics = {}
    for m in chosen:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = job.cell["limits"]
    checks = {}
    for k, v in out["checks"].items():
        if k not in limits:
            raise BenchError(f"{workload}: no limit for {k!r}")
        # a reading that is missing or not a number fails as inf, which
        # the line carries as a string (JSON has no infinity)
        checks[k] = {"value": v if math.isfinite(v) else str(v),
                     "limit": limits[k]}
    ok = all(math.isfinite(v) and v <= limits[k]
             for k, v in out["checks"].items())
    result = {"correct": bool(ok and out["failed"] == 0),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace and "device_ops" in ctx:
        result["breakdown"] = {"device_ops": ctx["device_ops"],
                               "idle_gaps": ctx["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None, t0: float = 0.0) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py",
                                description="Run one cell of "
                                "BENCHMARK.json once on this machine.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = validate(load_json(ROOT / "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"]
               if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # a run that hangs ends here, with every thread's stack on stderr
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (JAX or the JAX "
              f"package); no result", file=sys.stderr)
        return 3
    print(f"card: {power_limit(0)}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0
