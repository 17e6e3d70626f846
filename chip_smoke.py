#!/usr/bin/env python3
"""GPU smoke run of the ``repro_torch`` port: ``python3 chip_smoke.py``.

Needs one CUDA card and the repository checkout around this file; exits
non-zero (and prints no result) otherwise, or on any failure.

  1. prints the card's name and power limit, builds the CUDA raster
     kernels from ``src/repro_torch/kernels/csrc`` and prints the build
     seconds;
  2. kernel parity: each of B1-B3 (slice, projection, per-level
     histogram) against its plain torch twin on the card, bitwise, and
     against the port's host numpy reducers — on small Sedov trees
     (R=16 and 64; R=16 forces sub-pixel collisions), on an owner-masked
     3-way partition, and on the full Orion tree (649,385 nodes, R=512);
  3. main path: ``InTransitEngine(device_reduce=True, device="cuda")``
     over the Orion tree with the 512-res slice/projection/histogram DAG,
     then the CLI's default DAG (LOD cut, slice, slice-of-LOD,
     projection, auto-bounds histogram) on Sedov steps, through the
     engine and through ``python -m repro_torch.launch.insitu``. Each
     catalog must be bit-equal to a host-engine run, no snapshot may fall
     back to the host, and every kernel's launch counter must move;
  4. times at the full size: the device-reduce wall per step and bytes
     to the host per step, where a step's time goes (the engine's spans
     and the device's busy time from ``torch.profiler``), and, with CUDA
     events, each kernel, its plain twin and its bound.

The line before the last is the per-kernel JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and FP64 (non-tensor) peak
MEM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12

KERNELS = {
    "slice_raster": "src/repro/kernels/raster_kernel.py:136",
    "projection_raster": "src/repro/kernels/raster_kernel.py:240",
    "level_hist": "src/repro/kernels/raster_kernel.py:320",
}
SOURCE = "src/repro_torch/kernels/csrc/raster.cu"

ORION_STEPS = 3          # timed main-path steps (after one warm-up step)
LIVE_RESOLUTION = 512


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


# ------------------------------------------------------------- inputs

def orion_tree():
    from repro_torch.sim import amrgen, fields
    return amrgen.generate_tree(fields.orion(seed=7), min_level=3,
                                max_level=9, threshold=1.0, level_factor=1.6)


def random_sedov_tree(seed: int):
    """A Sedov AMR structure carrying random (sign-mixed) field values."""
    import numpy as np

    from repro_torch.sim import amrgen, fields
    rng = np.random.default_rng(seed)
    tree = amrgen.generate_tree(
        fields.sedov(r_shock=0.2 + 0.1 * rng.random()),
        min_level=2, max_level=5, threshold=1.2)
    tree.fields["density"] = rng.standard_normal(tree.n_nodes) * 4.0 + 1.0
    return tree


def live_reducers():
    """512-res reduction-bound DAG (``benchmarks/bench_insitu``'s)."""
    from repro_torch.insitu import (LevelHistogramReducer, ProjectionReducer,
                                    SliceReducer)
    return [SliceReducer(field="density", axis=2, position=0.5,
                         resolution=LIVE_RESOLUTION),
            ProjectionReducer(field="density", resolution=LIVE_RESOLUTION),
            LevelHistogramReducer(field="density", bins=64, lo=0.0, hi=50.0)]


def kernel_inputs(arrays: dict, device, *, n_domains: int = 1, axis: int = 2):
    """The kernels' inputs exactly as ``kernels.ops`` builds them from a
    staged snapshot's ``DeviceTree``."""
    import torch

    from repro_torch.insitu.device import DeviceTree, to_device
    from repro_torch.kernels import ops
    dt = DeviceTree(to_device(arrays, device), n_domains)
    return {"coords2": ops.plane_coords(dt.coords, axis),
            "c_axis": dt.coords[:, axis], "levels": dt.levels.to(torch.int32),
            "values": dt.field("density"), "ok": dt.ok,
            "n_levels": dt.n_levels}


# ------------------------------------------------------------- parity

def _bits(t):
    import torch
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _max_abs_err(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    diff = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(diff, nan=math.inf).max()) \
        if diff.numel() else 0.0


def check_parity(label: str, arrays: dict, device, *, resolution: int,
                 bins: int, lo, hi, n_domains: int = 1, domain: int = 0):
    """B1-B3 vs their plain twins (bitwise) and vs the host reducers."""
    import numpy as np
    import torch

    from repro_torch.insitu.reducers import (LevelHistogramReducer,
                                             ProjectionReducer, ReducerDAG,
                                             SliceReducer)
    from repro_torch.insitu.staging import Snapshot
    from repro_torch.kernels import raster, ref
    x = kernel_inputs(arrays, device, n_domains=n_domains)
    L = x["n_levels"]
    geo = dict(resolution=resolution, n_levels=L)
    hist_r = LevelHistogramReducer(field="density", bins=bins, lo=lo, hi=hi)
    host = ReducerDAG([
        SliceReducer(field="density", axis=2, position=0.5,
                     resolution=resolution),
        ProjectionReducer(field="density", axis=2, resolution=resolution),
        hist_r]).run(Snapshot(step=0, kind="amr", arrays=arrays,
                              domain=domain, n_domains=n_domains))
    host = {k.split("-")[0]: v for k, v in host.items()}
    edges = torch.from_numpy(host["hist"]["edges"]).to(device)
    n_hist = min(L, hist_r.max_levels)
    runs = {
        "slice_raster": (
            lambda f: f(x["coords2"], x["c_axis"], x["levels"], x["values"],
                        x["ok"], position=0.5, **geo),
            raster.slice_raster, ref.slice_raster_ref,
            host["slice"]["image"]),
        "projection_raster": (
            lambda f: f(x["coords2"], x["levels"], x["values"], x["ok"],
                        **geo),
            raster.projection_raster, ref.projection_raster_ref,
            host["proj"]["image"]),
        "level_hist": (
            lambda f: f(x["values"], x["levels"], x["ok"], edges,
                        n_levels=n_hist),
            raster.level_hist, ref.level_hist_ref, host["hist"]["hist"]),
    }
    errs = {}
    for name, (call, kern, plain, want) in runs.items():
        got, twin = call(kern), call(plain)
        torch.cuda.synchronize()
        if got.dtype != twin.dtype or got.shape != twin.shape or \
                not torch.equal(_bits(got), _bits(twin)):
            raise AssertionError(f"{label}: {name} differs from its plain "
                                 f"twin (max abs err "
                                 f"{_max_abs_err(got, twin)})")
        g = got.cpu().numpy()
        if g.dtype == np.float64:
            same = np.array_equal(g.view(np.int64),
                                  np.asarray(want).view(np.int64))
        else:
            same = np.array_equal(g, want)
        if not same:
            raise AssertionError(f"{label}: {name} differs from the host "
                                 f"reducer")
        errs[name] = _max_abs_err(got, twin)
    print(f"parity {label}: B1-B3 bit-equal to plain twins and host "
          f"reducers (R={resolution}, {x['values'].shape[0]} padded rows)")
    return errs, x, edges, n_hist


# ----------------------------------------------------------- main path

def catalogs_equal(root_a: str, root_b: str) -> int:
    """Bitwise catalog comparison; returns the number of arrays checked."""
    import numpy as np

    from repro_torch.insitu import Catalog
    ca, cb = Catalog(root_a), Catalog(root_b)
    try:
        if ca.steps() != cb.steps() or not ca.steps():
            raise AssertionError(f"catalog steps differ: {ca.steps()} vs "
                                 f"{cb.steps()}")
        n = 0
        for s in ca.steps():
            if ca.reducers(s) != cb.reducers(s):
                raise AssertionError(f"step {s}: reducers differ")
            for r in ca.reducers(s):
                a, b = ca.query(s, r), cb.query(s, r)
                if set(a) != set(b):
                    raise AssertionError(f"step {s} {r}: keys differ")
                for k, v in a.items():
                    w = b[k]
                    if v.dtype != w.dtype or v.shape != w.shape or \
                            v.tobytes() != w.tobytes():
                        raise AssertionError(f"step {s} {r}/{k} differs")
                    n += 1
        return n
    finally:
        ca.close()
        cb.close()


def run_engine(root: str, reducers, payloads, *, device, block=True):
    """Submit ``payloads`` (step -> arrays) and drain; returns the engine
    and the wall seconds of every submit+drain, per step."""
    import torch

    from repro_torch.insitu import InTransitEngine
    eng = InTransitEngine(root, reducers, policy="block" if block else
                          "drop-oldest", queue_capacity=4,
                          device_reduce=device is not None,
                          device=device).start()
    walls = []
    for step, arrays in payloads:
        t0 = time.perf_counter()
        eng.submit(step, arrays)
        eng.drain(timeout=600.0)
        if device is not None:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    eng.close()
    return eng, walls


def check_launches(counts: dict, label: str) -> None:
    missing = [k for k in KERNELS if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} were never "
                             f"launched on the main path ({counts})")


def main_path_orion(tree, tmp: Path, device):
    from repro_torch.insitu.device import to_device
    from repro_torch.kernels import raster
    arrays = tree.to_arrays()
    on_card = to_device(arrays, device)   # the producer's state, on the card
    steps = range(1, ORION_STEPS + 2)      # first step warms the allocator
    raster.reset_launches()
    eng, walls = run_engine(str(tmp / "orion_dev"), live_reducers(),
                            [(s, on_card) for s in steps], device=device)
    launches = dict(raster.LAUNCHES)
    check_launches(launches, "orion engine")
    ds = eng.device_stats
    if ds["fallback_snapshots"] or ds["fallback_runs"]:
        raise AssertionError(f"orion engine fell back to the host: {ds}")
    _, host_walls = run_engine(str(tmp / "orion_host"), live_reducers(),
                               [(s, arrays) for s in steps], device=None)
    n = catalogs_equal(str(tmp / "orion_dev"), str(tmp / "orion_host"))
    n_steps = len(walls)
    timed = walls[1:]
    staged = sum(v.nbytes for v in arrays.values())
    out = {"wall_ms_per_step": 1e3 * sum(timed) / len(timed),
           "wall_ms_steps": [1e3 * w for w in walls],
           "host_engine_ms_per_step": 1e3 * sum(host_walls[1:]) /
           len(host_walls[1:]),
           "bytes_to_host_per_step": ds["bytes_to_host"] / n_steps,
           "bytes_staged_per_step": staged,
           "steps": n_steps, "arrays_checked": n}
    print(f"main path orion: {tree.n_nodes} nodes, {n_steps} steps, "
          f"catalog bit-equal to the host engine ({n} arrays), "
          f"fallback_snapshots=0, launches {launches}")
    print(f"time device_reduce_wall_ms_per_step: "
          f"{out['wall_ms_per_step']!r} (steps 2-{n_steps}; all steps "
          f"{out['wall_ms_steps']!r}); host engine (CPU reducers) "
          f"{out['host_engine_ms_per_step']!r} ms/step")
    print(f"bytes_to_host_per_step: {out['bytes_to_host_per_step']!r} "
          f"(snapshot {staged} bytes staged on the card)")
    return launches, out, on_card


def step_breakdown(on_card: dict, tmp: Path, device) -> dict:
    """Where one device-reduce step's wall time goes: the engine's own
    spans (host clock) over two steps, then the device's busy time
    (``torch.profiler``, CUDA activity only) over two more steps, as a
    share of the unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.insitu import InTransitEngine
    from repro_torch.obs.trace import TRACER
    eng = InTransitEngine(str(tmp / "orion_prof"), live_reducers(),
                          policy="block", device_reduce=True,
                          device=device).start()

    def steps(first: int) -> float:
        t0 = time.perf_counter()
        for step in (first, first + 1):
            eng.submit(step, on_card)
            eng.drain(timeout=600.0)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / 2

    steps(1)                                   # warm-up
    TRACER.clear()
    TRACER.enable()
    wall_ms = steps(3)
    TRACER.disable()
    spans: dict = {}
    for sp in TRACER.spans():
        if sp["name"] == "stage.pop":
            continue    # the lane's idle wait, begun before tracing was on
        key = sp["name"] if sp["name"] != "device.transfer" else \
            f"device.transfer[{sp['args'].get('reducer', '')}]"
        spans[key] = spans.get(key, 0.0) + sp["dur"] / 2e3   # ms per step
    TRACER.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_wall_ms = steps(5)
    eng.close()
    dev = sorted(((e.key, e.self_device_time_total / 2e3)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    dev_ms = sum(ms for _, ms in dev)
    out = {"wall_ms_per_step": wall_ms, "spans_ms_per_step": spans,
           "profiled_wall_ms_per_step": prof_wall_ms,
           "device_busy_ms_per_step": dev_ms if dev else None,
           "device_busy_share": dev_ms / wall_ms if dev else None,
           "device_top": [(k[:60], ms) for k, ms in dev[:8]]}
    print(f"breakdown per step (2 traced steps): wall {wall_ms!r} ms; "
          f"spans {spans!r}")
    if dev:
        print(f"breakdown device busy {dev_ms!r} ms/step (2 profiled steps, "
              f"{prof_wall_ms!r} ms/step under the profiler) = share "
              f"{out['device_busy_share']!r} of the traced wall; top "
              f"{out['device_top']!r}")
    else:
        print("breakdown device busy: not measured (the profiler recorded "
              "no device time)")
    return out


def main_path_cli_dag(tmp: Path, device) -> dict:
    """The CLI's default DAG on Sedov steps, through the engine (with
    stats) and through the ``launch/insitu.py`` entry point."""
    from repro_torch.kernels import raster
    from repro_torch.launch import insitu as cli
    from repro_torch.sim import amrgen, fields
    n_steps, max_level, res, lod = 6, 6, 128, 4
    payloads = []
    for s in range(1, n_steps + 1):
        field = fields.sedov(r_shock=0.1 + 0.25 * s / n_steps)
        tree = amrgen.generate_tree(field, min_level=3, max_level=max_level,
                                    threshold=1.15, level_factor=1.05)
        payloads.append((s, tree.to_arrays()))
    raster.reset_launches()
    eng, _ = run_engine(str(tmp / "cli_dev"),
                        cli.default_reducers(res, lod), payloads,
                        device=device)
    launches = dict(raster.LAUNCHES)
    check_launches(launches, "default DAG engine")
    ds = eng.device_stats
    if ds["fallback_snapshots"]:
        raise AssertionError(f"default DAG materialized a snapshot on the "
                             f"host: {ds}")
    run_engine(str(tmp / "cli_host"), cli.default_reducers(res, lod),
               payloads, device=None)
    n = catalogs_equal(str(tmp / "cli_dev"), str(tmp / "cli_host"))
    print(f"main path default DAG: {n_steps} Sedov steps, catalog "
          f"bit-equal to the host engine ({n} arrays), fallback_snapshots=0, "
          f"host runs {ds['fallback_runs']}, launches {launches}")
    argv = ["--out", str(tmp / "cli_run"), "--steps", "4", "--max-level",
            "6", "--resolution", "128", "--policy", "block", "--queries",
            "4", "--device-reduce", "--device", str(device)]
    buf = io.StringIO()
    raster.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    cli_launches = dict(raster.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"launch/insitu.py exited {rc}:\n"
                             f"{buf.getvalue()}")
    check_launches(cli_launches, "launch/insitu.py")
    summary = next((ln.strip() for ln in buf.getvalue().splitlines()
                    if "device reduce:" in ln), "")
    print(f"main path python -m repro_torch.launch.insitu --device-reduce: "
          f"rc 0, launches {cli_launches}; {summary}")
    return launches


# --------------------------------------------------------------- timing

def time_ms(fn, reps: int, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _row_bytes(t) -> int:
    """Bytes of one row of ``t``."""
    return t[:1].numel() * t.element_size()


def bounds(x: dict, edges, n_hist: int, resolution: int) -> dict:
    """Least time for each kernel's work on these inputs: the bytes the
    function must move (over the memory rate) vs its f64 operations
    (over the FP64 peak). Every row's ``ok`` (and, for the slice, its
    plane test) must be read; the other columns only for the rows this
    data selects: the valid leaves, or the valid leaves the slice plane
    hits. Each output is written once."""
    import torch

    from repro_torch.kernels import raster
    L = x["n_levels"]
    img = resolution * resolution * 8
    valid = x["ok"] & (x["levels"] >= 0) & (x["levels"] < L)
    _, _, px = raster.leaf_table(x["coords2"], x["levels"],
                                 resolution=resolution)
    hit = raster.plane_hit(x["c_axis"], x["levels"], 0.5, L) & valid
    n_rows, n_valid, n_hit = x["ok"].numel(), int(valid.sum()), int(hit.sum())
    leaf_row = sum(_row_bytes(x[k]) for k in ("coords2", "levels", "values"))
    # projection: one multiply and one add per (leaf, covered pixel)
    proj_ops = 2 * int((px.to(torch.int64) ** 2)[valid].sum())
    work = {
        # slice: c_axis, levels and ok of every row for the plane test (a
        # multiply and an add per row), then coords2 and values of the
        # leaves the plane hits
        "slice_raster": (n_rows * sum(_row_bytes(x[k]) for k in
                                      ("c_axis", "levels", "ok"))
                         + n_hit * (_row_bytes(x["coords2"])
                                    + _row_bytes(x["values"])) + img,
                         2 * n_rows),
        "projection_raster": (_nbytes(x["ok"]) + n_valid * leaf_row + img,
                              proj_ops),
        # histogram: one f64 compare per binary-search step per valid row
        "level_hist": (_nbytes(x["ok"], edges)
                       + n_valid * (_row_bytes(x["values"])
                                    + _row_bytes(x["levels"]))
                       + n_hist * (edges.numel() - 1) * 4,
                       n_valid * (3 + math.ceil(math.log2(edges.numel())))),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        tb, to = nbytes / MEM_BYTES_PER_S, ops / F64_OPS_PER_S
        out[name] = {"bound_ms": 1e3 * max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "bytes": nbytes, "ops": ops}
    out["slice_raster"]["plane_hits"] = n_hit
    out["projection_raster"]["valid_rows"] = n_valid
    return out


def time_kernels(x: dict, edges, n_hist: int, resolution: int) -> dict:
    from repro_torch.kernels import raster, ref
    geo = dict(resolution=resolution, n_levels=x["n_levels"])
    calls = {
        "slice_raster": lambda f: f(x["coords2"], x["c_axis"], x["levels"],
                                    x["values"], x["ok"], position=0.5,
                                    **geo),
        "projection_raster": lambda f: f(x["coords2"], x["levels"],
                                         x["values"], x["ok"], **geo),
        "level_hist": lambda f: f(x["values"], x["levels"], x["ok"], edges,
                                  n_levels=n_hist),
    }
    pairs = {"slice_raster": (raster.slice_raster, ref.slice_raster_ref),
             "projection_raster": (raster.projection_raster,
                                   ref.projection_raster_ref),
             "level_hist": (raster.level_hist, ref.level_hist_ref)}
    out = {}
    for name, call in calls.items():
        kern, plain = pairs[name]
        out[name] = {"ms": time_ms(lambda: call(kern), reps=20),
                     "plain_ms": time_ms(lambda: call(plain), reps=3,
                                         warm=1)}
    return out


# ----------------------------------------------------------------- main

def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device available; this smoke run needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"no repro_torch checkout around {ROOT}")
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from repro_torch.kernels import raster
    t0 = time.perf_counter()
    so = raster.build()
    raster._load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so}")

    from repro_torch.insitu import partition_snapshot
    # -- 2. parity: small, owner-masked partitions, full size
    for seed in (0, 7):
        tree = random_sedov_tree(seed)
        for res in (16, 64):
            check_parity(f"sedov seed={seed} R={res}", tree.to_arrays(),
                         device, resolution=res, bins=32, lo=None, hi=None)
    parts = partition_snapshot(random_sedov_tree(3).to_arrays(), "amr", 3)
    for g, part in enumerate(parts):
        check_parity(f"owner-masked part {g}/3", part, device, resolution=32,
                     bins=16, lo=-8.0, hi=8.0, n_domains=3, domain=g)
    t0 = time.perf_counter()
    tree = orion_tree()
    print(f"orion tree: {tree.n_nodes} nodes, {tree.n_levels} levels, "
          f"{int((~tree.refine).sum())} leaves, "
          f"{sum(v.nbytes for v in tree.to_arrays().values())} bytes "
          f"({time.perf_counter() - t0:.1f} s to generate)")
    errs, x, edges, n_hist = check_parity(
        "orion full size", tree.to_arrays(), device,
        resolution=LIVE_RESOLUTION, bins=64, lo=0.0, hi=50.0)

    # -- 3. main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=ROOT / "build") as d:
        tmp = Path(d)
        launches, wall, on_card = main_path_orion(tree, tmp, device)
        main_path_cli_dag(tmp, device)
        wall["breakdown"] = step_breakdown(on_card, tmp, device)
        del on_card
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 4. times at the full size
    times = time_kernels(x, edges, n_hist, LIVE_RESOLUTION)
    bnd = bounds(x, edges, n_hist, LIVE_RESOLUTION)
    records = []
    for name, replaces in KERNELS.items():
        t, b = times[name], bnd[name]
        print(f"time {name}: kernel {t['ms']!r} ms, plain {t['plain_ms']!r} "
              f"ms, bound {b['bound_ms']!r} ms by {b['bound_by']} "
              f"({b['bytes']} bytes, {b['ops']} f64 ops), launches on the "
              f"main path {launches[name]} over {wall['steps']} steps")
        records.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                        "library_ms": None})
    print(json.dumps({"main_path": wall, "card": card}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
