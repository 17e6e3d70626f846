"""In-transit analysis driver: ``python -m repro_torch.launch.insitu ...``

Simulates a time-dependent Sedov blast (the shock radius grows step by
step), pushes every step's AMR tree through the in-transit engine, and
then replays viewer queries against the reduced catalog — the full
compute → staging → reducers → HDep → catalog pipeline on one box.
With ``--device-reduce`` the snapshots stage and reduce on ``--device``
(the GPU by default) through the CUDA raster kernels.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np

from ..insitu import (Catalog, InTransitEngine, LevelHistogramReducer,
                      LODCutReducer, ProjectionReducer, SliceReducer)
from ..sim import amrgen, fields


def default_reducers(resolution: int, lod: int, domains: int = 1):
    lodname = f"lod{lod}"
    # multi-domain histograms need fixed bounds: per-partition auto
    # bounds produce incompatible bin edges that cannot sum at read
    hist = LevelHistogramReducer(field="density", bins=32, lo=0.0, hi=8.0) \
        if domains > 1 else LevelHistogramReducer(field="density", bins=32)
    return [
        LODCutReducer(max_level=lod),
        SliceReducer(field="density", axis=2, position=0.5,
                     resolution=resolution),
        SliceReducer(field="density", axis=2, position=0.5,
                     resolution=resolution, source=lodname),
        ProjectionReducer(field="density", axis=2, resolution=resolution),
        hist,
    ]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None,
                   help="run root, emptied first (default: a new "
                        "directory under the temp dir)")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--max-level", type=int, default=6)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--lod", type=int, default=4)
    p.add_argument("--output-every", type=int, default=2,
                   help="reduced-output cadence (independent of compute)")
    p.add_argument("--policy", default="drop-oldest",
                   choices=["block", "drop-oldest", "subsample"])
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--queue-capacity", type=int, default=4)
    p.add_argument("--domains", type=int, default=1,
                   help="contributor groups: each step is partitioned, "
                        "each group writes its own Hercule domain, and "
                        "catalog queries merge them back at read")
    p.add_argument("--backend", default="thread",
                   choices=["thread", "process"],
                   help="lane runtime: in-process worker threads, or one "
                        "OS process per group over shared-memory staging")
    p.add_argument("--device-reduce", action="store_true",
                   help="stage snapshots on the GPU and reduce with the "
                        "CUDA raster kernels; only reduced objects cross "
                        "the device->host boundary")
    p.add_argument("--device", default=None,
                   help="torch device of --device-reduce (default: cuda; "
                        "'cpu' runs the kernels' plain torch twins)")
    p.add_argument("--device-mesh", type=int, default=0, metavar="N",
                   help="not ported yet (sharded multi-GPU reduction)")
    p.add_argument("--lane-pool", action="store_true",
                   help="with --backend process: borrow lanes from the "
                        "persistent module pool instead of spawning")
    p.add_argument("--queries", type=int, default=16,
                   help="viewer queries to replay against the catalog")
    p.add_argument("--serve-check", action="store_true",
                   help="not ported yet (catalog server)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record per-step spans (submit -> staging -> "
                        "reduce -> write -> commit, across process lanes) "
                        "and write a Chrome-trace JSON loadable in "
                        "Perfetto / chrome://tracing")
    p.add_argument("--ledger", action="store_true",
                   help="not ported yet (run ledger)")
    args = p.parse_args(argv)

    for flag, on in (("--device-mesh", args.device_mesh),
                     ("--serve-check", args.serve_check),
                     ("--ledger", args.ledger)):
        if on:
            p.error(f"{flag} is not ported to repro_torch yet")
    if args.device is not None and not args.device_reduce:
        p.error("--device only applies with --device-reduce")
    if args.trace_out:
        from ..obs import TRACER
        TRACER.enable()

    if args.out is None:
        args.out = tempfile.mkdtemp(prefix="hx_insitu_")
    else:
        shutil.rmtree(args.out, ignore_errors=True)
    reducers = default_reducers(args.resolution, args.lod, args.domains)
    device_reduce = args.device_reduce
    engine = InTransitEngine(
        args.out, reducers,
        output_every=args.output_every, workers=args.workers,
        queue_capacity=args.queue_capacity, policy=args.policy,
        domains=args.domains, backend=args.backend,
        device_reduce=device_reduce, device=args.device,
        lane_pool=args.lane_pool).start()

    print(f"== compute flow: {args.steps} Sedov steps "
          f"(policy={args.policy}, output_every={args.output_every}, "
          f"domains={args.domains}, backend={args.backend}, "
          f"device_reduce={device_reduce}) -> {args.out}")
    t_compute = t_submit = 0.0
    for s in range(1, args.steps + 1):
        t0 = time.perf_counter()
        r_shock = 0.1 + 0.25 * s / args.steps     # expanding blast wave
        field = fields.sedov(r_shock=r_shock)
        tree = amrgen.generate_tree(field, min_level=3,
                                    max_level=args.max_level,
                                    threshold=1.15, level_factor=1.05)
        t1 = time.perf_counter()
        staged = engine.submit(s, tree)
        t2 = time.perf_counter()
        t_compute += t1 - t0
        t_submit += t2 - t1
        print(f"   step {s:3d}: {tree.n_nodes:7d} nodes "
              f"staged={'yes' if staged else 'no '} "
              f"(gen {1e3*(t1-t0):6.1f} ms, submit {1e6*(t2-t1):6.1f} us)")
    engine.drain()
    print(f"   compute {t_compute:.2f} s, total submit {t_submit*1e3:.2f} ms "
          f"({100*t_submit/max(t_compute,1e-9):.2f} % overhead)")
    for g, area in enumerate(engine.stages):
        stats = area.stats
        print(f"   staging[g{g}]: accepted={stats.accepted} "
              f"evicted={stats.evicted} dropped={stats.dropped} "
              f"reuses={stats.buffer_reuses} allocs={stats.buffer_allocs}")
    if args.device_reduce:
        ds = engine.device_stats
        staged = sum(a.stats.bytes_staged for a in engine.stages)
        print(f"   device reduce: {ds['bytes_to_host']/1e6:.2f} MB to host "
              f"vs {staged/1e6:.2f} MB staged on device "
              f"({ds['device_objects']} device objects, "
              f"fallback_runs={ds['fallback_runs']})")
    tel = engine.telemetry()
    tot = tel["staging"]["totals"]
    print(f"   telemetry[{tel['backend']}]: accepted={tot['accepted']} "
          f"popped={tot['popped']} released={tot['released']} "
          f"bytes_staged={tot['bytes_staged']/1e6:.2f} MB; "
          f"lanes={tel['lanes']}")
    engine.close()
    if args.lane_pool:
        from ..insitu import shutdown_pool
        shutdown_pool()       # reclaim the resident lanes before exit
    if args.trace_out:
        from ..obs import TRACER
        n_spans = TRACER.write_chrome_trace(args.trace_out)
        print(f"   trace: {n_spans} spans -> {args.trace_out} "
              f"(open in Perfetto or chrome://tracing)")

    print("== analysis flow: catalog replay (domain-merged queries)")
    cat = Catalog(args.out)
    steps = cat.steps()
    print(f"   contexts: {steps}")
    if not steps:
        return 1
    names = cat.reducers(steps[-1])
    print(f"   reducers: {names}")
    if args.domains > 1:
        att = cat.attrs(steps[-1])["insitu"]
        print(f"   latest context domains={att['domains']} "
              f"merge={att['merge']}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.queries):
        s = int(rng.choice(steps))
        name = str(rng.choice(names))
        obj = cat.query(s, name)
        sizes = {k: v.shape for k, v in obj.items()}
        print(f"   query step={s} {name}: "
              f"{sum(v.nbytes for v in obj.values())/1e3:.1f} kB {sizes}")
    dt = time.perf_counter() - t0
    info = cat.cache_info()
    print(f"   {args.queries} queries in {dt*1e3:.1f} ms — "
          f"hits={info['hits']} misses={info['misses']} "
          f"io_reads={info['io_reads']}")
    # selector-driven sweep: all slice/projection images, one indexed pass
    n_img = size_img = 0
    for ref in cat.scan(names="reduced/*/image"):
        n_img += 1
        size_img += ref.record.nbytes
    print(f"   selector sweep reduced/*/image: {n_img} records, "
          f"{size_img/1e3:.1f} kB on disk")
    if args.domains > 1:
        # merge-at-read spot check: the merged histogram must carry
        # exactly the per-domain partial counts, summed
        hname = next(n for n in names if n.startswith("hist-"))
        merged = cat.query(steps[-1], hname)["hist"]
        parts = [cat.query(steps[-1], hname, domain=d)["hist"]
                 for d in cat.domains(steps[-1], hname)]
        total = sum(int(p.sum()) for p in parts)
        ok = int(merged.sum()) == total
        print(f"   merge check {hname}: {len(parts)} domains, "
              f"counts {int(merged.sum())} == sum(parts) {total}: {ok}")
        if not ok:
            return 1
    full_slice = next(r for r in reducers
                      if isinstance(r, SliceReducer) and r.source is None)
    img = cat.query(steps[-1], full_slice.name)["image"]
    q = np.nanquantile(img, [0.5, 0.8, 0.95])
    chars = np.full(img.shape, " ")
    chars[img > q[0]] = "."
    chars[img > q[1]] = "o"
    chars[img > q[2]] = "#"
    stride = max(1, img.shape[0] // 24)
    for row in chars[::stride]:
        print("   " + "".join(row[::max(1, stride // 2)]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
