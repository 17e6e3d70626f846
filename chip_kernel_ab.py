#!/usr/bin/env python3
"""A/B of the projection CSR kernels across checkouts, on one CUDA card.

    python3 chip_kernel_ab.py DIR [DIR ...]

Each ``DIR`` is a checkout of this repository (this one, an older commit
unpacked with ``git archive``, or a copy with one kernel changed). Each is
run in its own process, in the order given (give ``A B B A`` to spread the
card's drift over both), builds its own kernel library from its own
``src/repro_torch/kernels/csrc`` and uses its own ``chip_smoke.py``
helpers, so the checkouts' kernels are timed in one call on one card. Per
checkout it prints one ``RESULT <dir> <json>`` line with, for each entry:
the wrapper's ms a call (CUDA events), its host ms, and its device ms by
kernel (``torch.profiler``):

  * ``B5``, ``B5_f32``: ``raster.projection_raster_carry`` in one call
    over the one-shard Orion table (569,344 padded rows, R = 512) that
    ``MeshTable`` uploads, float64 and float32;
  * ``B5t``, ``B5t_f32``: the same table in the 35-call chain of
    16,384-row tiles, one wrapper call a tile (ms and device ms a tile);
  * ``B2``: ``raster.projection_raster`` on the device path's Orion table.

Every result is first held bitwise against the plain twin
(``ref.projection_raster_ref``), and the chain against the one call; the
script exits non-zero if any checkout fails. The first line is the card's
name and power limit. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r'''
import inspect, json, sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke as c
from repro_torch.insitu.mesh_reduce import MeshTable
from repro_torch.kernels import cudalib, ops, raster, ref
cudalib.build(); cudalib.lib()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
R, TILE = 512, 16384
arrays = c.orion_tree().to_arrays()
has_tile = "tile_n" in inspect.signature(
    raster.projection_raster_carry).parameters
res = {}
for dt in (None, "float32"):
    fx = "_f32" if dt else ""
    mt = MeshTable(arrays, 1, [dev], dtype=dt)
    co, lv, va, ok = next(mt.shards("density"))
    c2 = ops.plane_coords(co, 2)
    seed = torch.zeros((R, R), dtype=va.dtype, device=dev)
    kw = dict(resolution=R, n_levels=mt.n_levels, init=seed)
    if has_tile:
        kw["tile_n"] = TILE
    want = ref.projection_raster_ref(c2, lv, va, ok, resolution=R,
                                     n_levels=mt.n_levels, init=seed)

    def one():
        return raster.projection_raster_carry(c2, lv, va, ok, **kw)

    tiles = [(c2[a:a + TILE], lv[a:a + TILE], va[a:a + TILE],
              ok[a:a + TILE]) for a in range(0, va.shape[0], TILE)]

    def chain():
        img = seed
        for t in tiles:
            img = raster.projection_raster_carry(
                *t, resolution=R, n_levels=mt.n_levels, init=img)
        return img

    for name, fn, calls in (("B5", one, 1), ("B5t", chain, len(tiles))):
        if not torch.equal(c._bits(fn()), c._bits(want)):
            raise AssertionError(f"{name}{fx} differs from its twin")
        res[name + fx] = c.wrapper_calls(fn, calls,
                                         reps=50 if calls == 1 else 20)
x = c.kernel_inputs(arrays, dev)
args = (x["coords2"], x["levels"], x["values"], x["ok"])
geo = dict(resolution=R, n_levels=x["n_levels"])
if not torch.equal(c._bits(raster.projection_raster(*args, **geo)),
                   c._bits(ref.projection_raster_ref(*args, **geo))):
    raise AssertionError("B2 differs from its twin")
res["B2"] = c.wrapper_calls(lambda: raster.projection_raster(*args, **geo),
                            1, reps=50)
for r in res.values():
    r.pop("profiled_host_ms", None)
print("RESULT", sys.argv[1], json.dumps(res))
'''


def main(dirs: list[str]) -> int:
    try:
        import torch
    except ImportError:
        print("chip_kernel_ab: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or not dirs:
        print("chip_kernel_ab: needs a CUDA card and at least one checkout",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    rc = 0
    for d in dirs:
        root = Path(d).resolve()
        if not (root / "chip_smoke.py").is_file():
            print(f"chip_kernel_ab: no checkout at {root}", file=sys.stderr)
            return 1
        run = subprocess.run([sys.executable, "-c", CHILD, d], cwd=root,
                             capture_output=True, text=True, timeout=600)
        lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if run.returncode or not lines:
            print(f"chip_kernel_ab: {d} failed (rc {run.returncode}):\n"
                  f"{run.stderr[-3000:]}", file=sys.stderr)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
