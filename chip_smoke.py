#!/usr/bin/env python3
"""GPU smoke run of the ``repro_torch`` port: ``python3 chip_smoke.py``.

Needs one CUDA card and the repository checkout around this file; exits
non-zero (and prints no result) otherwise, or on any failure.

  1. prints the card's name and power limit, builds every CUDA kernel
     from ``src/repro_torch/kernels/csrc`` into one library and prints
     the build seconds;
  2. kernel parity: each of B1-B3 (slice, projection, per-level
     histogram) against its plain torch twin on the card, bitwise, and
     against the port's host numpy reducers, and B4/B5 (the carry-seeded
     slice and projection) chained over BFS tiles against their seeded
     twins (image and depth, bitwise) and against one-shot B1/B2 — on
     small Sedov trees (R=16 and 64; R=16 forces sub-pixel collisions;
     512-row tiles), on an owner-masked 3-way partition, and on the full
     Orion tree (649,385 nodes, R=512, 16384-row tiles); the codec
     kernels B6-B9 (father–son encode at widths 64/32/16 and zbits
     2/4/8, decode, bitfield pack and unpack) against their twins,
     bitwise, on the density groups and ``refine`` flags of the Sedov
     trees and of the Orion tree, B6's three outputs views of one buffer;
     B1 and B4 (which build their leaf table in the paint kernel they
     share) also at slice positions on exact cell boundaries and with
     rows of out-of-range level on the Sedov trees, and on coarse-leaf
     tables (levels 0-3 at R = 512: rectangles of 64²-512² pixels, each
     keyed into its level's cell, among finer ones each thread paints
     pixel by pixel), B1
     twice on the kept key scratch, left all zero; B2 and B5 (which build
     their (level, cell) CSR on the card) also on adversarial tables —
     deep columns of up to 2,048 leaves, sub-pixel levels, n_levels >
     k + 1, rows of out-of-range level, all-invalid and padded tiles —
     at R = 16, 64 and 512, each call twice on the kept scratch; the
     float32 instantiations B3-f32, B4-f32 and B5-f32 (the mesh path's
     float32 tables) on the same Sedov, partition and Orion tables with
     their values cast to float32, B4-f32 at the boundary positions, B5-f32
     on the adversarial tables, and B4 and B4-f32 on a level-26 table
     whose float32 plane test rounds, each bitwise against its float32
     twin (float32 bits compared as int32); B3 and B3-f32 on edge cases
     (values on every edge and on ``hi``, NaN and ±inf, levels out of
     range, non-uniform and duplicate edges, edges float32 cannot hold,
     L·B beyond shared memory at L = 16 and 4,096 bins, edges beyond it
     at 8,192 bins, n = 0), each table whole and from row 1 (unaligned),
     with CPU edges (by value) and edges on the card, each call twice:
     bitwise the twin, one launch a call, the next call's output zeroed;
  3. main path: ``InTransitEngine(device_reduce=True, device="cuda")``
     over the Orion tree with the 512-res slice/projection/histogram DAG,
     then the CLI's default DAG (LOD cut, slice, slice-of-LOD,
     projection, auto-bounds histogram) on Sedov steps, through the
     engine and through ``python -m repro_torch.launch.insitu``. Each
     catalog must be bit-equal to a host-engine run, no snapshot may fall
     back to the host, and every kernel's launch counter must move;
  4. mesh path: ``InTransitEngine(device_reduce="mesh")`` over Orion with
     one shard (catalog bit-equal to the host engine's) and with four
     shards on the one card (slice and histogram bitwise, projection
     bitwise against the ascending fold of the per-shard host
     reductions and within rtol 1e-12 of the host), then
     ``python -m repro_torch.launch.insitu --device-mesh 4 --device
     cuda:0`` on Sedov steps under the same contract; B4/B5 must launch
     once per tile per step and B3 once per shard per step; then
     ``MeshDAGRunner(dtype="float32")`` over Orion at one and four shards,
     in turns with the same runner at float64: every float32 output
     bitwise the float32 twins' run on the card, the slice within rtol
     1e-6 and the projection within 1e-4 of the float64 host reducers,
     the histogram and edges equal to the host's over the cast field,
     only the float32 kernels launched (B4-f32/B5-f32 once per tile,
     B3-f32 once per shard, per step), and half the field bytes up and
     half the image bytes down;
  5. codec path: ``kernels.ops.compress_bits`` (B6 and the stream
     packing) over the five Orion fields at width 64, from the host
     codec's level-fused father/son groups; the code and payload words
     must equal ``core.fpdelta.encode_tree_field``'s, word for word;
     ``ops.decompress_bits`` (B7) must give every son word back; the
     density field at widths 32 and 16 through ``f32_bits``/``bf16_bits``
     against ``fpdelta.encode``; ``refine`` through ``bitfield_pack``
     (B8, equal to ``np.packbits``) and ``bitfield_unpack`` (B9). One
     snapshot must launch B6 and B7 five times and B8 and B9 once; the
     codec wall per snapshot is printed beside the host codec's;
  6. times at the full size: the device-reduce and mesh walls per step
     and bytes to the host per step, where a device-reduce step's time
     goes (the engine's spans and the device's busy time from
     ``torch.profiler``), and, with CUDA events, each kernel (B4/B5 and
     B4-f32/B5-f32 per tile call, B3-f32 on the one-shard float32 table;
     B6-B9 at the Orion codec shapes, B7 on contiguous residues), its
     plain twin, B7's library yardstick (one ``torch.bitwise_xor``) and
     its bound; for B1-B7 and the float32 kernels also the
     host's own time per wrapper call (a loop with no sync), its split by
     step, and the kernels' device time by kernel (``torch.profiler``);
     B1's and B3's (and B3-f32's) calls must record no torch op but
     their output's ``aten::empty``, and launch no memset (B3: its one
     kernel and nothing else); B3 also with its edges on the card; the
     device path's histogram reducer on Orion, whole and split into the
     bounds pull, the edges and B3, and its run and the mesh reducer's
     must copy nothing host to device; for B2/B5 the longest (level,
     cell) segment of the Orion table and tiles; and the host cost of
     the two spellings of the current stream's handle;
  7. serving and ledger (run after the mesh path, over the Orion
     catalog phase 3 reduced on the card): (a) the port's
     ``CatalogServer`` (``compress=True``) serves it, and
     ``RemoteCatalog.query`` and the progressive stream of every reducer
     at every step must be bitwise ``Catalog.query`` and the host
     engine's catalog; (b) ``python -m repro_torch.launch.catalog_serve
     --selftest --load 64 --root <that catalog>`` must exit 0 (its QPS,
     p99 and coalesce/batch/reject counters are printed); (c) ``python
     -m repro_torch.launch.insitu --device-reduce --serve-check
     --ledger`` on Sedov steps must exit 0 with no mismatched array and
     move B1-B3's launch counters, ``python -m repro_torch.launch.obs
     report`` must read its ledger, whose ``device_fallbacks`` signal
     must read 0 in every flush; (d) the Orion device-reduce wall per
     step with the ledger bound (tracer on, 1 s flushes, as the CLI)
     beside the wall without it, in turns, and one flush's ms and bytes;
  8. HProt on the card: (a) the train state of one full-width
     stablelm-1.6b decoder layer (51.4 M parameters in bfloat16, Adam
     moments in float32, an int32 step; about 514 MB), made on the card
     from a seeded generator, matrices row-sharded over four shards of
     the one card, vectors replicated; (b) ``AsyncCheckpointManager``
     (thread lanes, ``delta_every=2``) over four saves (full, delta,
     delta, full rebase), every tensor mutated in place right after each
     ``save`` returns: every step must restore bitwise, as it was when
     ``save`` was called, onto 4, 2 and 8 shards and whole, and one more
     save goes through a process lane; (c) a synchronous
     ``CheckpointManager`` save of the same state, its wall beside the
     async stall; (d) the Orion tree's arrays, on the card, saved raw and
     restored bitwise, ``AMRTree.from_arrays`` equal to the tree;
     (e) ``InTransitEngine.submit_state`` of the layer's parameters
     through ``TensorNormReducer`` and ``SpectraReducer(k=8)`` on the
     card against the same engine on the CPU (rtol 1e-5, atol 1e-6); no
     ``device.fallback`` event. Stall, gather, commit, encode and
     device-to-host rates, stored bytes, restore rates and the cut's
     device time against its bound are printed beside the card's name
     and power limit.

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

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth and FP64 / FP32 (non-tensor)
#: peaks
MEM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12
F32_OPS_PER_S = 67e12
#: H100 SXM int32 rate of the CUDA cores (Hopper white paper: 64 INT32
#: lanes per SM, 132 SMs, 1.98 GHz boost clock)
INT32_OPS_PER_S = 64 * 132 * 1.98e9

RASTER_SRC = "src/repro_torch/kernels/csrc/raster.cu"
CODEC_SRC = "src/repro_torch/kernels/csrc/codec.cu"
#: each kernel: the TPU kernel it replaces, its CUDA source
KERNELS = {
    "slice_raster": ("src/repro/kernels/raster_kernel.py:136", RASTER_SRC),
    "projection_raster": ("src/repro/kernels/raster_kernel.py:240",
                          RASTER_SRC),
    "level_hist": ("src/repro/kernels/raster_kernel.py:320", RASTER_SRC),
    "slice_raster_carry": ("src/repro/kernels/raster_kernel.py:166",
                           RASTER_SRC),
    "projection_raster_carry": ("src/repro/kernels/raster_kernel.py:267",
                                RASTER_SRC),
    # the float32 instantiations of B3-B5 (the mesh path's float32 tables)
    "level_hist_f32": ("src/repro/kernels/raster_kernel.py:320", RASTER_SRC),
    "slice_raster_carry_f32": ("src/repro/kernels/raster_kernel.py:166",
                               RASTER_SRC),
    "projection_raster_carry_f32": ("src/repro/kernels/raster_kernel.py:267",
                                    RASTER_SRC),
    "encode_groups": ("src/repro/kernels/fpdelta_kernel.py:60", CODEC_SRC),
    "decode_groups": ("src/repro/kernels/fpdelta_kernel.py:96", CODEC_SRC),
    "bitpack": ("src/repro/kernels/bitpack_kernel.py:26", CODEC_SRC),
    "bitunpack": ("src/repro/kernels/bitpack_kernel.py:49", CODEC_SRC),
}
#: the kernels the device-reduce main path runs
DEVICE_PATH = ("slice_raster", "projection_raster", "level_hist")

ORION_STEPS = 3          # timed main-path steps (after one warm-up step)
LIVE_RESOLUTION = 512
MESH_SHARDS = 4          # shards of the multi-shard mesh run, on one card


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
    return {"coords": dt.coords,
            "coords2": ops.plane_coords(dt.coords, axis),
            "c_axis": dt.coords[:, axis], "levels": dt.levels.to(torch.int32),
            "values": dt.field("density"), "ok": dt.ok,
            "n_levels": dt.n_levels}


# ------------------------------------------------------------- parity

def _bits(t):
    """A float tensor's bit patterns (int64 / int32 / int16), else the
    tensor."""
    import torch
    view = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16}.get(t.dtype)
    return t if view is None else t.view(view)


def _same_bits(label: str, got, twin) -> float:
    """Raise unless each tensor of ``got`` has its ``twin``'s dtype, shape
    and bits; returns the max abs error (0.0)."""
    import torch
    for g, t in zip(got, twin):
        if g.dtype != t.dtype or g.shape != t.shape or \
                not torch.equal(_bits(g), _bits(t)):
            raise AssertionError(f"{label} differs from its twin (max abs "
                                 f"err {_max_abs_err(g, t)})")
    return max(_max_abs_err(g, t) for g, t in zip(got, twin))


def _check_launched(before: dict, want: dict, label: str) -> None:
    """Raise unless the raster launch counters moved by ``want`` since
    ``before``, and every other counter not at all."""
    from repro_torch.kernels import raster
    moved = {k: raster.LAUNCHES[k] - before.get(k, 0)
             for k in raster.LAUNCHES}
    expect = {k: want.get(k, 0) for k in raster.LAUNCHES}
    if moved != expect:
        raise AssertionError(f"{label}: launches {moved}, expected {expect}")


def f32_inputs(x: dict) -> dict:
    """``x`` with its values cast to float32, as a float32 mesh table
    holds them."""
    import torch
    return {**x, "values": x["values"].to(torch.float32)}


def _max_abs_err(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    both_nan = torch.isnan(a) & torch.isnan(b)
    diff = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    return float(torch.nan_to_num(diff, nan=math.inf).max()) \
        if diff.numel() else 0.0


def carry_chain(x: dict, kind: str, backend, *, resolution: int,
                tile_n: int):
    """``kernels.ops``' tiled partial raster over ``x``'s table: B4
    (``kind="slice"``, returns image and depth) or B5, chained over
    ``tile_n``-row tiles; ``backend="ref"`` chains the seeded twins."""
    from repro_torch.kernels import ops
    kw = dict(axis=2, resolution=resolution, n_levels=x["n_levels"],
              backend=backend, tile_n=tile_n)
    if kind == "slice":
        return ops.raster_slice_partial(x["coords"], x["levels"],
                                        x["values"], x["ok"], position=0.5,
                                        **kw)
    return (ops.raster_projection_partial(x["coords"], x["levels"],
                                          x["values"], x["ok"], **kw),)


def check_parity(label: str, arrays: dict, device, *, resolution: int,
                 bins: int, lo, hi, n_domains: int = 1, domain: int = 0,
                 tile_n: int = 512):
    """B1-B3 vs their plain twins (bitwise) and vs the host reducers;
    B4/B5 chained over ``tile_n``-row tiles vs their seeded twins
    (bitwise) and vs the one-shot images."""
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
    n_tiles = -(-x["values"].shape[0] // tile_n)
    for kind, name, one in (("slice", "slice_raster_carry", "slice"),
                            ("projection", "projection_raster_carry",
                             "proj")):
        before = raster.LAUNCHES[name]
        got = carry_chain(x, kind, None, resolution=resolution,
                          tile_n=tile_n)
        twin = carry_chain(x, kind, "ref", resolution=resolution,
                           tile_n=tile_n)
        torch.cuda.synchronize()
        if raster.LAUNCHES[name] - before != n_tiles:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{raster.LAUNCHES[name] - before} times "
                                 f"for {n_tiles} tiles")
        for g, t in zip(got, twin):
            if g.dtype != t.dtype or not torch.equal(_bits(g), _bits(t)):
                raise AssertionError(f"{label}: {name} differs from its "
                                     f"seeded twin (max abs err "
                                     f"{_max_abs_err(g, t)})")
        if not np.array_equal(got[0].cpu().numpy().view(np.int64),
                              np.asarray(host[one]["image"]).view(np.int64)):
            raise AssertionError(f"{label}: chained {name} differs from "
                                 f"the one-shot image")
        errs[name] = max(_max_abs_err(g, t) for g, t in zip(got, twin))
    print(f"parity {label}: B1-B3 bit-equal to plain twins and host "
          f"reducers, B4/B5 over {n_tiles} tiles of {tile_n} rows bit-equal "
          f"to seeded twins and one-shot images (R={resolution}, "
          f"{x['values'].shape[0]} padded rows)")
    return errs, x, edges, n_hist


def check_carry_boundaries(label: str, arrays: dict, device, *,
                           resolution: int = 64, tile_n: int = 512,
                           f32: bool = False) -> None:
    """B4 (``f32``: B4-f32 on the values cast to float32) chained over
    ``tile_n``-row tiles against its seeded twin, bitwise (image and
    depth), at slice positions on exact cell boundaries, with the tree's
    levels and with every 7th valid row given a level outside [0,
    n_levels) (rows B4 must drop)."""
    import torch

    from repro_torch.kernels import ops, raster
    x = kernel_inputs(arrays, device)
    if f32:
        x = f32_inputs(x)
    name = "slice_raster_carry_f32" if f32 else "slice_raster_carry"
    L = x["n_levels"]
    rows = torch.nonzero(x["ok"]).flatten()[::7]
    bad = x["levels"].clone()
    bad[rows] = torch.tensor([L, L + 3, -1], dtype=torch.int32,
                             device=device).repeat(rows.numel())[
                                 :rows.numel()]
    n_tiles = -(-x["values"].shape[0] // tile_n)
    positions = (0.0, 0.25, 0.5, 1 - 2.0 ** -(L - 1))
    for levels in (x["levels"], bad):
        for pos in positions:
            kw = dict(axis=2, position=pos, resolution=resolution,
                      n_levels=L, tile_n=tile_n)
            before = raster.LAUNCHES[name]
            got = ops.raster_slice_partial(x["coords"], levels, x["values"],
                                           x["ok"], **kw)
            launched = raster.LAUNCHES[name] - before
            twin = ops.raster_slice_partial(x["coords"], levels,
                                            x["values"], x["ok"],
                                            backend="ref", **kw)
            torch.cuda.synchronize()
            if launched != n_tiles:
                raise AssertionError(f"{label}: {name} launched {launched} "
                                     f"times for {n_tiles} tiles")
            _same_bits(f"{label}: {name} at position {pos}", got, twin)
            if not f32:
                check_slice_twice(f"{label}: slice_raster at position {pos}",
                                  {**x, "levels": levels}, position=pos,
                                  resolution=resolution)
    b1 = "" if f32 else ", and B1 twice a position on the kept scratch,"
    print(f"parity {label}: {name} over {n_tiles} tiles bit-equal to its "
          f"seeded twin{b1} at positions {positions}, with and without "
          f"{rows.numel()} rows of out-of-range level (R={resolution})")


def check_slice_twice(label: str, x: dict, *, position: float,
                      resolution: int) -> float:
    """B1 on ``x``'s columns twice on the current stream against its
    twin, bitwise: one launch a call, and the kept key scratch all zero
    after them. Returns the max abs error (0.0)."""
    import torch

    from repro_torch.kernels import cudalib, raster, ref
    args = (x["coords2"], x["c_axis"], x["levels"], x["values"], x["ok"])
    geo = dict(position=position, resolution=resolution,
               n_levels=x["n_levels"])
    before = dict(raster.LAUNCHES)
    got = [raster.slice_raster(*args, **geo) for _ in range(2)]
    torch.cuda.synchronize()
    _check_launched(before, {"slice_raster": 2}, label)
    twin = ref.slice_raster_ref(*args, **geo)
    err = max(_same_bits(label, (g,), (twin,)) for g in got)
    dev = x["values"].get_device()
    keys = raster._SLICE_KEYS[(dev, cudalib.current_stream(dev), resolution)]
    if bool(keys.any()):
        raise AssertionError(f"{label}: the key scratch is not all zero "
                             f"after the call")
    return err


def coarse_table(seed: int, *, resolution: int, n_levels: int,
                 fine: int) -> dict:
    """A level-major leaf table (numpy) whose slice at 0.5 paints coarse
    leaves (``tests/test_torch_raster.py``'s, with up to ``fine`` rows on
    each level >= 4): 4-11 leaves on each of levels 0-3, overlapping;
    half the rows of a level on the plane's cell (c = 2^(l-1)); ~10 % not
    ok; every 13th ok row of a level outside [0, n_levels)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    coords, levels = [], []
    for lvl in range(n_levels):
        side = 1 << lvl
        n = int(rng.integers(4, 12 if lvl < 4 else fine))
        c = rng.integers(0, side, size=(n, 3))
        on_plane = rng.random(n) < 0.5
        c[on_plane, 2] = side >> 1
        coords.append(c)
        levels.append(np.full(n, lvl))
    coords = np.concatenate(coords).astype(np.int32)
    levels = np.concatenate(levels).astype(np.int32)
    ok = rng.random(levels.shape[0]) < 0.9
    bad = np.flatnonzero(ok)[::13]
    levels[bad] = np.resize([n_levels, n_levels + 3, -1], bad.size)
    values = rng.standard_normal(levels.shape[0]) * 4.0 + 1.0
    return {"coords": coords, "levels": levels, "values": values, "ok": ok}


def check_coarse_tables(device) -> float:
    """B1 (twice on the kept scratch), B4 and B4-f32 (chained over
    512-row tiles) against their twins, bitwise, on
    :func:`coarse_table` tables at R = 512 and 64, where the paint
    kernel's two branches run in one warp: coarse leaves (rectangles
    above ``raster.SLICE_OWN_AREA`` pixels, up to the whole image) keyed
    into their level's cell, the others painted pixel by pixel. Returns
    B1's max abs error (0.0)."""
    import torch

    from repro_torch.kernels import ops, raster
    err = 0.0
    for seed, (res, L, fine) in enumerate(((512, 11, 3000), (64, 8, 600),
                                           (512, 11, 40))):
        tbl = coarse_table(seed, resolution=res, n_levels=L, fine=fine)
        t = {k: torch.from_numpy(v).to(device) for k, v in tbl.items()}
        x = {"coords2": ops.plane_coords(t["coords"], 2),
             "c_axis": t["coords"][:, 2], "levels": t["levels"],
             "values": t["values"], "ok": t["ok"], "n_levels": L}
        label = f"coarse table R={res} L={L}"
        err = max(err, check_slice_twice(f"{label}: slice_raster", x,
                                          position=0.5, resolution=res))
        _, _, px = raster.leaf_table(x["coords2"], x["levels"],
                                     resolution=res)
        hit = raster._slice_table(x["coords2"], x["c_axis"], x["levels"],
                                  x["ok"], position=0.5, resolution=res,
                                  n_levels=L)[4].bool()
        coarse = int((hit & (px.to(torch.int64) ** 2 >
                             raster.SLICE_OWN_AREA)).sum())
        if not 0 < coarse < int(hit.sum()):
            raise AssertionError(f"{label}: {coarse} of {int(hit.sum())} "
                                 f"hit rows keyed into cells; the table "
                                 f"must run both branches")
        n_tiles = -(-tbl["levels"].shape[0] // 512)
        for dtype, name in ((torch.float64, "slice_raster_carry"),
                            (torch.float32, "slice_raster_carry_f32")):
            kw = dict(axis=2, position=0.5, resolution=res, n_levels=L,
                      tile_n=512)
            vals = t["values"].to(dtype)
            before = dict(raster.LAUNCHES)
            got = ops.raster_slice_partial(t["coords"], t["levels"], vals,
                                           t["ok"], **kw)
            torch.cuda.synchronize()
            _check_launched(before, {name: n_tiles}, f"{label}: {name}")
            twin = ops.raster_slice_partial(t["coords"], t["levels"], vals,
                                            t["ok"], backend="ref", **kw)
            _same_bits(f"{label}: {name}", got, twin)
        print(f"parity {label}: {tbl['levels'].shape[0]} rows, "
              f"{int(hit.sum())} hit the plane, {coarse} of them coarse "
              f"(keyed into cells); B1 twice on the kept scratch, B4 and "
              f"B4-f32 over {n_tiles} tiles of 512 rows, bit-equal to their "
              f"twins")
    return err


def projection_table(seed: int, *, resolution: int, n_levels: int,
                     per_level: int, column_levels, invalid_run: int = 0):
    """A level-major leaf table (numpy) B2/B5's on-card CSR must get
    right: up to ``per_level`` random leaves on every level, each level's
    rows shuffled; at each of ``column_levels`` two deep columns (every
    leaf of (x, y) and of (x + 1, y) along the axis: one cell, or one
    pixel at a sub-pixel level); ~15 % rows not ok; every 11th ok row of
    a level outside [0, n_levels); ``invalid_run`` rows with ok False
    after level 3 (all-invalid tiles when chained)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    coords, levels = [], []
    for lvl in range(n_levels):
        side = 1 << lvl
        c = rng.integers(0, side, size=(int(rng.integers(8, per_level)), 3))
        if lvl in column_levels:
            x, y = rng.integers(0, side, size=2)
            z = np.arange(side)
            c = np.concatenate([c, *(np.stack(
                [np.full(side, min(x + dx, side - 1)), np.full(side, y), z],
                1) for dx in (0, 1))])
        c = c[rng.permutation(c.shape[0])]
        coords.append(c)
        levels.append(np.full(c.shape[0], lvl))
        if lvl == 3 and invalid_run:
            coords.append(rng.integers(0, side, size=(invalid_run, 3)))
            levels.append(np.full(invalid_run, -7))
    coords = np.concatenate(coords).astype(np.int32)
    levels = np.concatenate(levels).astype(np.int32)
    ok = (rng.random(levels.shape[0]) < 0.85) & (levels != -7)
    levels[levels == -7] = 3
    bad = np.flatnonzero(ok)[::11]
    levels[bad] = np.resize([n_levels, n_levels + 3, -1], bad.size)
    values = rng.standard_normal(levels.shape[0]) * 4.0 + 1.0
    return {"coords": coords, "levels": levels, "values": values, "ok": ok,
            "n_levels": n_levels}


def longest_segment(coords2, levels, ok, *, resolution: int,
                    n_levels: int) -> int:
    """Rows in the fullest (level, cell) segment of B2/B5's CSR."""
    import torch

    from repro_torch.kernels import ref
    keep = ok & (levels >= 0) & (levels < n_levels)
    if not bool(keep.any()):
        return 0
    cells = ref.level_cells(coords2, levels, resolution=resolution,
                            n_levels=n_levels)[keep]
    return int(torch.bincount(cells).max())


def check_projection_tables(device, f32: bool = False) -> int:
    """B2 whole and B5 chained against their twins on the card, bitwise,
    on :func:`projection_table` tables: sub-pixel levels with n_levels >
    k + 1 at R = 16 and 64, and at R = 512 (12 levels) deep columns of
    512 leaves at level 9 and of 2,048 at sub-pixel level 11; B5 chained
    over 512-row and ``MESH_TILE``-row tiles (all-invalid and padded
    tiles). Each call pair runs twice, the second on the kept scratch.
    ``f32``: the values cast to float32 through B5-f32 (B2 has no float32
    kernel). Returns the longest cell segment of the tables."""
    import torch

    from repro_torch.insitu.mesh_reduce import MESH_TILE
    from repro_torch.kernels import ops, raster, ref
    cases = [(16, 8, 48, (3, 7), 2100, 512),
             (64, 8, 48, (3, 7), 2100, 512),
             (512, 12, 4000, (3, 9, 11), 40000, MESH_TILE)]
    longest = 0
    for seed, (res, L, per, cols, run, tile_n) in enumerate(cases):
        x = projection_table(seed, resolution=res, n_levels=L,
                             per_level=per, column_levels=cols,
                             invalid_run=run)
        t = {k: torch.from_numpy(v).to(device) for k, v in x.items()
             if k != "n_levels"}
        if f32:
            t["values"] = t["values"].to(torch.float32)
        name = "projection_raster_carry_f32" if f32 else \
            "projection_raster_carry"
        c2 = ops.plane_coords(t["coords"], 2)
        args = (c2, t["levels"], t["values"], t["ok"])
        geo = dict(resolution=res, n_levels=L)
        longest = max(longest, longest_segment(*args[:2], t["ok"], **geo))
        want = ref.projection_raster_ref(*args, **geo)
        for _ in range(0 if f32 else 2):
            got = raster.projection_raster(*args, **geo)
            torch.cuda.synchronize()
            if not torch.equal(_bits(got), _bits(want)):
                raise AssertionError(f"projection table R={res} L={L}: B2 "
                                     f"differs from its twin (max abs err "
                                     f"{_max_abs_err(got, want)})")
        for tn in (512, tile_n):
            kw = dict(axis=2, resolution=res, n_levels=L, tile_n=tn)
            want = ops.raster_projection_partial(
                t["coords"], t["levels"], t["values"], t["ok"],
                backend="ref", **kw)
            n_tiles = -(-x["values"].shape[0] // tn)
            for _ in range(2):
                before = raster.LAUNCHES[name]
                got = ops.raster_projection_partial(
                    t["coords"], t["levels"], t["values"], t["ok"], **kw)
                torch.cuda.synchronize()
                launched = raster.LAUNCHES[name] - before
                if launched != n_tiles:
                    raise AssertionError(f"projection table R={res}: {name} "
                                         f"launched {launched} times for "
                                         f"{n_tiles} tiles")
                _same_bits(f"projection table R={res} L={L} tile_n={tn}: "
                           f"{name}", (got,), (want,))
        what = "B5-f32" if f32 else "B2 and B5"
        print(f"parity projection table R={res} L={L}: "
              f"{x['values'].shape[0]} rows, {what} (tiles of 512 and "
              f"{tile_n}) bit-equal to their twins, twice each")
    print(f"parity projection tables: longest cell segment {longest} rows")
    return longest


def check_parity_f32(label: str, x: dict, edges, n_hist: int, *,
                     resolution: int, tile_n: int) -> dict:
    """B4-f32 and B5-f32 chained over ``tile_n``-row tiles and B3-f32 on
    ``x``'s table with its values cast to float32, against their float32
    twins on the card, bitwise (float32 bits compared as int32); only the
    float32 counters move, once per tile and once per histogram."""
    import torch

    from repro_torch.kernels import raster, ref
    x = f32_inputs(x)
    n_tiles = -(-x["values"].shape[0] // tile_n)
    errs = {}
    for kind, name in (("slice", "slice_raster_carry_f32"),
                       ("projection", "projection_raster_carry_f32")):
        before = dict(raster.LAUNCHES)
        got = carry_chain(x, kind, None, resolution=resolution,
                          tile_n=tile_n)
        torch.cuda.synchronize()
        _check_launched(before, {name: n_tiles}, f"{label}: {name}")
        twin = carry_chain(x, kind, "ref", resolution=resolution,
                           tile_n=tile_n)
        torch.cuda.synchronize()
        errs[name] = _same_bits(f"{label}: {name}", got, twin)
    args = (x["values"], x["levels"], x["ok"], edges)
    before = dict(raster.LAUNCHES)
    got = raster.level_hist(*args, n_levels=n_hist)
    torch.cuda.synchronize()
    _check_launched(before, {"level_hist_f32": 1}, f"{label}: B3-f32")
    errs["level_hist_f32"] = _same_bits(
        f"{label}: level_hist_f32", (got,),
        (ref.level_hist_ref(*args, n_levels=n_hist),))
    print(f"parity {label} float32: B4-f32 and B5-f32 over {n_tiles} tiles "
          f"of {tile_n} rows and B3-f32 ({edges.numel() - 1} bins) "
          f"bit-equal to their float32 twins (R={resolution})")
    return errs


def level26_table(device) -> dict:
    """Leaves at level 26 of 27 whose float32 plane test at position 0.3
    differs from the float64 one (``tests/test_torch_mesh_f32.py``'s
    table): ``c * 2^-26`` and ``lo + 2^-26`` round in float32, so the
    pair 20132659/20132660 paints nothing there; plus level-2 leaves."""
    import numpy as np
    import torch
    rng = np.random.default_rng(26)
    c_axis = np.arange(20132656, 20132663)
    fine = np.stack([rng.integers(0, 1 << 26, c_axis.size),
                     rng.integers(0, 1 << 26, c_axis.size), c_axis], 1)
    coarse = rng.integers(0, 4, size=(9, 3))
    coarse[:, 2] = 1
    levels = np.concatenate([np.full(9, 2), np.full(c_axis.size, 26)])
    x = {"coords": np.concatenate([coarse, fine]).astype(np.int32),
         "levels": levels.astype(np.int32),
         "values": rng.standard_normal(levels.size).astype(np.float32),
         "ok": np.ones(levels.size, bool)}
    return {k: torch.from_numpy(v).to(device) for k, v in x.items()}


def check_level26(device) -> None:
    """B4-f32 and B4 on :func:`level26_table` at position 0.3 (R = 4)
    against their twins, bitwise: in float32 no level-26 leaf paints, in
    float64 the pair's first leaf does."""
    import torch

    from repro_torch.kernels import ops, raster
    t = level26_table(device)
    for dtype, name, deepest in ((torch.float32, "slice_raster_carry_f32",
                                  2),
                                 (torch.float64, "slice_raster_carry", 26)):
        kw = dict(axis=2, position=0.3, resolution=4, n_levels=27)
        vals = t["values"].to(dtype)
        before = dict(raster.LAUNCHES)
        got = ops.raster_slice_partial(t["coords"], t["levels"], vals,
                                       t["ok"], **kw)
        torch.cuda.synchronize()
        _check_launched(before, {name: 1}, f"level-26 {name}")
        twin = ops.raster_slice_partial(t["coords"], t["levels"], vals,
                                        t["ok"], backend="ref", **kw)
        _same_bits(f"level-26 plane case: {name}", got, twin)
        if int(got[1].max()) != deepest:
            raise AssertionError(f"level-26 plane case: {name} painted "
                                 f"level {int(got[1].max())}, expected "
                                 f"{deepest}")
    print("parity level-26 plane case (position 0.3, R=4): B4-f32 paints no "
          "level-26 leaf, B4 paints one; both bit-equal to their twins")


def hist_cases(seed: int = 18) -> dict:
    """B3's edge cases (numpy): name -> (values float64, levels int32, ok
    bool, edges float64, n_levels). Every value is a float32 too, so the
    float32 run bins the same numbers."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def table(values, n_levels, lv_lo=0, lv_hi=None):
        n = values.size
        levels = rng.integers(lv_lo, lv_hi or n_levels, n).astype(np.int32)
        return (values.astype(np.float32).astype(np.float64), levels,
                rng.random(n) < 0.9)

    lin = np.linspace(-4.0, 4.0, 33)            # float32 holds these exactly
    odd = np.sort(np.concatenate([rng.uniform(-3, 3, 20), [-1.0] * 3,
                                  [0.5] * 4, [2.0] * 2]))
    odd = odd.astype(np.float32).astype(np.float64)
    wide = np.linspace(0.1, 0.7, 65)            # inner edges not float32
    w32 = wide.astype(np.float32)
    near = np.concatenate([w32, np.nextafter(w32, np.float32(np.inf)),
                           np.nextafter(w32, np.float32(-np.inf))])
    special = rng.uniform(-5, 5, 4003)
    special[::7], special[1::11], special[2::13] = np.nan, np.inf, -np.inf
    return {
        "values on every edge and on hi": (*table(rng.permutation(
            np.concatenate([np.repeat(lin, 40), rng.uniform(-5, 5, 3001)])),
            5), lin, 5),
        "NaN and +-inf": (*table(special, 5), lin, 5),
        "levels out of range": (*table(rng.uniform(-5, 5, 4003), 5, -3, 9),
                                lin, 5),
        "non-uniform and duplicate edges": (*table(rng.permutation(
            np.concatenate([np.repeat(odd, 20), rng.uniform(-4, 4, 2003)])),
            4), odd, 4),
        "edges float32 cannot hold": (*table(rng.permutation(
            np.concatenate([np.repeat(near, 10),
                            rng.uniform(0.0, 0.8, 1001)])), 3), wide, 3),
        "L x B beyond shared memory (L=16, bins=4096)": (
            *table(rng.standard_normal(200_003), 16),
            np.linspace(-4.0, 4.0, 4097), 16),
        "edges beyond shared memory (bins=8192)": (
            *table(rng.standard_normal(50_001), 2),
            np.linspace(-4.0, 4.0, 8193), 2),
        "n = 0": (np.zeros(0), np.zeros(0, np.int32), np.zeros(0, bool),
                  lin, 5),
    }


def check_hist_cases(device) -> float:
    """B3 and B3-f32 on :func:`hist_cases` against their twins, bitwise:
    each table whole (16-byte loads and the n % 4 tail) and from row 1
    (unaligned: one row a thread), with the edges on the CPU (by value; past
    257 edges the wrapper uploads them) and on the card; each call twice,
    one launch a call, the output kept for the next call all zero after.
    Returns the max abs error (0.0)."""
    import torch

    from repro_torch.kernels import cudalib, raster, ref
    stream = cudalib.current_stream(device.index)
    calls, err = 0, 0.0
    for name, (v, lv, ok, edges, L) in hist_cases().items():
        cols = [torch.from_numpy(a).to(device) for a in (v, lv, ok)]
        e_cpu = torch.from_numpy(edges)
        e_dev = e_cpu.to(device)
        for dtype, counter in ((torch.float64, "level_hist"),
                               (torch.float32, "level_hist_f32")):
            vals = cols[0].to(dtype)
            for start in (0, 1):
                args = (vals[start:], cols[1][start:], cols[2][start:])
                twin = ref.level_hist_ref(*args, e_dev, n_levels=L)
                for e in (e_cpu, e_dev):
                    label = (f"B3 case {name!r}: {dtype}, rows from {start},"
                             f" edges on {e.device}")
                    before = dict(raster.LAUNCHES)
                    got = [raster.level_hist(*args, e, n_levels=L)
                           for _ in range(2)]
                    torch.cuda.synchronize()
                    _check_launched(before, {counter: 2}, label)
                    err = max([err] + [_same_bits(label, (g,), (twin,))
                                       for g in got])
                    kept = raster._HIST_NEXT[(device.index, stream, L,
                                              edges.size - 1)]
                    if bool(kept.any()):
                        raise AssertionError(f"{label}: the next call's "
                                             f"output is not all zero")
                    calls += 2
    print(f"parity B3 cases: {len(hist_cases())} tables x float64/float32 "
          f"x aligned/unaligned x CPU/card edges, {calls} calls, each "
          f"bit-equal to its twin, one launch a call, the next call's output "
          f"all zero after each")
    return err


# ----------------------------------------------------------- main path

def catalogs_equal(root_a: str, root_b: str, *, folds=None) -> int:
    """Bitwise catalog comparison; returns the number of arrays checked.

    ``folds`` maps (step, reducer name) to the image ``root_a`` must hold
    bit for bit (a multi-shard mesh's projection: the ascending fold of
    the per-shard host reductions); that image is held to ``root_b``
    within rtol 1e-12 instead of bitwise."""
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
                    if v.dtype != w.dtype or v.shape != w.shape:
                        raise AssertionError(f"step {s} {r}/{k} differs")
                    if folds and (s, r) in folds and k == "image":
                        if v.tobytes() != folds[s, r].tobytes():
                            raise AssertionError(f"step {s} {r}/{k} differs "
                                                 f"from the shard fold")
                        np.testing.assert_allclose(v, w, rtol=1e-12, atol=0,
                                                   err_msg=f"step {s} {r}")
                    elif v.tobytes() != w.tobytes():
                        raise AssertionError(f"step {s} {r}/{k} differs")
                    n += 1
        return n
    finally:
        ca.close()
        cb.close()


def run_engine(root: str, reducers, payloads, **engine_kw):
    """Submit ``payloads`` (step -> arrays) to an engine built with
    ``engine_kw`` (none: the host engine) and drain; returns the engine
    and the wall seconds of every submit+drain, per step."""
    import torch

    from repro_torch.insitu import InTransitEngine
    eng = InTransitEngine(root, reducers, policy="block", queue_capacity=4,
                          **engine_kw).start()
    walls = []
    for step, arrays in payloads:
        t0 = time.perf_counter()
        eng.submit(step, arrays)
        eng.drain(timeout=600.0)
        if engine_kw.get("device_reduce"):
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    eng.close()
    return eng, walls


def check_launches(counts: dict, label: str) -> None:
    missing = [k for k in DEVICE_PATH if counts.get(k, 0) <= 0]
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
                            [(s, on_card) for s in steps],
                            device_reduce=True, device=device)
    launches = dict(raster.LAUNCHES)
    check_launches(launches, "orion engine")
    ds = eng.device_stats
    if ds["fallback_snapshots"] or ds["fallback_runs"]:
        raise AssertionError(f"orion engine fell back to the host: {ds}")
    _, host_walls = run_engine(str(tmp / "orion_host"), live_reducers(),
                               [(s, arrays) for s in steps])
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


def step_breakdown(payload: dict, root: str, label: str,
                   **engine_kw) -> dict:
    """Where one step's wall time goes on an engine built with
    ``engine_kw``: the engine's own spans (host clock) over two steps,
    then the device's busy time (``torch.profiler``, CUDA activity only)
    over two more steps, as a share of the unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.insitu import InTransitEngine
    from repro_torch.obs.trace import TRACER
    eng = InTransitEngine(root, live_reducers(), policy="block",
                          **engine_kw).start()

    def steps(first: int) -> float:
        t0 = time.perf_counter()
        for step in (first, first + 1):
            eng.submit(step, payload)
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
    print(f"breakdown {label} per step (2 traced steps): wall {wall_ms!r} "
          f"ms; spans {spans!r}")
    if dev:
        print(f"breakdown {label} device busy {dev_ms!r} ms/step (2 "
              f"profiled steps, "
              f"{prof_wall_ms!r} ms/step under the profiler) = share "
              f"{out['device_busy_share']!r} of the traced wall; top "
              f"{out['device_top']!r}")
    else:
        print(f"breakdown {label} device busy: not measured (the profiler "
              f"recorded no device time)")
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
                        device_reduce=True, device=device)
    launches = dict(raster.LAUNCHES)
    check_launches(launches, "default DAG engine")
    ds = eng.device_stats
    if ds["fallback_snapshots"]:
        raise AssertionError(f"default DAG materialized a snapshot on the "
                             f"host: {ds}")
    run_engine(str(tmp / "cli_host"), cli.default_reducers(res, lod),
               payloads)
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


# ------------------------------------------------------------ mesh path

def shard_fold(arrays: dict, n_shards: int, reducer):
    """The read-side reference for a multi-shard projection: the host
    reducer over each Hilbert shard's leaves, folded in ascending shard
    order (``hercule.api._merge_sum``)."""
    import numpy as np

    from repro_torch.insitu.partition import leaf_shards
    from repro_torch.insitu.staging import Snapshot
    refine = np.asarray(arrays["refine"])
    leaves = np.flatnonzero(~refine)
    shard = leaf_shards(arrays, n_shards)
    acc = None
    for g in range(n_shards):
        owner = np.zeros(refine.shape[0], bool)
        owner[leaves[shard == g]] = True
        part = reducer.reduce(Snapshot(step=0, kind="amr",
                                       arrays={**arrays, "owner": owner},
                                       n_domains=2), {})["image"]
        acc = part if acc is None else acc + part
    return acc


def mesh_tiles(arrays: dict, n_shards: int) -> int:
    """B4/B5 launches per reducer per step: tiles over every shard."""
    from repro_torch.insitu.mesh_reduce import MESH_TILE, MeshTable
    mt = MeshTable(arrays, 1, ["cpu"] * n_shards)    # row split only
    return n_shards * -(-mt.rows_padded // MESH_TILE)


def check_mesh_launches(counts: dict, label: str, *, tiles: int,
                        n_shards: int, steps: int, suffix: str = "") -> None:
    """B4 and B5 once per tile, B3 once per shard, every step, in the
    kernels of ``suffix`` ("" float64, "_f32" float32); every other raster
    kernel never."""
    from repro_torch.kernels import raster
    want = dict.fromkeys(raster.LAUNCHES, 0)
    want.update({f"slice_raster_carry{suffix}": tiles * steps,
                 f"projection_raster_carry{suffix}": tiles * steps,
                 f"level_hist{suffix}": n_shards * steps})
    got = {k: counts.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def main_path_mesh(tree, tmp: Path, device, host_root: str) -> tuple:
    """``device_reduce="mesh"`` over Orion with one shard, then
    ``MESH_SHARDS`` shards on the one card; each catalog held to the
    host engine's (``host_root``, same steps and DAG)."""
    from repro_torch.insitu import ProjectionReducer
    from repro_torch.kernels import raster
    arrays = tree.to_arrays()
    steps = range(1, ORION_STEPS + 2)      # first step warms the allocator
    out, first = {}, None
    for n_shards in (1, MESH_SHARDS):
        t0 = time.perf_counter()
        tiles = mesh_tiles(arrays, n_shards)
        split_ms = 1e3 * (time.perf_counter() - t0)
        root = str(tmp / f"orion_mesh{n_shards}")
        raster.reset_launches()
        eng, walls = run_engine(root, live_reducers(),
                                [(s, arrays) for s in steps],
                                device_reduce="mesh",
                                mesh_devices=[device] * n_shards)
        launches = dict(raster.LAUNCHES)
        check_mesh_launches(launches, f"mesh S={n_shards}", tiles=tiles,
                            n_shards=n_shards, steps=len(walls))
        ds = eng.device_stats
        if ds["fallback_snapshots"] or ds["fallback_runs"]:
            raise AssertionError(f"mesh S={n_shards} fell back to the "
                                 f"host: {ds}")
        folds = None
        if n_shards > 1:
            proj = next(r for r in live_reducers()
                        if isinstance(r, ProjectionReducer))
            fold = shard_fold(arrays, n_shards, proj)
            folds = {(s, proj.name): fold for s in steps}
        n = catalogs_equal(root, host_root, folds=folds)
        timed = walls[1:]
        out[n_shards] = {
            "wall_ms_per_step": 1e3 * sum(timed) / len(timed),
            "wall_ms_steps": [1e3 * w for w in walls],
            "tiles_per_step": tiles, "launches": launches,
            "host_shard_split_ms": split_ms,
            "peak_leaf_frac": ds["peak_leaf_frac"],
            "bytes_tables_to_device_per_step":
                ds["bytes_tables_to_device"] / len(walls),
            "bytes_to_host_per_step": ds["bytes_to_host"] / len(walls)}
        if first is None:
            first = launches
        how = "bit-equal to the host engine" if n_shards == 1 else \
            ("slice/hist bit-equal to the host engine, projection bit-equal "
             "to the shard fold and within rtol 1e-12 of the host")
        print(f"main path mesh S={n_shards} on {device}: {len(walls)} Orion "
              f"steps, catalog {how} ({n} arrays), fallback_snapshots=0, "
              f"{tiles} tiles per step, launches {launches}, "
              f"peak_leaf_frac {ds['peak_leaf_frac']!r}")
        print(f"time mesh_wall_ms_per_step S={n_shards}: "
              f"{out[n_shards]['wall_ms_per_step']!r} (steps 2-{len(walls)}; "
              f"all steps {out[n_shards]['wall_ms_steps']!r}); "
              f"{out[n_shards]['bytes_tables_to_device_per_step']!r} bytes "
              f"of sharded table up per step; the host shard split "
              f"(MeshTable init) alone {split_ms!r} ms")
        out[n_shards]["breakdown"] = step_breakdown(
            arrays, str(tmp / f"orion_mesh{n_shards}_prof"),
            f"mesh S={n_shards}", device_reduce="mesh",
            mesh_devices=[device] * n_shards)
    return first, out


def main_path_mesh_f32(tree, device, mesh64: dict) -> dict:
    """``MeshDAGRunner(dtype="float32")`` over Orion with one shard and
    with ``MESH_SHARDS`` on the one card, each beside the same runner at
    float64 (``dtype=None``) in the same call: every output bitwise the
    float32 runner's with ``backend="ref"`` (the float32 twins, on the
    card), the slice within rtol 1e-6 and the projection within 1e-4 of
    the float64 host reducers, the histogram and its edges equal to the
    host's over the float32-cast field; launches, walls and bytes per
    step. ``mesh64`` is :func:`main_path_mesh`'s (engine) result."""
    import numpy as np
    import torch

    from repro_torch.insitu import ReducerDAG
    from repro_torch.insitu.mesh_reduce import MeshDAGRunner, MeshTable
    from repro_torch.insitu.staging import Snapshot
    from repro_torch.kernels import raster
    arrays = tree.to_arrays()
    cast = {**arrays, "field:density": arrays["field:density"]
            .astype(np.float32).astype(np.float64)}
    host, cast_host = (ReducerDAG(live_reducers()).run(
        Snapshot(step=0, kind="amr", arrays=a)) for a in (arrays, cast))
    names = {k.split("-")[0]: k for k in host}
    steps = range(1, ORION_STEPS + 2)      # first step warms the allocator
    out = {}
    for n_shards in (1, MESH_SHARDS):
        devices = [device] * n_shards
        tiles = mesh_tiles(arrays, n_shards)
        runs = {"float64": [], "float32": []}
        # in turns, so the host's drift falls on both alike
        for dtype in (None, "float32", "float32", None):
            runner = MeshDAGRunner(ReducerDAG(live_reducers()),
                                   devices=devices, dtype=dtype)
            walls = []
            raster.reset_launches()
            for s in steps:
                t0 = time.perf_counter()
                got = runner.run(Snapshot(step=s, kind="amr", arrays=arrays))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            launches = dict(raster.LAUNCHES)
            if dtype:
                last = got          # a float32 run's, compared below
            st = runner.stats.as_dict()
            check_mesh_launches(
                launches, f"mesh {dtype or 'float64'} S={n_shards}",
                tiles=tiles, n_shards=n_shards, steps=len(walls),
                suffix="_f32" if dtype else "")
            if st["fallback_snapshots"] or st["fallback_runs"]:
                raise AssertionError(f"mesh float32 S={n_shards} fell back "
                                     f"to the host: {st}")
            runs[dtype or "float64"].append({
                "wall_ms_per_step": 1e3 * sum(walls[1:]) / len(walls[1:]),
                "wall_ms_steps": [1e3 * w for w in walls],
                "launches": launches,
                "bytes_tables_to_device_per_step":
                    st["bytes_tables_to_device"] / len(walls),
                "bytes_to_host_per_step": st["bytes_to_host"] / len(walls)})
        f32, f64 = runs["float32"][0], runs["float64"][0]
        twin = MeshDAGRunner(ReducerDAG(live_reducers()), devices=devices,
                             backend="ref", dtype="float32").run(
            Snapshot(step=0, kind="amr", arrays=arrays))
        got, n = last, 0
        for name, o in twin.items():
            for k, v in o.items():
                g = got[name][k]
                if g.dtype != v.dtype or g.tobytes() != v.tobytes():
                    raise AssertionError(f"mesh float32 S={n_shards} "
                                         f"{name}/{k} differs from the "
                                         f"float32 twins' run")
                n += 1
        sl, pr = got[names["slice"]]["image"], got[names["proj"]]["image"]
        if sl.dtype != np.float32 or pr.dtype != np.float32:
            raise AssertionError(f"mesh float32 images are {sl.dtype}, "
                                 f"{pr.dtype}")
        np.testing.assert_allclose(sl.astype(np.float64),
                                   host[names["slice"]]["image"], rtol=1e-6)
        np.testing.assert_allclose(pr.astype(np.float64),
                                   host[names["proj"]]["image"], rtol=1e-4)
        for k in ("hist", "edges"):
            if not np.array_equal(got[names["hist"]][k],
                                  cast_host[names["hist"]][k]):
                raise AssertionError(f"mesh float32 S={n_shards} hist/{k} "
                                     f"differs from the host's over the "
                                     f"cast field")
        rows = MeshTable(arrays, 1, ["cpu"] * n_shards).rows_padded
        half = n_shards * rows * 4
        res = LIVE_RESOLUTION
        if f64["bytes_tables_to_device_per_step"] - \
                f32["bytes_tables_to_device_per_step"] != half or \
                f64["bytes_to_host_per_step"] - \
                f32["bytes_to_host_per_step"] != 2 * res * res * 4:
            raise AssertionError(f"mesh float32 S={n_shards} bytes: "
                                 f"{f32} against float64 {f64}")
        walls = {k: [r["wall_ms_per_step"] for r in v]
                 for k, v in runs.items()}
        out[n_shards] = {"float32": f32, "float64_runner": f64,
                         "wall_ms_per_step_runs": walls,
                         "tiles_per_step": tiles, "arrays_checked": n}
        print(f"main path mesh float32 S={n_shards} on {device}: "
              f"MeshDAGRunner(dtype='float32'), {len(steps)} Orion steps, "
              f"{n} outputs bit-equal to the float32 twins' run on the card, "
              f"slice within rtol 1e-6 and projection within 1e-4 of the "
              f"float64 host reducers, histogram and edges equal to the "
              f"host's over the cast field; {tiles} tiles per step, "
              f"launches {f32['launches']}")
        print(f"time mesh_f32_wall_ms_per_step S={n_shards}: runs 2 and 3 "
              f"{walls['float32']!r} (steps 2-{len(steps)}; all steps of "
              f"run 2 {f32['wall_ms_steps']!r}); the same runner at float64, "
              f"runs 1 and 4, {walls['float64']!r} (all steps of run 1 "
              f"{f64['wall_ms_steps']!r}); the float64 engine "
              f"{mesh64[n_shards]['wall_ms_per_step']!r}")
        print(f"bytes mesh S={n_shards} per step: bytes_tables_to_device "
              f"float32 {f32['bytes_tables_to_device_per_step']!r}, float64 "
              f"{f64['bytes_tables_to_device_per_step']!r} (engine "
              f"{mesh64[n_shards]['bytes_tables_to_device_per_step']!r}); "
              f"bytes_to_host float32 {f32['bytes_to_host_per_step']!r}, "
              f"float64 {f64['bytes_to_host_per_step']!r}")
    return out


def main_path_mesh_cli(tmp: Path, device) -> dict:
    """``python -m repro_torch.launch.insitu --device-mesh 4 --device D``
    on Sedov steps: its catalog held to the host CLI run's under the
    mesh contract, its kernels launched per tile."""
    from repro_torch.insitu import ProjectionReducer
    from repro_torch.kernels import raster
    from repro_torch.launch import insitu as cli
    from repro_torch.sim import amrgen, fields
    n_steps, max_level, res = 4, 6, 128
    common = ["--steps", str(n_steps), "--max-level", str(max_level),
              "--resolution", str(res), "--policy", "block", "--queries",
              "4"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(["--out", str(tmp / "mesh_cli_host"), *common]) != 0:
            raise AssertionError(f"host CLI run failed:\n{buf.getvalue()}")
    buf = io.StringIO()
    raster.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--out", str(tmp / "mesh_cli"), *common,
                       "--device-mesh", str(MESH_SHARDS), "--device",
                       str(device)])
    launches = dict(raster.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"launch/insitu.py --device-mesh exited {rc}:"
                             f"\n{buf.getvalue()}")
    # the CLI writes every second step (--output-every 2): the trees of
    # those steps, as the launcher makes them, give the shard folds
    proj = next(r for r in cli.default_reducers(res, 4)
                if isinstance(r, ProjectionReducer))
    folds, tiles = {}, 0
    for s in range(1, n_steps + 1):
        tree = amrgen.generate_tree(
            fields.sedov(r_shock=0.1 + 0.25 * s / n_steps), min_level=3,
            max_level=max_level, threshold=1.15, level_factor=1.05)
        if s % 2 == 0:
            folds[s, proj.name] = shard_fold(tree.to_arrays(), MESH_SHARDS,
                                             proj)
            tiles += mesh_tiles(tree.to_arrays(), MESH_SHARDS)
    n = catalogs_equal(str(tmp / "mesh_cli"), str(tmp / "mesh_cli_host"),
                       folds=folds)
    want = {"slice_raster_carry": tiles, "projection_raster_carry": tiles,
            "level_hist": MESH_SHARDS * len(folds)}
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"--device-mesh launches {launches}, "
                             f"expected {want}")
    summary = next((ln.strip() for ln in buf.getvalue().splitlines()
                    if "mesh reduce[" in ln), "")
    print(f"main path python -m repro_torch.launch.insitu --device-mesh "
          f"{MESH_SHARDS} --device {device}: rc 0, catalog under the mesh "
          f"contract ({n} arrays), launches {launches}; {summary}")
    return launches



# ------------------------------------------------------------ codec path

def field_words(tree, field: str, device, width: int = 64) -> list:
    """The host codec's level-fused father/son groups of ``field``
    (``core.fpdelta._tree_groups``) as the (S, G) int32 words
    ``[pred_hi, pred_lo, son_hi, son_lo]`` on ``device``."""
    import torch

    from repro_torch.core import fpdelta
    from repro_torch.kernels import ops
    pred, sons, _ = fpdelta._tree_groups(tree, tree.fields[field])
    p = torch.from_numpy(pred).to(device)
    s = torch.from_numpy(sons).to(device)
    if width == 64:
        (ph, plo), (sh, slo) = ops.f64_bits(p), ops.f64_bits(s)
    else:
        bits = ops.f32_bits if width == 32 else ops.bf16_bits
        plo, slo = bits(p), bits(s)
        ph, sh = torch.zeros_like(plo), torch.zeros_like(slo)
    return [t.T.contiguous() for t in (ph[:, None].expand_as(sh),
                                       plo[:, None].expand_as(slo), sh, slo)]


def stream_words(packed) -> tuple:
    """``compress_bits``' code and payload words cut to their bit counts,
    as the host codec's uint32 arrays."""
    import numpy as np
    code_words, payload_words, code_bits, payload_bits = packed
    nc, npl = (max(1, (int(b) + 31) // 32) for b in (code_bits, payload_bits))
    return (code_words[:nc].cpu().numpy().view(np.uint32),
            payload_words[:npl].cpu().numpy().view(np.uint32))


def packbits_words(flags):
    """``np.packbits`` of ``flags`` (little bit order) in whole
    little-endian 32-bit words: the bitfield the host writes."""
    import numpy as np
    b = np.packbits(np.asarray(flags, bool), bitorder="little")
    return np.pad(b, (0, (-b.size) % 4)).view("<u4")


def _all_equal(label: str, pairs) -> float:
    """Raise unless every (got, want) pair is bitwise equal; the largest
    absolute difference, 0.0."""
    import torch
    err = 0.0
    for name, got, want in pairs:
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"{label}: {name} differs from its plain "
                                 f"twin (max abs err "
                                 f"{_max_abs_err(got, want)})")
        err = max(err, _max_abs_err(got, want))
    return err


def check_codec_parity(label: str, tree, device) -> dict:
    """B6/B7 on ``tree``'s density groups (widths 64/32/16; zbits 2, 4, 8
    at width 64) and B8/B9 on its ``refine`` flags against their twins,
    bitwise; B7 must also give the son words back."""
    import torch

    from repro_torch.kernels import codec, ref
    errs = dict.fromkeys(("encode_groups", "decode_groups", "bitpack",
                          "bitunpack"), 0.0)
    for width, zbits in ((64, 2), (64, 4), (64, 8), (32, 4), (16, 4)):
        words = field_words(tree, "density", device, width)
        got = codec.encode_groups(*words, zbits, width)
        twin = ref.group_residues_ref(*words, zbits, width)
        errs["encode_groups"] = max(errs["encode_groups"], _all_equal(
            f"{label} width {width} zbits {zbits}",
            [("encode_groups", a, b) for a, b in zip(got, twin)]))
        sons = codec.decode_groups(got[0], got[1], words[0], words[1])
        twin = ref.decode_residues_ref(got[0], got[1], words[0], words[1])
        errs["decode_groups"] = max(errs["decode_groups"], _all_equal(
            f"{label} width {width}",
            [("decode_groups", a, b) for a, b in zip(sons, twin)]
            + [("decode_groups (son words)", a, b)
               for a, b in zip(sons, words[2:])]))
    flags = torch.from_numpy(tree.refine).to(device)
    packed = codec.bitpack(flags)
    back = codec.bitunpack(packed, flags.shape[0])
    errs["bitpack"] = _all_equal(label, [("bitpack", packed,
                                          ref.bitpack_ref(flags))])
    errs["bitunpack"] = _all_equal(label, [
        ("bitunpack", back, ref.bitunpack_ref(packed, flags.shape[0])),
        ("bitunpack (flags)", back.bool(), flags)])
    print(f"parity {label}: B6 (widths 64/32/16, zbits 2/4/8) and B7 "
          f"bit-equal to their twins over {words[0].shape[1]} groups of "
          f"{words[0].shape[0]} sons; B8/B9 over {flags.shape[0]} refine "
          f"flags")
    return errs


def codec_path_orion(tree, device) -> dict:
    """The codec on the card over one Orion snapshot (see the module
    docstring, phase 5): words held to the host codec's, son words and
    flags round-tripped, launches counted, walls timed."""
    import numpy as np
    import torch

    from repro_torch.core import fpdelta
    from repro_torch.kernels import codec, ops
    names = list(tree.fields)
    refine = torch.from_numpy(tree.refine)

    def snapshot(split: dict | None = None):
        """Encode every field (host gather, upload, B6 and the packing,
        streams to the host), then decode each on the card (B7) and pack
        and unpack ``refine`` (B8, B9); returns the two walls in ms.
        ``split`` adds each encode stage's ms, synchronized per stage."""
        def stage(key, fn, *args):
            if split is None:
                return fn(*args)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            split[key] = split.get(key, 0.0) + 1e3 * (time.perf_counter() - t)
            return out

        t0 = time.perf_counter()
        enc = {}
        for f in names:
            words = stage("gather_upload", field_words, tree, f, device)
            packed = stage("compress_bits", ops.compress_bits, *words)
            enc[f] = (words, packed, stage("streams_to_host", stream_words,
                                           packed))
        t1 = time.perf_counter()
        dec = {f: ops.decompress_bits(*packed[:2], *words[:2])
               for f, (words, packed, _) in enc.items()}
        flags = refine.to(device)
        packed_flags = ops.bitfield_pack(flags)
        back = ops.bitfield_unpack(packed_flags, flags.shape[0])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return enc, dec, (flags, packed_flags, back), \
            (1e3 * (t1 - t0), 1e3 * (t2 - t1))

    snapshot()                           # warm-up: allocator, torch's kernels
    codec.reset_launches()
    enc, dec, (flags, packed_flags, back), first = snapshot()
    launches = dict(codec.LAUNCHES)
    want = {"encode_groups": len(names), "decode_groups": len(names),
            "bitpack": 1, "bitunpack": 1}
    if launches != want:
        raise AssertionError(f"codec snapshot launches {launches}, "
                             f"expected {want}")
    walls = [first] + [snapshot()[3] for _ in range(2)]
    split: dict = {}
    snapshot(split)
    t0 = time.perf_counter()
    host = {f: fpdelta.encode_tree_field(tree, f) for f in names}
    host_ms = 1e3 * (time.perf_counter() - t0)
    n_words = n_bytes = 0
    for f in names:
        words, _, (codes, payload) = enc[f]
        stream = host[f].stream
        if not (np.array_equal(codes, stream.codes)
                and np.array_equal(payload, stream.payload)):
            raise AssertionError(f"codec {f}: stream words differ from the "
                                 f"host codec's")
        if not (torch.equal(dec[f][0], words[2])
                and torch.equal(dec[f][1], words[3])):
            raise AssertionError(f"codec {f}: decoded son words differ")
        n_words += codes.size + payload.size
        n_bytes += stream.nbytes
    if not np.array_equal(packed_flags.cpu().numpy().view(np.uint32),
                          packbits_words(tree.refine)):
        raise AssertionError("bitfield_pack(refine) differs from np.packbits")
    if not torch.equal(back.bool(), flags):
        raise AssertionError("bitfield_unpack did not give refine back")
    pred, sons, _ = fpdelta._tree_groups(tree, tree.fields["density"])
    for width in (32, 16):
        codes, payload = stream_words(ops.compress_bits(
            *field_words(tree, "density", device, width), width=width))
        blk = fpdelta.encode(pred, sons, width=width)
        if not (np.array_equal(codes, blk.codes)
                and np.array_equal(payload, blk.payload)):
            raise AssertionError(f"codec density width {width}: stream "
                                 f"words differ from the host codec's")
        n_words += codes.size + payload.size
    raw = tree.n_nodes * 8 * len(names)
    out = {"launches": launches, "fields": names,
           "encode_wall_ms": [w[0] for w in walls],
           "decode_wall_ms": [w[1] for w in walls],
           "encode_split_ms": split,
           "host_encode_ms": host_ms, "stream_bytes": n_bytes,
           "raw_bytes": raw, "words_checked": n_words}
    print(f"codec path orion: {len(names)} fields {names} at width 64 "
          f"({sons.shape[0]} groups each), density at 32 and 16, and "
          f"{tree.n_nodes} refine flags: {n_words} stream words equal to "
          f"the host codec's, son words and flags round-tripped, launches "
          f"per snapshot {launches}")
    print(f"time codec_wall_ms_per_snapshot: encode {out['encode_wall_ms']!r}"
          f" (host gather, upload, compress_bits, streams to the host), "
          f"decode {out['decode_wall_ms']!r} (decompress_bits and refine "
          f"pack/unpack); host codec encode_tree_field over the same fields "
          f"{host_ms!r} ms; streams {n_bytes} bytes against {raw} raw")
    print(f"breakdown codec encode per snapshot (one more run, stages "
          f"synchronized): {split!r} ms")
    return out


# ---------------------------------------------------- serving and ledger

SERVE_LOAD_CLIENTS = 64  # viewers of the catalog_serve load test


def _src_env() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def serve_orion_catalog(root: str, host_root: str) -> dict:
    """Phase 7a: the Orion catalog the card reduced, served by the port's
    ``CatalogServer``; every remote query (buffered and progressive) must
    be bitwise the local ``Catalog.query`` and the host engine's."""
    import numpy as np

    from repro_torch.insitu import Catalog, CatalogServer, RemoteCatalog
    local, host = Catalog(root), Catalog(host_root)
    srv = CatalogServer(root, port=0, compress=True).start()
    try:
        rc = RemoteCatalog(srv.url, timeout=120.0)
        steps = rc.steps()
        if steps != local.steps() or steps != host.steps() or not steps:
            raise AssertionError(f"served steps {steps} != local "
                                 f"{local.steps()} / host {host.steps()}")
        n = n_q = nbytes = 0
        t_buf = t_prog = 0.0
        for s in steps:
            if rc.reducers(s) != local.reducers(s):
                raise AssertionError(f"step {s}: served reducers differ")
            for r in local.reducers(s):
                want, want_host = local.query(s, r), host.query(s, r)
                n_q += 1
                t0 = time.perf_counter()
                got = rc.query(s, r)
                t_buf += time.perf_counter() - t0
                t0 = time.perf_counter()
                final = None
                for final in rc.query_progressive(s, r):
                    pass
                t_prog += time.perf_counter() - t0
                for k, v in want.items():
                    for label, other in (("served", got[k]),
                                         ("progressive", final[k]),
                                         ("host engine", want_host[k])):
                        if other.dtype != v.dtype or not np.array_equal(
                                v, other, equal_nan=True):
                            raise AssertionError(f"step {s} {r}/{k}: "
                                                 f"{label} differs")
                    n += 1
                    nbytes += v.nbytes
        info = rc.cache_info()
    finally:
        srv.close()
        local.close()
        host.close()
    out = {"arrays": n, "queries": n_q, "bytes": nbytes,
           "buffered_ms_per_query": 1e3 * t_buf / n_q,
           "progressive_ms_per_query": 1e3 * t_prog / n_q,
           "server_requests": info["server"]["requests"]}
    print(f"serve orion catalog: {len(steps)} steps, {n_q} objects, "
          f"{n} arrays ({nbytes} bytes) "
          f"bitwise Catalog.query and the host engine's, buffered and "
          f"progressive (compress=True); host ms a query: buffered "
          f"{out['buffered_ms_per_query']!r}, progressive "
          f"{out['progressive_ms_per_query']!r}")
    return out


def serve_load(root: str) -> dict:
    """Phase 7b: ``python -m repro_torch.launch.catalog_serve --selftest
    --load 64`` over the Orion device catalog, as a user runs it."""
    import re
    cmd = [sys.executable, "-m", "repro_torch.launch.catalog_serve",
           "--selftest", "--load", str(SERVE_LOAD_CLIENTS), "--root", root]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=_src_env(), timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"catalog_serve --selftest --load "
                             f"{SERVE_LOAD_CLIENTS} exited "
                             f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    text = proc.stdout
    m = re.search(r"sustained (\S+) q/s, p99 (\S+) ms; engine: (\d+) backend "
                  r"reads for (\d+) requests \((\S+)x\), (\d+) coalesced, "
                  r"(\d+) batched, (\d+) rejected, (\d+) cache-served", text)
    if m is None:
        raise AssertionError(f"no load-test summary in:\n{text[-4000:]}")
    keys = ("qps", "p99_ms", "backend_reads", "requests", "ratio",
            "coalesced", "batched_reads", "rejections", "cache_serves")
    out = {k: float(v) for k, v in zip(keys, m.groups())}
    out["seconds"] = secs
    for ln in text.splitlines():
        if any(w in ln for w in ("== load test", " ok, ", "sustained",
                                 "herd of", "arrays compared")):
            print(f"serve load: {ln.strip()}")
    print(f"serve load: python -m repro_torch.launch.catalog_serve "
          f"--selftest --load {SERVE_LOAD_CLIENTS} over the Orion device "
          f"catalog: rc 0 in {secs!r} s; qps {out['qps']!r}, p99 "
          f"{out['p99_ms']!r} ms, coalesced {int(out['coalesced'])}, "
          f"batched {int(out['batched_reads'])}, rejected "
          f"{int(out['rejections'])}")
    return out


def cli_serve_ledger(tmp: Path, device) -> dict:
    """Phase 7c: ``launch/insitu.py --device-reduce --serve-check
    --ledger`` on Sedov steps, then ``launch.obs report`` on its run."""
    import re

    from repro_torch.kernels import raster
    from repro_torch.launch import insitu as cli
    from repro_torch.obs import TRACER, LedgerReader
    run = str(tmp / "cli_ledger")
    argv = ["--out", run, "--steps", "4", "--max-level", "6",
            "--resolution", "128", "--policy", "block", "--queries", "4",
            "--device-reduce", "--device", str(device), "--serve-check",
            "--ledger"]
    buf = io.StringIO()
    raster.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    launches = dict(raster.LAUNCHES)
    TRACER.disable()           # --ledger switched the tracer on
    TRACER.clear()
    text = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"launch/insitu.py --serve-check --ledger "
                             f"exited {rc}:\n{text}")
    check_launches(launches, "launch/insitu.py --serve-check --ledger")
    m = re.search(r"serve check \S+: (\d+) arrays, (\d+) mismatched", text)
    if m is None or int(m.group(2)) != 0 or int(m.group(1)) == 0:
        raise AssertionError(f"serve check failed:\n{text}")
    ledger_line = next(ln.strip() for ln in text.splitlines()
                       if ln.strip().startswith("ledger:"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.obs",
                           "report", run], capture_output=True, text=True,
                          cwd=ROOT, env=_src_env(), timeout=300)
    if proc.returncode != 0 or "verdict:" not in proc.stdout:
        raise AssertionError(f"launch.obs report exited {proc.returncode}:"
                             f"\n{proc.stdout}\n{proc.stderr}")
    verdict = next(ln.strip() for ln in proc.stdout.splitlines()
                   if "verdict:" in ln)
    reader = LedgerReader(run)
    try:
        flushes = reader.flushes()
        signals = [next(iter(f["parts"]["meta"].values()))["signals"]
                   for f in flushes]
        fallbacks = [sig.get("device_fallbacks") for sig in signals]
        attributed = sorted(reader.attribs())
        run_verdict = reader.verdict(flushes)
    finally:
        reader.close()
    if not fallbacks or any(v != 0.0 for v in fallbacks):
        raise AssertionError(f"ledger device_fallbacks signal: {fallbacks}")
    if run_verdict == "critical":
        raise AssertionError(f"ledger verdict critical:\n{proc.stdout}")
    print(f"cli serve+ledger: python -m repro_torch.launch.insitu "
          f"--device-reduce --serve-check --ledger: rc 0, {m.group(1)} "
          f"arrays served, 0 mismatched; launches {launches}; "
          f"{ledger_line}")
    print(f"cli serve+ledger: python -m repro_torch.launch.obs report: rc "
          f"0, {len(flushes)} flushes, {verdict}; device_fallbacks signal "
          f"{fallbacks}; steps attributed {attributed}")
    return {"launches": launches, "flushes": len(flushes),
            "device_fallbacks": fallbacks, "verdict": run_verdict,
            "steps_attributed": attributed}


def time_ledger(arrays: dict, tmp: Path, device) -> dict:
    """Phase 7d: the Orion device-reduce wall per step with a bound
    ledger (the CLI's: tracer on, 1 s flush interval) beside the wall
    without one, four runs each in turns (off, on, on, off, ...), and
    one explicit flush's ms and bytes."""
    from repro_torch.insitu.device import to_device
    from repro_torch.obs import TRACER, RunLedger
    on_card = to_device(arrays, device)
    steps = range(1, ORION_STEPS + 2)
    walls = {"off": [], "on": []}
    flush = None
    order = ("off", "on", "on", "off") * 2
    for i, arm in enumerate(order):
        root = str(tmp / f"ledger_{i}_{arm}")
        led = None
        if arm == "on":
            TRACER.clear()
            TRACER.enable()
            led = RunLedger(root, "trainer", interval=1.0)
        try:
            _, w = run_engine(root, live_reducers(),
                              [(s, on_card) for s in steps],
                              device_reduce=True, device=device,
                              ledger=led)
            if led is not None and flush is None:
                before = led.bytes_written
                t0 = time.perf_counter()
                led.flush()
                flush = {"ms": 1e3 * (time.perf_counter() - t0),
                         "bytes": led.bytes_written - before}
        finally:
            if led is not None:
                led.close()
                TRACER.disable()
                TRACER.clear()
        walls[arm].append(1e3 * sum(w[1:]) / len(w[1:]))
    out = {"wall_ms_per_step_off": walls["off"],
           "wall_ms_per_step_on": walls["on"], "order": list(order),
           "flush_ms": flush["ms"], "flush_bytes": flush["bytes"]}
    print(f"time ledger: device_reduce wall per Orion step (steps "
          f"2-{ORION_STEPS + 1}), in turns {list(order)}: without "
          f"{walls['off']!r} ms, with the ledger bound {walls['on']!r} ms; "
          f"one explicit flush {flush['ms']!r} ms, {flush['bytes']} bytes")
    return out


def serving_and_ledger(tree, tmp: Path, device) -> dict:
    """Phase 7 (see the module docstring)."""
    out = {"serve": serve_orion_catalog(str(tmp / "orion_dev"),
                                        str(tmp / "orion_host")),
           "load": serve_load(str(tmp / "orion_dev")),
           "cli": cli_serve_ledger(tmp, device),
           "ledger": time_ledger(tree.to_arrays(), tmp, device)}
    return out


# ------------------------------------------------------ 8. HProt on the card

#: one decoder layer of stablelm-1.6b at its full width
#: (src/repro/configs/stablelm_1_6b.py: d_model 2048, d_ff 5632, swiglu
#: MLP, layernorm): 51,388,416 parameters
D_MODEL, D_FF = 2048, 5632
HPROT_SHARDS = 4           # the mesh path's S = 4, on the one card
HPROT_SAVES = 4            # full, delta, delta, full rebase (delta_every=2)
#: shard counts every step restores onto; None: whole, from meta templates
HPROT_LAYOUTS = (4, 2, 8, None)


def hprot_tree(make) -> dict:
    """The layer's train-state tree with ``make(shape, dtype)`` at every
    leaf: bfloat16 parameters (a mixed-precision run), float32 Adam
    moments and an int32 step."""
    import torch
    d, f = D_MODEL, D_FF
    shapes = {"attn": {"q": (d, d), "k": (d, d), "v": (d, d), "o": (d, d)},
              "mlp": {"gate": (d, f), "up": (d, f), "down": (f, d)},
              "ln1": {"scale": (d,), "bias": (d,)},
              "ln2": {"scale": (d,), "bias": (d,)}}

    def layer(dtype, kind):
        return {blk: {n: make(shape, dtype, kind) for n, shape in
                      leaves.items()} for blk, leaves in shapes.items()}
    return {"params": layer(torch.bfloat16, "param"),
            "opt": {"mu": layer(torch.float32, "mu"),
                    "nu": layer(torch.float32, "nu")},
            "step": make((), torch.int32, "step")}


def hprot_state(device, seed: int = 20) -> dict:
    """(a) The layer's train state, made on the card from a seeded
    generator: matrices row-sharded over ``[device] * 4``, vectors
    replicated (ownership pruning writes them once)."""
    import torch

    from repro_torch.hercule.checkpoint import replicate, shard_rows
    gen = torch.Generator(device=device).manual_seed(seed)
    devs = [device] * HPROT_SHARDS

    def make(shape, dtype, kind):
        if kind == "step":
            return torch.zeros((), dtype=dtype, device=device)
        x = torch.randn(shape, generator=gen, device=device)
        x = {"param": x * 0.02, "mu": x * 1e-3,
             "nu": x.square() * 1e-6}[kind].to(dtype)
        return shard_rows(x, devs) if x.ndim == 2 else replicate(x, devs)
    return hprot_tree(make)


def hprot_template(n, device) -> dict:
    """The state's layout over ``[device] * n`` (``None``: whole leaves
    from ``meta`` tensors, restored onto the current CUDA device)."""
    import torch

    from repro_torch.hercule.checkpoint import ShardSpec

    def make(shape, dtype, kind):
        if n is None:
            return torch.empty(shape, dtype=dtype, device="meta")
        if not shape:
            return torch.empty((), dtype=dtype, device=device)
        devs = [device] * n
        return ShardSpec.rows(shape, dtype, devs) if len(shape) == 2 \
            else ShardSpec.replicated(shape, dtype, devs)
    return hprot_tree(make)


def hprot_leaves(state, device=None) -> dict:
    """keystr -> a copy of the leaf as one tensor (on ``device``, else
    where its first shard lives)."""
    from repro_torch.hercule.checkpoint import ShardedTensor, _leaf_paths
    return {p: leaf.full(device) if isinstance(leaf, ShardedTensor)
            else leaf.to(device or leaf.device, copy=True)
            for p, leaf in _leaf_paths(state)}


def hprot_tensors(state) -> list:
    """Every local tensor of ``state``: each shard of a sharded leaf."""
    from repro_torch.hercule.checkpoint import ShardedTensor, _leaf_paths
    out = []
    for _, leaf in _leaf_paths(state):
        out += [t for _, _, t in leaf.shards] \
            if isinstance(leaf, ShardedTensor) else [leaf]
    return out


def hprot_drift(state, k: int) -> None:
    """``benchmarks/bench_checkpoint._drift`` in place: float tensors
    ``+= k * 1e-5`` (temporally correlated, delta-friendly; most bfloat16
    weights do not move at that size), the step set to ``k``."""
    for t in hprot_tensors(state):
        if t.is_floating_point():
            t.add_(k * 1e-5)
        else:
            t.fill_(k)


def hprot_check(label: str, got, want: dict) -> int:
    """Raise unless every leaf of ``got`` has ``want``'s dtype, shape
    and bits (compared where ``want`` lives); returns the bytes
    compared."""
    got = hprot_leaves(got, next(iter(want.values())).device)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: leaves {sorted(got)}")
    for name, w in want.items():
        _same_bits(f"{label} {name}", [got[name]], [w])
    return sum(_nbytes(w) for w in want.values())


def hprot_rate(nbytes: int, seconds: float):
    """MB/s, or None where nothing was timed."""
    return nbytes / 1e6 / seconds if seconds > 0 else None


def hprot_seconds(mgr, name: str) -> float:
    """Sum of the samples of one of the manager's histograms."""
    return sum(s["value"]["sum"]
               for s in mgr.obs.snapshot()[name]["samples"])


def hprot_cut_device_ms(state) -> dict:
    """One snapshot cut's clones: their device time (``torch.profiler``,
    device-to-device copies) against their bound, every byte read once
    and written once at the memory rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ckpt import AsyncCheckpointManager
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        mgr = AsyncCheckpointManager(d, ncf=4)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cut = mgr._snapshot(state)
            torch.cuda.synchronize()
        mgr.close()
    nbytes = sum(_nbytes(e[4]) for e in cut)
    del cut
    dev = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages() if e.self_device_time_total > 0]
    return {"device_ms": sum(ms for _, ms in dev) if dev else None,
            "by_kind": dev[:4], "bytes": nbytes,
            "bound_ms": 1e3 * 2 * nbytes / MEM_BYTES_PER_S}


def hprot_async(state, root: str, device) -> tuple:
    """(b) ``AsyncCheckpointManager(ncf=4, delta_every=2)`` over four
    saves, every tensor mutated in place (``add_``) right after each
    ``save`` returns; every step restored bitwise onto 4, 2 and 8 shards
    and whole."""
    import torch

    from repro_torch.ckpt import AsyncCheckpointManager
    mgr = AsyncCheckpointManager(root, ncf=4, delta_every=2,
                                 lane_backend="thread")
    want, saves = {}, []
    state_bytes = sum(_nbytes(t) for t in hprot_tensors(state))
    for s in range(1, HPROT_SAVES + 1):
        hprot_drift(state, s)
        # the expected state and the undo copy wait on the host, so the
        # card's allocator holds only what a training loop would
        want[s] = hprot_leaves(state, torch.device("cpu"))
        shadow = [t.to("cpu", copy=True) for t in hprot_tensors(state)]
        torch.cuda.synchronize()
        tel0 = mgr.telemetry()
        g0 = hprot_seconds(mgr, "ckpt_gather_seconds")
        c0 = hprot_seconds(mgr, "ckpt_commit_seconds")
        t0 = time.perf_counter()
        mgr.save(s, state)
        stall = time.perf_counter() - t0
        for t in hprot_tensors(state):    # queued behind the cut's clones
            t.add_(1)
        t1 = time.perf_counter()
        # the next save comes after this one's host work, as in a run
        # that checkpoints every few hundred steps
        mgr.wait()
        background = time.perf_counter() - t1
        tel = mgr.telemetry()
        moved = tel["bytes_to_host"] - tel0["bytes_to_host"]
        saves.append({
            "step": s, "mode": mgr.db.view(s).attrs["mode"],
            "stall_ms": 1e3 * stall, "background_ms": 1e3 * background,
            "gather_ms": 1e3 * (hprot_seconds(mgr, "ckpt_gather_seconds")
                                - g0),
            "commit_ms": 1e3 * (hprot_seconds(mgr, "ckpt_commit_seconds")
                                - c0),
            "bytes_to_host": moved,
            "d2h_mb_per_s": hprot_rate(
                moved, tel["d2h_seconds"] - tel0["d2h_seconds"]),
            "encode_mb_per_s": hprot_rate(
                state_bytes,
                tel["encode_seconds"] - tel0["encode_seconds"])})
        for t, c in zip(hprot_tensors(state), shadow):
            t.copy_(c)                    # undo the mutation
        del shadow
    stored: dict = {}
    for sv in saves:
        recs = mgr.db.view(sv["step"]).records
        sv["stored_bytes"] = sum(r.nbytes for r in recs)
        for r in recs:
            key = f"{sv['mode']}/{r.codec}"
            stored[key] = stored.get(key, 0) + r.nbytes
    restores = []
    for s in range(1, HPROT_SAVES + 1):
        for n in HPROT_LAYOUTS:
            t0 = time.perf_counter()
            got, attrs = mgr.restore(hprot_template(n, device), step=s)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            nbytes = hprot_check(f"hprot step {s} onto {n or 'whole'}",
                                 got, want[s])
            del got
            restores.append({"step": s, "layout": n or "whole",
                             "mode": attrs["mode"], "ms": 1e3 * wall,
                             "mb_per_s": nbytes / 1e6 / wall})
    tel = mgr.telemetry()
    mgr.close()
    if tel["errors"] or tel["committed"] != HPROT_SAVES:
        raise AssertionError(f"hprot async manager: {tel}")
    modes = [sv["mode"] for sv in saves]
    if modes != ["full", "delta", "delta", "full"]:
        raise AssertionError(f"hprot save modes {modes}")
    return want, {"saves": saves, "stored_bytes_by_mode_codec": stored,
                  "restores": restores}


def hprot_process_and_sync(state, want: dict, tmp: Path, device) -> dict:
    """(b) one more save through ``lane_backend="process"``, and (c) a
    ``CheckpointManager(async_write=False)`` save of the same state, both
    restored bitwise."""
    import torch

    from repro_torch.ckpt import AsyncCheckpointManager
    from repro_torch.hercule.checkpoint import CheckpointManager
    out = {}
    mgr = AsyncCheckpointManager(str(tmp / "hprot_process"), ncf=4,
                                 lane_backend="process")
    t0 = time.perf_counter()
    mgr.save(1, state)
    out["process_stall_ms"] = 1e3 * (time.perf_counter() - t0)
    mgr.wait()
    out["process_save_ms"] = 1e3 * (time.perf_counter() - t0)
    got, _ = mgr.restore(hprot_template(HPROT_SHARDS, device), step=1)
    hprot_check("hprot process lane", got, want)
    del got
    if mgr.telemetry()["backend"]["kind"] != "process":
        raise AssertionError("hprot: no process lane ran")
    mgr.close()
    sync = CheckpointManager(str(tmp / "hprot_sync"), ncf=4,
                             async_write=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync.save(1, state)
    out["sync_save_ms"] = 1e3 * (time.perf_counter() - t0)
    got, _ = sync.restore(hprot_template(None, device), step=1)
    hprot_check("hprot sync", got, want)
    del got
    sync.close()
    return out


def hprot_orion(tree, tmp: Path, device) -> dict:
    """(d) The RAMSES restart dump: the Orion tree's arrays, held on the
    card, saved raw and restored bitwise; ``AMRTree.from_arrays`` of the
    restored arrays is the tree (phase 3 wrote its HDep catalog)."""
    import torch

    from repro_torch.ckpt import AsyncCheckpointManager
    from repro_torch.core.amr import AMRTree
    from repro_torch.insitu.device import to_device
    arrays = tree.to_arrays()
    on_card = to_device(arrays, device)
    want = hprot_leaves(on_card)
    mgr = AsyncCheckpointManager(str(tmp / "hprot_orion"), ncf=4)
    t0 = time.perf_counter()
    mgr.save(1, on_card)
    stall = time.perf_counter() - t0
    mgr.wait()
    save_ms = 1e3 * (time.perf_counter() - t0)
    codecs = {r.codec for r in mgr.db.view(1).records}
    t0 = time.perf_counter()
    got, _ = mgr.restore({k: torch.empty_like(v, device="meta")
                          for k, v in on_card.items()}, step=1)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    mgr.close()
    nbytes = hprot_check("hprot orion dump", got, want)
    back = AMRTree.from_arrays({k: v.cpu().numpy() for k, v in got.items()})
    for k, v in back.to_arrays().items():
        if v.dtype != arrays[k].dtype or v.tobytes() != arrays[k].tobytes():
            raise AssertionError(f"hprot orion dump: {k} differs")
    if codecs != {"raw"}:
        raise AssertionError(f"hprot orion dump codecs {codecs}")
    return {"bytes": nbytes, "stall_ms": 1e3 * stall, "save_ms": save_ms,
            "restore_ms": restore_ms,
            "restore_mb_per_s": nbytes / 1e3 / restore_ms}


def hprot_submit_state(state, tmp: Path, device) -> dict:
    """(e) ``InTransitEngine(device_reduce=True)`` with ``submit_state``
    on the layer's parameters through the tensor reducers, against the
    same engine on the CPU (a CPU copy of the same numbers): rtol 1e-5,
    atol 1e-6 (float32 sums in another order)."""
    import numpy as np
    import torch

    from repro_torch.insitu import (Catalog, InTransitEngine,
                                    SpectraReducer, TensorNormReducer)
    out, cats = {}, {}
    for where, dev in (("card", device), ("cpu", torch.device("cpu"))):
        root = str(tmp / f"hprot_tensors_{where}")
        eng = InTransitEngine(root, [TensorNormReducer(),
                                     SpectraReducer(k=8)],
                              device_reduce=True, device=dev,
                              policy="block").start()
        t0 = time.perf_counter()
        if not eng.submit_state(1, state):
            raise AssertionError("submit_state staged nothing")
        eng.drain(timeout=600.0)
        out[f"{where}_ms"] = 1e3 * (time.perf_counter() - t0)
        ds = eng.device_stats
        eng.close()
        if ds["fallback_snapshots"] or ds["fallback_runs"]:
            raise AssertionError(f"submit_state fell back on {dev}: {ds}")
        cat = Catalog(root)
        cats[where] = {r: cat.query(1, r) for r in cat.reducers(1)}
    ref = cats["cpu"]
    if sorted(cats["card"]) != sorted(ref):
        raise AssertionError(f"submit_state reducers {sorted(cats['card'])}")
    worst = 0.0
    for r, arrs in ref.items():
        got = cats["card"][r]
        if sorted(got) != sorted(arrs):
            raise AssertionError(f"submit_state {r}: {sorted(got)}")
        for k, v in arrs.items():
            g = got[k]
            if g.dtype != v.dtype or g.shape != v.shape:
                raise AssertionError(f"submit_state {r}/{k}: {g.dtype} "
                                     f"{g.shape} vs {v.dtype} {v.shape}")
            if v.dtype.kind == "f":
                np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-6,
                                           err_msg=f"{r}/{k}")
                worst = max(worst, float(np.max(np.abs(g - v)
                                                / (1e-6 + np.abs(v)))))
            elif not np.array_equal(g, v):
                raise AssertionError(f"submit_state {r}/{k} differs")
    out["names"] = list(ref["tnorm"]["names"])
    out["max_rel_err"] = worst
    return out


def hprot_phase(tree, tmp: Path, device, card: str) -> dict:
    """Phase 8 (see the module docstring). Each part prints as it ends,
    beside the card's name and power limit."""
    from repro_torch.obs import events as obs_events
    mark = obs_events.EVENTS.drain_since(0)[0]
    t_phase = time.perf_counter()
    state = hprot_state(device)
    from repro_torch.hercule.checkpoint import _leaf_paths
    n_params = sum(math.prod(leaf.shape)
                   for _, leaf in _leaf_paths(state["params"]))
    out = {"params": n_params, "cut": hprot_cut_device_ms(state)}
    cut = out["cut"]
    print(f"hprot state: one stablelm-1.6b layer, {n_params} parameters, "
          f"{cut['bytes']} bytes on the card in "
          f"{len(hprot_tensors(state))} tensors; cut clones: device "
          f"{cut['device_ms']!r} ms ({cut['by_kind']!r}) against a bound "
          f"of {cut['bound_ms']!r} ms (bytes); [{card}]")
    t0 = time.perf_counter()
    want, out["async"] = hprot_async(state, str(tmp / "hprot_async"),
                                     device)
    shutil.rmtree(tmp / "hprot_async")
    saves = out["async"]["saves"]
    for sv in saves:
        print(f"hprot save {sv['step']} ({sv['mode']}): stall "
              f"{sv['stall_ms']!r} ms, background {sv['background_ms']!r} "
              f"ms, gather {sv['gather_ms']!r} ms, commit "
              f"{sv['commit_ms']!r} ms, device-to-host "
              f"{sv['d2h_mb_per_s']!r} MB/s, encode "
              f"{sv['encode_mb_per_s']!r} MB/s, stored "
              f"{sv['stored_bytes']} bytes; [{card}]")
    print(f"hprot stored bytes by save mode/codec: "
          f"{out['async']['stored_bytes_by_mode_codec']!r}")
    for rs in out["async"]["restores"]:
        print(f"hprot restore step {rs['step']} ({rs['mode']}) onto "
              f"{rs['layout']}: {rs['ms']!r} ms, {rs['mb_per_s']!r} MB/s, "
              f"bitwise; [{card}]")
    print(f"hprot async: every step bitwise as it was when save was "
          f"called, in every layout ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    out.update(hprot_process_and_sync(state, want[HPROT_SAVES], tmp,
                                      device))
    del want
    stall = sum(sv["stall_ms"] for sv in saves) / len(saves)
    out["sync_over_async_stall"] = out["sync_save_ms"] / stall
    print(f"hprot sync save wall {out['sync_save_ms']!r} ms against an "
          f"async stall of {stall!r} ms a save: ratio "
          f"{out['sync_over_async_stall']!r} (the reference's CI floors "
          f"it at 2.0; not gated here); process lane save "
          f"{out['process_save_ms']!r} ms (stall "
          f"{out['process_stall_ms']!r} ms); both restored bitwise; "
          f"[{card}] ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    od = out["orion"] = hprot_orion(tree, tmp, device)
    print(f"hprot orion restart dump: {od['bytes']} bytes raw, stall "
          f"{od['stall_ms']!r} ms, save {od['save_ms']!r} ms, restore "
          f"{od['restore_ms']!r} ms ({od['restore_mb_per_s']!r} MB/s), "
          f"bitwise, AMRTree.from_arrays equal to the tree; [{card}] "
          f"({time.perf_counter() - t0:.1f} s)")
    st = out["submit_state"] = hprot_submit_state(state, tmp, device)
    print(f"hprot submit_state: {len(st['names'])} matrices through "
          f"tnorm and spectra-k8 on the card ({st['card_ms']!r} ms) and "
          f"the CPU ({st['cpu_ms']!r} ms), max rel err "
          f"{st['max_rel_err']!r} (rtol 1e-5, atol 1e-6); [{card}]")
    for d in ("hprot_process", "hprot_sync", "hprot_orion"):
        shutil.rmtree(tmp / d)
    fallbacks = [e for e in obs_events.EVENTS.drain_since(mark)[1]
                 if e["type"] == obs_events.DEVICE_FALLBACK]
    if fallbacks:
        raise AssertionError(f"hprot: device.fallback events {fallbacks}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"hprot phase 8 took {out['phase_s']!r} s, no device.fallback "
          f"event")
    return out


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


def host_us(fn, calls: int = 2000) -> float:
    """Host µs per call of ``fn``: a loop with no sync inside, then one
    sync (the card keeps up, so this is the host's own cost)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def profiled(fn, calls: int, reps: int) -> tuple:
    """``fn`` run ``reps`` times (``calls`` wrapper calls in all) under
    ``torch.profiler`` with CPU and CUDA activity: the device ms per call
    by kernel, and the host ms per call of the eight events with the most
    host time (the profiler's own cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = {e.key[:48]: e.self_device_time_total / calls / 1e3
              for e in events if e.self_device_time_total > 0}
    host = sorted(((e.key[:48], e.self_cpu_time_total / calls / 1e3)
                   for e in events if e.self_cpu_time_total > 0),
                  key=lambda kv: -kv[1])[:8]
    return device, dict(host)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _row_bytes(t) -> int:
    """Bytes of one row of ``t``."""
    return t[:1].numel() * t.element_size()


def _bound(nbytes: int, ops: int, kind: str = "f64") -> dict:
    """The least time for ``nbytes`` moved and ``ops`` operations of
    ``kind`` (f64, f32 or int32): the larger of bytes over the memory
    rate and ops over the card's peak for that type."""
    rate = {"f64": F64_OPS_PER_S, "f32": F32_OPS_PER_S,
            "int32": INT32_OPS_PER_S}[kind]
    tb, to = nbytes / MEM_BYTES_PER_S, ops / rate
    return {"bound_ms": 1e3 * max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "ops": ops, "ops_type": kind}


def plane_hits(x: dict, position: float = 0.5):
    """The rows of ``x`` whose level-``l`` cell holds the slice plane,
    tested in the values' dtype as B4 and its twin test it."""
    import torch

    from repro_torch.kernels import ref
    dt, L = x["values"].dtype, x["n_levels"]
    size = ref.level_scale(L, x["levels"].device).to(dt)[
        x["levels"].to(torch.int64).clamp(0, L - 1)]
    lo = x["c_axis"].to(dt) * size
    pos = torch.tensor(position, dtype=dt, device=lo.device)
    return (lo <= pos) & (pos < lo + size)


def raster_work(x: dict, resolution: int) -> dict:
    """Bytes and operations (in the values' float type) the slice and the
    projection must spend on ``x``'s table, each (R, R) output in the
    values' dtype written once. Every row's ``ok`` (and, for the slice,
    its plane test) must be read; the other columns only for the rows
    this data selects: the valid leaves, or the valid leaves the slice
    plane hits."""
    import torch

    from repro_torch.kernels import raster
    L = x["n_levels"]
    img = resolution * resolution * x["values"].element_size()
    valid = x["ok"] & (x["levels"] >= 0) & (x["levels"] < L)
    _, _, px = raster.leaf_table(x["coords2"], x["levels"],
                                 resolution=resolution)
    hit = plane_hits(x) & valid
    n_rows, n_valid, n_hit = x["ok"].numel(), int(valid.sum()), int(hit.sum())
    leaf_row = sum(_row_bytes(x[k]) for k in ("coords2", "levels", "values"))
    return {
        # slice: c_axis, levels and ok of every row for the plane test (a
        # multiply and an add per row), then coords2 and values of the
        # leaves the plane hits
        "slice": (n_rows * sum(_row_bytes(x[k]) for k in
                               ("c_axis", "levels", "ok"))
                  + n_hit * (_row_bytes(x["coords2"])
                             + _row_bytes(x["values"])) + img,
                  2 * n_rows, n_hit),
        # projection: one multiply and one add per (leaf, covered pixel)
        "projection": (_nbytes(x["ok"]) + n_valid * leaf_row + img,
                       2 * int((px.to(torch.int64) ** 2)[valid].sum()),
                       n_valid),
    }


def bounds(x: dict, edges, n_hist: int, resolution: int) -> dict:
    """Least time for B1-B3's work on these inputs (see
    :func:`raster_work`); the histogram reads ``ok`` and the edges, the
    values and levels of the valid leaves, and does one f64 compare per
    binary-search step per valid row."""
    w = raster_work(x, resolution)
    out = {"slice_raster": _bound(*w["slice"][:2]),
           "projection_raster": _bound(*w["projection"][:2]),
           "level_hist": hist_bound(x, edges, n_hist)}
    out["slice_raster"]["plane_hits"] = w["slice"][2]
    out["projection_raster"]["valid_rows"] = w["projection"][2]
    return out


def hist_bound(x: dict, edges, n_hist: int) -> dict:
    """Least time of B3 (or B3-f32) on ``x``'s table: ``ok`` and the edges
    read, the values and levels of the valid leaves, the (L, B) counts
    written; one f64 compare per binary-search step per valid row (a
    float32 value is compared widened)."""
    L = x["n_levels"]
    n_valid = int((x["ok"] & (x["levels"] >= 0) & (x["levels"] < L)).sum())
    return _bound(_nbytes(x["ok"], edges)
                  + n_valid * (_row_bytes(x["values"])
                               + _row_bytes(x["levels"]))
                  + n_hist * (edges.numel() - 1) * 4,
                  n_valid * (3 + math.ceil(math.log2(edges.numel()))))


def carry_bounds(tiles: list, resolution: int) -> dict:
    """Least time of one B4/B5 call (float64 or, for float32 tiles,
    B4-f32/B5-f32), the mean over the main path's tiles: each tile's
    :func:`raster_work` plus its seed, read once — B4's (image, depth)
    seed and outputs are (2v + 8)·R² bytes, B5's 2v·R², for v-byte
    values."""
    px2 = resolution * resolution
    vb = tiles[0]["values"].element_size()
    fx, kind = ("", "f64") if vb == 8 else ("_f32", "f32")
    sums = {"slice_raster_carry" + fx: [0, 0],
            "projection_raster_carry" + fx: [0, 0]}
    for x in tiles:
        w = raster_work(x, resolution)
        for name, work, seed in (("slice_raster_carry", "slice",
                                  (vb + 8) * px2),
                                 ("projection_raster_carry", "projection",
                                  vb * px2)):
            sums[name + fx][0] += w[work][0] + seed
            sums[name + fx][1] += w[work][1]
    return {name: dict(_bound(nb // len(tiles), ops // len(tiles), kind),
                       tiles=len(tiles))
            for name, (nb, ops) in sums.items()}


def time_kernels(x: dict, edges, n_hist: int, resolution: int) -> dict:
    from repro_torch.kernels import raster, ref
    geo = dict(resolution=resolution, n_levels=x["n_levels"])
    e_cpu = edges.cpu()         # B3 takes the reducers' CPU edges by value
    calls = {
        "slice_raster": lambda f: f(x["coords2"], x["c_axis"], x["levels"],
                                    x["values"], x["ok"], position=0.5,
                                    **geo),
        "projection_raster": lambda f: f(x["coords2"], x["levels"],
                                         x["values"], x["ok"], **geo),
        "level_hist": lambda f: f(x["values"], x["levels"], x["ok"],
                                  e_cpu if f is raster.level_hist else edges,
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
    b1 = out["slice_raster"]
    b1.update(wrapper_calls(lambda: calls["slice_raster"](raster.slice_raster),
                            1, reps=50))
    memsets = [k for k in b1["device_split_ms"] if "emset" in k]
    if memsets:
        raise AssertionError(f"slice_raster launched {memsets} on the kept "
                             f"scratch")
    b1["host_steps_us"] = slice_steps(x)
    out["level_hist"].update(hist_calls(x["values"], x["levels"], x["ok"],
                                        edges, n_hist))
    return out


def time_carries(arrays: dict, device, dtype=None) -> tuple:
    """B4/B5 per tile call at the mesh path's shapes (``dtype="float32"``:
    B4-f32/B5-f32 on the float32 table): the one-shard Orion table's tile
    chain timed whole (wrapper, then plain twin) over its tile count, and
    the bound as the mean over the same tiles."""
    from repro_torch.insitu.mesh_reduce import MESH_TILE, MeshTable
    from repro_torch.kernels import ops
    mt = MeshTable(arrays, 1, [device], dtype=dtype)
    fx = "_f32" if dtype else ""
    coords, levels, values, ok = next(mt.shards("density"))
    x = {"coords": coords, "levels": levels, "values": values, "ok": ok,
         "n_levels": mt.n_levels}
    tiles = [{"coords2": ops.plane_coords(coords[a:a + MESH_TILE], 2),
              "c_axis": coords[a:a + MESH_TILE, 2],
              "levels": levels[a:a + MESH_TILE],
              "values": values[a:a + MESH_TILE], "ok": ok[a:a + MESH_TILE],
              "n_levels": mt.n_levels}
             for a in range(0, values.shape[0], MESH_TILE)]
    geo = dict(resolution=LIVE_RESOLUTION, tile_n=MESH_TILE)
    out = {}
    for kind, name in (("slice", "slice_raster_carry" + fx),
                       ("projection", "projection_raster_carry" + fx)):
        chain = time_ms(lambda: carry_chain(x, kind, None, **geo), reps=5)
        plain = time_ms(lambda: carry_chain(x, kind, "ref", **geo), reps=1,
                        warm=1)
        out[name] = {"ms": chain / len(tiles), "plain_ms": plain / len(tiles),
                     "chain_ms": chain, "plain_chain_ms": plain}
    out["slice_raster_carry" + fx].update(slice_carry_calls(tiles, device))
    out["projection_raster_carry" + fx].update(
        projection_calls(tiles, device, carry=True))
    return out, carry_bounds(tiles, LIVE_RESOLUTION)


def time_hist_f32(arrays: dict, device) -> tuple:
    """B3-f32 at the float32 mesh path's shapes: the one-shard Orion
    table's float32 values, levels and ``ok`` (569,344 padded rows) and
    the live DAG's 64 edges (on the CPU, as the reducers pass them); the
    wrapper (:func:`hist_calls`), its plain twin (edges on the card), and
    the bound."""
    import numpy as np
    import torch

    from repro_torch.insitu import LevelHistogramReducer
    from repro_torch.insitu.mesh_reduce import MeshTable
    from repro_torch.kernels import raster, ref
    mt = MeshTable(arrays, 1, [device], dtype="float32")
    _, levels, values, ok = next(mt.shards("density"))
    r = next(r for r in live_reducers()
             if isinstance(r, LevelHistogramReducer))
    edges = torch.from_numpy(np.linspace(r.lo, r.hi, r.bins + 1)).to(device)
    n_hist = min(mt.n_levels, r.max_levels)
    e_cpu = edges.cpu()
    out = {"ms": time_ms(lambda: raster.level_hist(
               values, levels, ok, e_cpu, n_levels=n_hist), reps=20),
           "plain_ms": time_ms(lambda: ref.level_hist_ref(
               values, levels, ok, edges, n_levels=n_hist), reps=3, warm=1),
           **hist_calls(values, levels, ok, edges, n_hist)}
    x = {"values": values, "levels": levels, "ok": ok,
         "n_levels": mt.n_levels}
    return out, hist_bound(x, edges, n_hist)


def hist_calls(values, levels, ok, edges, n_hist: int,
               reps: int = 50) -> dict:
    """B3's (or B3-f32's) wrapper alone with the main path's CPU edges
    (:func:`wrapper_calls`), which must launch its one kernel and no
    memset or copy; its host steps (:func:`hist_steps`); and the call
    with the edges on the card (CUDA events)."""
    from repro_torch.kernels import raster
    e_cpu = edges.cpu()

    def call(e=e_cpu):
        return raster.level_hist(values, levels, ok, e, n_levels=n_hist)

    out = wrapper_calls(call, 1, reps)
    if len(out["device_split_ms"]) != 1 or \
            "level_hist_kernel" not in next(iter(out["device_split_ms"])):
        raise AssertionError(f"level_hist launched {out['device_split_ms']}"
                             f", expected its one kernel and no memset")
    out["host_steps_us"] = hist_steps(values, levels, ok, e_cpu, n_hist)
    out["device_edges_ms"] = time_ms(lambda: call(edges), reps=reps)
    out["torch.histogram on the card"] = torch_histogram_on_cuda(values,
                                                                 edges)
    return out


def torch_histogram_on_cuda(values, edges) -> str:
    """Whether ``torch.histogram`` (one bin rule, no levels) runs on CUDA
    tensors at all: "runs", or the error it raises. Only probed here; the
    port never calls it."""
    import torch
    try:
        torch.histogram(values, bins=edges.to(values))
    except (RuntimeError, NotImplementedError) as exc:
        return f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
    return "runs"


def hist_steps(values, levels, ok, edges, n_hist: int) -> dict:
    """Host µs per call of each step of B3's wrapper (B3-f32's for float32
    values), alone, with CPU ``edges``: the device and dtype checks, the
    edges by value, taking and leaving the kept output, the one output
    allocation, the ctypes call with its launch, and the whole wrapper; and
    the torch ops one call records (``torch.profiler``, CPU activity),
    which must be the output's ``aten::empty`` alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cudalib, raster
    dev = values.device
    i = cudalib.device_index(values, levels, ok)
    bins = edges.numel() - 1
    key = (i, cudalib.current_stream(i), n_hist, bins)

    def keep():
        raster._HIST_NEXT[key] = raster._HIST_NEXT.pop(key, None)

    hist, nxt = (torch.zeros((n_hist, bins), dtype=torch.int32, device=dev)
                 for _ in range(2))
    cudalib.lib()
    entry = cudalib._FNS["raster_level_hist"
                         + raster._suffix("level_hist", values)]
    args = (values.data_ptr(), levels.data_ptr(), ok.data_ptr(),
            edges.data_ptr(), 1, values.shape[0], n_hist, bins,
            hist.data_ptr(), nxt.data_ptr())
    stream = cudalib.current_stream(i)

    def wrapper():
        return raster.level_hist(values, levels, ok, edges, n_levels=n_hist)

    wrapper()                       # the kept output exists from here on
    steps = {
        "checks": lambda: (cudalib.device_index(values, levels, ok),
                           raster._suffix("level_hist", values)),
        "edges by value": lambda: raster._hist_edges(i, edges, dev),
        "kept output": keep,
        "one allocation": lambda: torch.empty((n_hist, bins),
                                              dtype=torch.int32, device=dev),
        "ctypes call and launch": lambda: entry(*args, i, stream),
        "whole wrapper": wrapper,
    }
    out = {name: host_us(fn, 500) for name, fn in steps.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wrapper()
    ops_seen = {e.key: e.count for e in prof.key_averages()
                if e.key.startswith("aten::")}
    if ops_seen != {"aten::empty": 1}:
        raise AssertionError(f"level_hist's call ran torch ops {ops_seen}, "
                             f"expected only its output's aten::empty")
    out["torch ops a call"] = ops_seen
    return out


def sync_ms(fn, calls: int = 200) -> float:
    """Host ms per call of ``fn`` followed by a device synchronize."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def host_to_device_copies(fn) -> list:
    """The host-to-device copies one call of ``fn`` makes
    (``torch.profiler``, CUDA activity): [(event, count)]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages() if "HtoD" in e.key]


def time_hist_reducer(arrays: dict, on_card: dict, device) -> dict:
    """The histogram reducers on Orion. The device path's (``insitu.device``
    impl) on the snapshot on the card: its whole ``run`` with the live
    DAG's fixed bounds and with auto bounds, split into the bounds pull,
    the edges (``np.linspace``, ``torch.from_numpy``) and B3
    (``ops.raster_level_hist``, its int64 cast included), beside B3 with
    the edges uploaded first (the earlier route); host ms a call, each
    followed by a synchronize. Then the host-to-device copies of one run:
    none with fixed bounds (asserted), and of the mesh reducer's run at
    ``MESH_SHARDS`` shards on the one card (none, asserted); the auto
    bounds' own copies are counted."""
    import numpy as np
    import torch

    from repro_torch.insitu import LevelHistogramReducer
    from repro_torch.insitu.device import DeviceTree, device_impl_for
    from repro_torch.insitu.mesh_reduce import MeshTable, mesh_impl_for
    from repro_torch.kernels import ops
    fixed = next(r for r in live_reducers()
                 if isinstance(r, LevelHistogramReducer))
    auto = LevelHistogramReducer(field="density", bins=fixed.bins)
    dt = DeviceTree(on_card, 1)
    v, lv, okk = dt.field("density"), dt.levels, dt.ok
    n_hist = min(dt.n_levels, fixed.max_levels)
    run_fixed, run_auto = device_impl_for(fixed), device_impl_for(auto)

    def bounds():
        inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
        return torch.stack([torch.where(okk, v, inf).min(),
                            torch.where(okk, v, -inf).max()]).cpu()

    def edges():
        return torch.from_numpy(np.linspace(fixed.lo, fixed.hi,
                                            fixed.bins + 1))

    e = edges()
    parts = {
        "run (fixed bounds)": lambda: run_fixed(dt),
        "run (auto bounds)": lambda: run_auto(dt),
        "bounds pull": bounds,
        "edges": edges,
        "B3": lambda: ops.raster_level_hist(v, lv, okk, e, n_levels=n_hist),
        "B3 with the edges uploaded": lambda: ops.raster_level_hist(
            v, lv, okk, e.to(device), n_levels=n_hist),
    }
    out = {"ms": {name: sync_ms(fn) for name, fn in parts.items()}}
    out["htod_fixed"] = host_to_device_copies(lambda: run_fixed(dt))
    out["htod_auto"] = host_to_device_copies(lambda: run_auto(dt))
    mt = MeshTable(arrays, 1, [device] * MESH_SHARDS)
    run_mesh = mesh_impl_for(fixed)
    run_mesh(mt)                               # uploads the shards' fields
    out["htod_mesh"] = host_to_device_copies(lambda: run_mesh(mt))
    if out["htod_fixed"] or out["htod_mesh"]:
        raise AssertionError(f"a histogram reducer copied host to device: "
                             f"device path {out['htod_fixed']}, mesh "
                             f"{out['htod_mesh']}")
    print(f"time histogram reducer on Orion, host ms a call (synchronized):"
          f" {out['ms']!r}; host-to-device copies a run: fixed bounds "
          f"{out['htod_fixed']!r}, auto bounds {out['htod_auto']!r}, mesh "
          f"S={MESH_SHARDS} {out['htod_mesh']!r}")
    return out


def wrapper_calls(chain, n_calls: int, reps: int = 20) -> dict:
    """A kernel's wrapper alone, ``chain`` making ``n_calls`` calls of it
    (chained carries over pre-cut tiles, no ``_run_tiles`` slicing): ms
    per call with CUDA events, the host's own ms per call (a loop with no
    sync, then one sync), and the device ms per call by kernel and the
    host account from ``torch.profiler``."""
    wrapper_ms = time_ms(chain, reps=reps) / n_calls
    host_ms = host_us(chain, reps) / 1e3 / n_calls
    split, host_split = profiled(chain, reps * n_calls, reps)
    return {"wrapper_ms": wrapper_ms, "host_ms": host_ms,
            "device_ms": sum(split.values()) if split else None,
            "device_split_ms": split, "profiled_host_ms": host_split}


def slice_carry_calls(tiles: list, device, reps: int = 20) -> dict:
    """B4's wrapper alone over the pre-cut tiles (:func:`wrapper_calls`;
    device split: paint, resolve) and its host steps."""
    import torch

    from repro_torch.kernels import raster
    r = LIVE_RESOLUTION
    seed = (torch.full((r, r), float("nan"), dtype=tiles[0]["values"].dtype,
                       device=device),
            torch.full((r, r), -1, dtype=torch.int32, device=device))

    def chain():
        carry = seed
        for t in tiles:
            carry = raster.slice_raster_carry(
                t["coords2"], t["c_axis"], t["levels"], t["values"], t["ok"],
                position=0.5, resolution=r, n_levels=t["n_levels"],
                init=carry)
        return carry

    return {**wrapper_calls(chain, len(tiles), reps),
            "host_steps_us": slice_carry_steps(tiles[0], seed)}


def projection_calls(tiles: list, device, *, carry: bool,
                     reps: int = 20) -> dict:
    """B5's wrapper alone over the pre-cut tiles (``carry``), or B2's on
    the one table in ``tiles`` (:func:`wrapper_calls`; device split: key
    and count, scan, place, order, projection), its host steps, and the
    longest (level, cell) segment of the tables."""
    import torch

    from repro_torch.kernels import raster
    r = LIVE_RESOLUTION
    seed = torch.zeros((r, r), dtype=tiles[0]["values"].dtype, device=device)

    def cols(t):
        return t["coords2"], t["levels"], t["values"], t["ok"]

    def chain():
        img = seed
        for t in tiles:
            img = raster.projection_raster_carry(
                *cols(t), resolution=r, n_levels=t["n_levels"], init=img) \
                if carry else raster.projection_raster(
                    *cols(t), resolution=r, n_levels=t["n_levels"])
        return img

    return {**wrapper_calls(chain, len(tiles), reps),
            "host_steps_us": projection_steps(tiles[0],
                                              seed if carry else None),
            "longest_segment": max(longest_segment(
                t["coords2"], t["levels"], t["ok"], resolution=r,
                n_levels=t["n_levels"]) for t in tiles)}


def projection_steps(t: dict, seed) -> dict:
    """Host µs per call of each step of B5's wrapper (``seed`` the carry)
    or B2's (``seed`` None), alone, on one table: the device and seed
    checks, the casts (none: the columns come in their dtypes), the
    scratch lookup, the one output allocation, the ctypes call with its
    five launches, and the whole wrapper."""
    import torch

    from repro_torch.kernels import cudalib, raster
    r, L = LIVE_RESOLUTION, t["n_levels"]
    cols = (t["coords2"], t["levels"], t["values"], t["ok"])
    seeds = () if seed is None else (seed,)
    dev, vd = t["values"].device, t["values"].dtype
    n = t["values"].shape[0]
    i = cudalib.device_index(*cols, *seeds)
    _, (zeros, offsets, rows) = raster._projection_scratch(dev, r, L, n)
    img = torch.empty((r, r), dtype=vd, device=dev)
    args = (*(c.data_ptr() for c in cols[:2]), cols[3].data_ptr(),
            cols[2].data_ptr(), n, r, L, zeros.data_ptr(),
            offsets.data_ptr(), rows.data_ptr(),
            *(s.data_ptr() for s in seeds), img.data_ptr())
    cudalib.lib()
    entry = cudalib._FNS["raster_projection_carry" + raster._SUFFIX[vd]
                         if seeds else "raster_projection_f64"]
    stream = cudalib.current_stream(i)
    wrapper = (lambda: raster.projection_raster_carry(
        *cols, resolution=r, n_levels=L, init=seed)) if seeds else \
        (lambda: raster.projection_raster(*cols, resolution=r, n_levels=L))
    steps = {
        "checks": lambda: (cudalib.device_index(*cols, *seeds),
                           seeds and raster._seed(seeds, r, (vd,))),
        "casts": lambda: (raster._as(cols[0], torch.int32),
                          raster._as(cols[1], torch.int32),
                          raster._as(cols[2], vd),
                          cudalib.dense(cols[3])),
        "scratch lookup": lambda: raster._projection_scratch(dev, r, L, n),
        "one allocation": lambda: torch.empty((r, r), dtype=vd, device=dev),
        "ctypes call and five launches": lambda: entry(*args, i, stream),
        "whole wrapper": wrapper,
    }
    return {name: host_us(fn, 500) for name, fn in steps.items()}


def slice_carry_steps(t: dict, seed) -> dict:
    """Host µs per call of each step of B4's wrapper, alone, on one tile:
    the device and seed checks, one output allocation (it makes two),
    the ctypes call with its two launches, the whole wrapper, and
    ``_run_tiles``' cut of one tile's five columns."""
    import torch

    from repro_torch.kernels import cudalib, raster
    r = LIVE_RESOLUTION
    cols = (t["coords2"], t["c_axis"], t["levels"], t["values"], t["ok"])
    i = cudalib.device_index(*cols, *seed)
    _, keys = raster._slice_keys(i, t["values"].device, r)
    img, depth = torch.empty_like(seed[0]), torch.empty_like(seed[1])
    args = (cols[0].data_ptr(), cols[1].data_ptr(), cols[1].stride(0),
            cols[2].data_ptr(), cols[4].data_ptr(), cols[3].data_ptr(),
            cols[3].shape[0], r, t["n_levels"], 0.5, keys.data_ptr(),
            seed[0].data_ptr(), seed[1].data_ptr(), img.data_ptr(),
            depth.data_ptr())
    cudalib.lib()
    vd = t["values"].dtype
    entry = cudalib._FNS["raster_slice_carry" + raster._SUFFIX[vd]]
    stream = cudalib.current_stream(i)
    whole = torch.cat(cols[3:4] * 35)
    steps = {
        "checks": lambda: (cudalib.device_index(*cols, *seed),
                           raster._seed(seed, r, (vd, torch.int32))),
        "one allocation": lambda: torch.empty_like(seed[0]),
        "ctypes call and launches": lambda: entry(*args, i, stream),
        "whole wrapper": lambda: raster.slice_raster_carry(
            *cols, position=0.5, resolution=r, n_levels=t["n_levels"],
            init=seed),
        "tile cut (5 slices)": lambda: [whole[:16384] for _ in range(5)],
    }
    return {name: host_us(fn, 500) for name, fn in steps.items()}


def slice_steps(x: dict) -> dict:
    """Host µs per call of each step of B1's wrapper, alone, on the Orion
    table: the device and column checks, the key scratch lookup, the one
    output allocation, the ctypes call with its two launches, and the
    whole wrapper; and the torch ops one call records
    (``torch.profiler``, CPU activity), which must be the output's
    ``aten::empty`` alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cudalib, raster
    r, L = LIVE_RESOLUTION, x["n_levels"]
    cols = (x["coords2"], x["c_axis"], x["levels"], x["values"], x["ok"])
    dev = x["values"].device
    i = cudalib.device_index(*cols)
    _, keys = raster._slice_keys(i, dev, r)
    img = torch.empty((r, r), dtype=torch.float64, device=dev)
    args = (cols[0].data_ptr(), cols[1].data_ptr(), cols[1].stride(0),
            cols[2].data_ptr(), cols[4].data_ptr(), cols[3].data_ptr(),
            cols[3].shape[0], r, L, 0.5, keys.data_ptr(), img.data_ptr())
    cudalib.lib()
    entry = cudalib._FNS["raster_slice_f64"]
    stream = cudalib.current_stream(i)

    def wrapper():
        return raster.slice_raster(*cols, position=0.5, resolution=r,
                                   n_levels=L)

    steps = {
        "checks": lambda: (cudalib.device_index(*cols),
                           raster._suffix("slice_raster", cols[3],
                                          {torch.float64: "_f64"}),
                           raster._slice_columns("slice_raster", *cols)),
        "scratch lookup": lambda: raster._slice_keys(i, dev, r),
        "one allocation": lambda: torch.empty((r, r), dtype=torch.float64,
                                              device=dev),
        "ctypes call and launches": lambda: entry(*args, i, stream),
        "whole wrapper": wrapper,
    }
    out = {name: host_us(fn, 500) for name, fn in steps.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wrapper()
    ops_seen = {e.key: e.count for e in prof.key_averages()
                if e.key.startswith("aten::")}
    if ops_seen != {"aten::empty": 1}:
        raise AssertionError(f"slice_raster's call ran torch ops {ops_seen}"
                             f", expected only its output's aten::empty")
    out["torch ops a call"] = ops_seen
    return out


def encode_steps(words) -> dict:
    """Host µs per call of each step of B6's wrapper, alone, at the Orion
    codec shapes: the checks, the one output buffer, its three views, the
    ctypes call with its launch, and the whole wrapper; and the torch ops
    one call records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import codec, cudalib
    s, g = words[0].shape
    i = words[0].get_device()
    block = codec.encode_block(*words, 4, 64)
    ptrs = [t.data_ptr() for t in words]
    out_ptr = block.data_ptr()
    entry = cudalib._FNS["codec_encode_groups"]
    stream = cudalib.current_stream(i)
    steps = {
        "checks": lambda: (codec._same_words(*words),
                           cudalib.device_index(*words),
                           [cudalib.dense(t) for t in words]),
        "one buffer": lambda: torch.empty(2 * s * g + g, dtype=torch.int32,
                                          device=words[0].device),
        "its three views": lambda: codec.block_views(block, s, g, 64),
        "ctypes call and launch": lambda: entry(*ptrs, s, g, 64, 15,
                                                out_ptr, i, stream),
        "whole wrapper": lambda: codec.encode_groups(*words, 4, 64),
    }
    out = {name: host_us(fn) for name, fn in steps.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        codec.encode_groups(*words, 4, 64)
    out["torch ops a call"] = {e.key: e.count for e in prof.key_averages()
                               if e.key.startswith("aten::")}
    return out


def codec_bounds(words, res, nlz, flags, packed) -> dict:
    """Least time of B6-B9 on the timed inputs: each input read once and
    each output written once, against their int32 operations — B6 two
    XORs and two ORs per son word pair plus a clz, a select and a clamp
    per group; B7 two XORs; B8 a compare per flag and a ballot per word;
    B9 a shift and a mask per flag."""
    n_sg, g = res.numel(), nlz.numel()
    n, w = flags.numel(), packed.numel()
    return {"encode_groups": _bound(_nbytes(*words) + 2 * _nbytes(res)
                                    + _nbytes(nlz), 4 * n_sg + 3 * g,
                                    "int32"),
            "decode_groups": _bound(_nbytes(*words) + 2 * _nbytes(res),
                                    2 * n_sg, "int32"),
            "bitpack": _bound(_nbytes(flags, packed), n + w, "int32"),
            "bitunpack": _bound(_nbytes(packed) + n, 2 * n, "int32")}


def time_codec(tree, device) -> tuple:
    """B6-B9 at the Orion codec path's shapes (the density groups at
    width 64, the ``refine`` flags): the wrapper, its plain twin and, for
    B7, one ``torch.bitwise_xor`` over both halves stacked (the library
    yardstick); the kernels' device time from ``torch.profiler`` (None
    where it records none); then the bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import codec, ref
    words = field_words(tree, "density", device)
    # B7 on contiguous residues, copied once here: B6 gives strided views
    res_hi, res_lo, nlz = (t.contiguous() for t in
                           codec.encode_groups(*words, 4, 64))
    flags = torch.from_numpy(tree.refine).to(device)
    packed = codec.bitpack(flags)
    n = flags.shape[0]
    res2, pred2 = torch.stack([res_hi, res_lo]), torch.stack(words[:2])
    calls = {
        "encode_groups": (lambda: codec.encode_groups(*words, 4, 64),
                          lambda: ref.group_residues_ref(*words, 4, 64),
                          None),
        "decode_groups": (lambda: codec.decode_groups(res_hi, res_lo,
                                                      *words[:2]),
                          lambda: ref.decode_residues_ref(res_hi, res_lo,
                                                          *words[:2]),
                          lambda: torch.bitwise_xor(res2, pred2)),
        "bitpack": (lambda: codec.bitpack(flags),
                    lambda: ref.bitpack_ref(flags), None),
        "bitunpack": (lambda: codec.bitunpack(packed, n),
                      lambda: ref.bitunpack_ref(packed, n), None),
    }
    out = {name: {"ms": time_ms(kern, reps=200),
                  "plain_ms": time_ms(plain, reps=20),
                  "library_ms": time_ms(lib, reps=200) if lib else None}
           for name, (kern, plain, lib) in calls.items()}
    for name in ("encode_groups", "decode_groups"):
        out[name]["host_ms"] = host_us(calls[name][0]) / 1e3
    # the kernels' own device time, apart from the wrappers' host work
    reps = 50
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for kern, _, _ in calls.values():
                kern()
        torch.cuda.synchronize()
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()}
    for name in calls:
        us = [t for k, t in device_us.items() if f"::{name}_kernel" in k]
        out[name]["device_ms"] = sum(us) / reps / 1e3 if us else None
    out["decode_groups"]["host_steps_us"] = decode_steps(
        (res_hi, res_lo, *words[:2]))
    out["encode_groups"]["host_steps_us"] = encode_steps(words)
    return out, codec_bounds(words, res_hi, nlz, flags, packed)


def decode_steps(ins) -> dict:
    """Host µs per call of each step of B7's wrapper, alone: the checks,
    the one ``(2, S, G)`` output and its halves as views (against two
    separate outputs), the stream handle, the ctypes call with its
    launch, and the whole wrapper."""
    import torch

    from repro_torch.kernels import codec, cudalib
    son = ins[0].new_empty(2, *ins[0].shape)
    n, i = ins[0].numel(), ins[0].get_device()
    ptrs = [t.data_ptr() for t in ins]
    son_ptr = son.data_ptr()
    entry = cudalib._FNS["codec_decode_groups"]
    stream = cudalib.current_stream(i)
    steps = {
        "checks": lambda: (codec._same_words(*ins),
                           cudalib.device_index(*ins),
                           [cudalib.dense(t) for t in ins]),
        "one (2, S, G) output": lambda: ins[0].new_empty(2, *ins[0].shape),
        "its halves as views": lambda: (son[0], son[1]),
        "two (S, G) outputs": lambda: (torch.empty_like(ins[0]),
                                       torch.empty_like(ins[1])),
        "stream handle": lambda: cudalib.current_stream(i),
        "ctypes call and launch": lambda: entry(*ptrs, n, son_ptr,
                                                son_ptr + 4 * n, i, stream),
        "whole wrapper": lambda: codec.decode_groups(*ins),
    }
    out = {name: host_us(fn) for name, fn in steps.items()}
    out["profiled host ms a call"] = profiled(
        lambda: codec.decode_groups(*ins), 200, 200)[1]
    return out


def time_stream_handles(device) -> dict:
    """Host µs per call of the current stream's raw handle: the public
    ``torch.cuda.current_stream(i).cuda_stream`` against
    ``cudalib.current_stream`` (``torch._C._cuda_getCurrentRawStream``),
    which the wrappers' launches use."""
    import torch

    from repro_torch.kernels import cudalib
    i = device.index
    out = {"torch.cuda.current_stream(i).cuda_stream": host_us(
               lambda: torch.cuda.current_stream(i).cuda_stream, 20000),
           "cudalib.current_stream(i)": host_us(
               lambda: cudalib.current_stream(i), 20000)}
    print(f"time stream handle, host us per call: {out!r}")
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

    from repro_torch.kernels import cudalib
    t0 = time.perf_counter()
    so = cudalib.build()
    cudalib.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {so}")

    from repro_torch.insitu import partition_snapshot
    # -- 2. parity: small, owner-masked partitions, full size
    for seed in (0, 7):
        tree = random_sedov_tree(seed)
        for res in (16, 64):
            label = f"sedov seed={seed} R={res}"
            _, sx, s_edges, s_hist = check_parity(
                label, tree.to_arrays(), device, resolution=res, bins=32,
                lo=None, hi=None)
            check_parity_f32(label, sx, s_edges, s_hist, resolution=res,
                             tile_n=512)
        check_codec_parity(f"sedov seed={seed}", tree, device)
        for f32 in (False, True):
            check_carry_boundaries(f"sedov seed={seed}", tree.to_arrays(),
                                   device, f32=f32)
    parts = partition_snapshot(random_sedov_tree(3).to_arrays(), "amr", 3)
    for g, part in enumerate(parts):
        label = f"owner-masked part {g}/3"
        _, px, p_edges, p_hist = check_parity(
            label, part, device, resolution=32, bins=16, lo=-8.0, hi=8.0,
            n_domains=3, domain=g)
        check_parity_f32(label, px, p_edges, p_hist, resolution=32,
                         tile_n=512)
    table_segment = check_projection_tables(device)
    check_projection_tables(device, f32=True)
    check_level26(device)
    hist_err = check_hist_cases(device)
    coarse_err = check_coarse_tables(device)
    t0 = time.perf_counter()
    tree = orion_tree()
    print(f"orion tree: {tree.n_nodes} nodes, {tree.n_levels} levels, "
          f"{int((~tree.refine).sum())} leaves, "
          f"{sum(v.nbytes for v in tree.to_arrays().values())} bytes "
          f"({time.perf_counter() - t0:.1f} s to generate)")
    from repro_torch.insitu.mesh_reduce import MESH_TILE
    errs, x, edges, n_hist = check_parity(
        "orion full size", tree.to_arrays(), device,
        resolution=LIVE_RESOLUTION, bins=64, lo=0.0, hi=50.0,
        tile_n=MESH_TILE)
    errs.update(check_parity_f32("orion full size", x, edges, n_hist,
                                 resolution=LIVE_RESOLUTION,
                                 tile_n=MESH_TILE))
    errs.update(check_codec_parity("orion full size", tree, device))
    errs["slice_raster"] = max(errs["slice_raster"], coarse_err)
    for name in ("level_hist", "level_hist_f32"):
        errs[name] = max(errs[name], hist_err)

    # -- 3. main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=ROOT / "build") as d:
        tmp = Path(d)
        launches, wall, on_card = main_path_orion(tree, tmp, device)
        main_path_cli_dag(tmp, device)
        wall["breakdown"] = step_breakdown(
            on_card, str(tmp / "orion_prof"), "device_reduce",
            device_reduce=True, device=device)
        wall["hist_reducer"] = time_hist_reducer(tree.to_arrays(), on_card,
                                                 device)
        del on_card
        # -- 4. mesh path
        mesh_launches, wall["mesh"] = main_path_mesh(
            tree, tmp, device, str(tmp / "orion_host"))
        main_path_mesh_cli(tmp, device)
        # -- 7. serving and ledger, over the Orion catalog of phase 3
        wall["serving"] = serving_and_ledger(tree, tmp, device)
        # -- 8. HProt on the card
        wall["hprot"] = hprot_phase(tree, tmp, device, card)
        shutil.rmtree(tmp, ignore_errors=True)
    # -- 4b. the mesh path's float32 tables
    wall["mesh_f32"] = main_path_mesh_f32(tree, device, wall["mesh"])
    # -- 5. codec path
    wall["codec"] = codec_path_orion(tree, device)
    print(f"time walls per Orion step: device_reduce "
          f"{wall['wall_ms_per_step']!r} ms, mesh S=1 "
          f"{wall['mesh'][1]['wall_ms_per_step']!r} ms, mesh "
          f"S={MESH_SHARDS} {wall['mesh'][MESH_SHARDS]['wall_ms_per_step']!r}"
          f" ms")

    # -- 6. times at the full size
    times = time_kernels(x, edges, n_hist, LIVE_RESOLUTION)
    bnd = bounds(x, edges, n_hist, LIVE_RESOLUTION)
    carry_times, carry_bnd = time_carries(tree.to_arrays(), device)
    times.update(carry_times)
    bnd.update(carry_bnd)
    carry_times, carry_bnd = time_carries(tree.to_arrays(), device,
                                          "float32")
    times.update(carry_times)
    bnd.update(carry_bnd)
    times["level_hist_f32"], bnd["level_hist_f32"] = time_hist_f32(
        tree.to_arrays(), device)
    times["projection_raster"].update(
        projection_calls([x], device, carry=False, reps=50))
    codec_times, codec_bnd = time_codec(tree, device)
    times.update(codec_times)
    bnd.update(codec_bnd)
    wall["stream_handle_us"] = time_stream_handles(device)
    b1, b3, b4, b6, b7 = (times[k] for k in ("slice_raster", "level_hist",
                                             "slice_raster_carry",
                                             "encode_groups",
                                             "decode_groups"))
    print(f"time slice_raster wrapper alone on the Orion table: "
          f"{b1['wrapper_ms']!r} ms a call (CUDA events), host "
          f"{b1['host_ms']!r} ms a call, device {b1['device_ms']!r} ms a "
          f"call {b1['device_split_ms']!r}; host us per call of each step "
          f"{b1['host_steps_us']!r}")
    print(f"time level_hist wrapper alone on the Orion table, CPU edges by "
          f"value: {b3['wrapper_ms']!r} ms a call (CUDA events), host "
          f"{b3['host_ms']!r} ms a call, device {b3['device_ms']!r} ms a "
          f"call {b3['device_split_ms']!r}; edges on the card "
          f"{b3['device_edges_ms']!r} ms; host us per call of each step "
          f"{b3['host_steps_us']!r}; torch.histogram on the card: "
          f"{b3['torch.histogram on the card']}")
    print(f"time encode_groups: wrapper {b6['ms']!r} ms a call (CUDA "
          f"events), host {b6['host_ms']!r} ms a call, device "
          f"{b6['device_ms']!r} ms; host us per call of each step "
          f"{b6['host_steps_us']!r}; compress_bits stage per Orion snapshot "
          f"{wall['codec']['encode_split_ms'].get('compress_bits')!r} ms")
    print(f"time slice_raster_carry wrapper alone over "
          f"{bnd['slice_raster_carry']['tiles']} pre-cut tiles: "
          f"{b4['wrapper_ms']!r} ms a call (CUDA events), host "
          f"{b4['host_ms']!r} ms a call, device {b4['device_ms']!r} ms a "
          f"call {b4['device_split_ms']!r}; the "
          f"{bnd['slice_raster_carry']['tiles']}-tile chain through "
          f"ops.raster_slice_partial {b4['chain_ms']!r} ms")
    print(f"time decode_groups: wrapper {b7['ms']!r} ms a call (CUDA "
          f"events), host {b7['host_ms']!r} ms a call, device "
          f"{b7['device_ms']!r} ms; library torch.bitwise_xor "
          f"{b7['library_ms']!r} ms")
    b2, b5 = times["projection_raster"], times["projection_raster_carry"]
    print(f"time projection_raster wrapper alone on the Orion table: "
          f"{b2['wrapper_ms']!r} ms a call (CUDA events), host "
          f"{b2['host_ms']!r} ms a call, device {b2['device_ms']!r} ms a "
          f"call {b2['device_split_ms']!r}; longest cell segment "
          f"{b2['longest_segment']} rows")
    print(f"time projection_raster_carry wrapper alone over "
          f"{bnd['projection_raster_carry']['tiles']} pre-cut tiles: "
          f"{b5['wrapper_ms']!r} ms a call (CUDA events), host "
          f"{b5['host_ms']!r} ms a call, device {b5['device_ms']!r} ms a "
          f"call {b5['device_split_ms']!r}; the "
          f"{bnd['projection_raster_carry']['tiles']}-tile chain through "
          f"ops.raster_projection_partial {b5['chain_ms']!r} ms; longest "
          f"cell segment of a tile {b5['longest_segment']} rows, of the "
          f"adversarial tables {table_segment}")
    print(f"time host us per call of each step: slice_raster_carry "
          f"{b4['host_steps_us']!r}; projection_raster "
          f"{b2['host_steps_us']!r}; projection_raster_carry "
          f"{b5['host_steps_us']!r}; decode_groups {b7['host_steps_us']!r}")
    f32 = {name: times[name] for name in ("slice_raster_carry_f32",
                                          "projection_raster_carry_f32",
                                          "level_hist_f32")}
    for name, t in f32.items():
        per = f"over {bnd[name]['tiles']} pre-cut tiles" \
            if "tiles" in bnd[name] else "on the one-shard float32 table"
        print(f"time {name} wrapper alone {per}: {t['wrapper_ms']!r} ms a "
              f"call (CUDA events), host {t['host_ms']!r} ms a call, device "
              f"{t['device_ms']!r} ms a call {t['device_split_ms']!r}"
              + (f"; host us per call of each step {t['host_steps_us']!r}"
                 if "host_steps_us" in t else ""))
    wall["wrapper_calls"] = {"slice_raster": b1, "level_hist": b3,
                             "encode_groups": b6,
                             "slice_raster_carry": b4,
                             "projection_raster": b2,
                             "projection_raster_carry": b5,
                             "decode_groups": b7, **f32}
    for name in ("slice_raster_carry", "projection_raster_carry"):
        launches[name] = mesh_launches[name]     # the mesh path's (S=1)
    launches.update({k: v for k, v in               # the float32 path's
                     wall["mesh_f32"][1]["float32"]["launches"].items()
                     if k.endswith("_f32")})
    launches.update(wall["codec"]["launches"])   # one Orion snapshot's
    records = []
    for name, (replaces, source) in KERNELS.items():
        t, b = times[name], bnd[name]
        per = f"per tile call (mean of {b['tiles']} tiles), " \
            if "tiles" in b else ""
        where = "per Orion codec snapshot" if source == CODEC_SRC else \
            f"on the main path over {wall['steps']} steps"
        lib_ms = t.get("library_ms")
        if "device_ms" in t:
            dev_ms = t["device_ms"]
            per += (f"device time {dev_ms!r} ms a call, "
                    if dev_ms is not None else "device time not measured, ")
        print(f"time {name}: {per}kernel {t['ms']!r} ms, plain "
              f"{t['plain_ms']!r} ms, library "
              f"{'none' if lib_ms is None else repr(lib_ms) + ' ms'}, bound "
              f"{b['bound_ms']!r} ms by {b['bound_by']} ({b['bytes']} bytes, "
              f"{b['ops']} {b['ops_type']} ops), launches {launches[name]} "
              f"{where}")
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"],
                        "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                        "library_ms": lib_ms})
    print(json.dumps({"main_path": wall, "card": card}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
