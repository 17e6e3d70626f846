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
     slice and projection) called per BFS tile and in one call over the
     table (the mesh path's route) against their seeded twins' tile
     chain (image and depth, bitwise) and against one-shot B1/B2 — on
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
     at R = 16, 64 and 512, level-major and with the rows shuffled (the
     one call then keeps the chain's order by re-adding pixels), each
     call twice on the kept scratch; the mesh chain at its real shapes:
     every Orion shard at S = 1 and 4, float64 and float32, in one call
     against the twins' 16,384-row chain, and the S = 1 shard cut into
     calls of five tiles by a lowered row limit; the
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
     cuda:0`` on Sedov steps under the same contract; B4, B5 and B3 must
     launch once per shard per step; then
     ``MeshDAGRunner(dtype="float32")`` over Orion at one and four shards,
     in turns with the same runner at float64: every float32 output
     bitwise the float32 twins' run on the card, the slice within rtol
     1e-6 and the projection within 1e-4 of the float64 host reducers,
     the histogram and edges equal to the host's over the cast field,
     only the float32 kernels launched (B4-f32, B5-f32 and B3-f32 once
     per shard per step), and half the field bytes up and
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
     B4-f32/B5-f32 per shard call on the one-shard Orion table, beside
     the old chain of 35 per-tile calls timed in the same run, with B5's
     five steps and ``projection_kernel`` float32 against float64 from
     ``torch.profiler``; B3-f32 on the one-shard float32 table;
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
     cell) segment of the Orion table and shard; and the host cost of
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
     and power limit;
  9. the LM stack (``repro_torch.models``, ``configs``, ``train``; it
     reaches none of B1-B9), with TF32 off for float32 matmuls and the
     matmul flags printed: (a) each of the ten smoke configs, its
     parameters drawn on the CPU from a seeded generator, forward on the
     card against the port's CPU path at float32 (max rel err 5e-4) and
     bf16 compute (2e-2) - for MoE, a token whose top-k experts differ
     between the runs at a router near-tie (gap below 1e-4) and every
     token after it are left out, and any other difference in routing
     fails - then the grads of one batch twice on the card, bitwise
     equal, and one AdamW step (finite loss and grad norm, ``step ==
     1``, every parameter moved); (b) ``stablelm-1.6b``,
     ``granite-moe-1b-a400m`` and ``mamba2-1.3b`` at their published
     configs (bf16 compute, float32 params, remat), initialized on the
     card from a seeded generator by the reference's rule: on a (1, 16)
     prompt at float32 compute, each stage (embedding, block, head) on
     the card from the CPU run's own input against the CPU, forward and
     backward under a seeded cotangent (5e-4); ``LM.forward`` bitwise
     the layer walk on each device, and free-running on the card against
     the CPU within 5e-4 for stablelm, printed by layer for granite and
     mamba2, whose dynamics at this init grow float32 rounding until
     granite's routing differs; then three AdamW steps
     (``warmup_steps=1``) on one seeded batch of B = 2 and S = 4,096,
     whose losses and grad norms must stay finite. Whether the loss
     fell is printed, not held: at the reference's init granite's and
     mamba2's barely move in three steps (PERF.md section 5). Per model:
     step ms (median of steps 2-3), tokens/s, peak memory and the model
     FLOPs (6 x active parameters x tokens) as a share of 989 TFLOP/s
     bf16, beside the card's name and power limit; the phase's seconds;
 10. the trainer (``repro_torch.train.trainer``, ``launch.train``; no
     kernel of B1-B9): (a) ``python -m repro_torch.launch.train --arch
     minicpm_2b --smoke --steps 12 --seq-len 32 --global-batch 4
     --ckpt-every 4 --ckpt-async --ckpt-delta-every 2 --insitu-dir ...
     --insitu-every 2 --insitu-device-reduce --ledger`` (cuda, the
     default) must exit 0, its in-transit catalog must hold tnorm and
     spectra-k8 at steps 2-12 and its ledger's ``device_fallbacks`` read
     0 in every flush; (b) the same command under ``run_supervised`` with
     ``TRAIN_CRASH_AT=6`` on the first attempt must restart at least
     once and exit 0 under the same checks, and its step-12 checkpoint
     must restore onto the card bitwise equal to (a)'s; (c)
     ``Trainer`` on stablelm-1.6b at its published widths and vocabulary
     (d_model 2,048, 32 heads, d_ff 5,632, vocab 100,352) with its
     depth cut 24 -> 2 (a train state of 513.8 M parameters x 12 bytes,
     float32 params and moments; the uncut 19.7 GB state and its async
     clone would not fit the phase's time), B = 2 and S = 4,096, async
     full saves, ``TensorNormReducer`` and ``SpectraReducer(k=8)``
     reduced on the card every 2 steps, the ledger on: 6 steps
     uninterrupted with a save every 2 steps, then 4 steps saved at the
     4th and a fresh ``Trainer`` resuming to 6, whose final state and
     losses must equal the uninterrupted run's bitwise. Step ms (median
     of steps 2-6, saves in flight; and of the interrupted run's steps
     2-4, none in flight), tokens/s, each save's stall against the step
     and its background seconds (``ckpt.snapshot`` to ``ckpt.commit``),
     ``submit_state`` ms, the restore's seconds and MB/s, the losses and
     peak memory are printed beside the card's name and power limit;
 11. LM serving (``repro_torch.models.serving``, ``launch.serve``; no
     kernel of B1-B9): (a) ``python -m repro_torch.launch.serve --arch
     mamba2_1_3b --smoke --batch 2 --prompt-len 8 --tokens 4`` (cuda, the
     default) must exit 0 and print ``decode:``; (b) stablelm-1.6b (24
     layers, KV cache), mamba2-1.3b (48 layers, SSM conv and state) and
     recurrentgemma-2b (26 layers, RG-LRU and local attention, window
     2,048) at their published configs, uncut, bf16 compute, parameters
     drawn on the card from a seeded generator: ``prefill`` of 4 x 512
     tokens, then 32 teacher-forced ``decode_step``s, and for
     recurrentgemma also 2 x 2,040 prompt tokens + 32 steps, which wrap
     the window's ring cache. Held, within 2e-2 (the reference's bound,
     ``tests/test_models.py``): ``prefill`` and ``decode_step`` again
     with every layer run on ``LM.forward``'s own input at that layer
     and position (recorded from the forward), so that the embedding
     (bitwise), the order of the layers, the cache slot each reads and
     the head are those of the serving path, while no layer's rounding
     feeds the next: each layer's output against the forward's, / its
     largest, and the logits against the forward's, / the largest
     logit. Printed: the free-running logits against ``LM.forward``
     over the same tokens at bf16 and at float32 compute (TF32 off),
     beside the forward over the prompt alone against it and the
     forward's change under a relative 2^-7 on its embeddings: at the
     reference's init these models turn a rounding difference into a
     large share of the logits (PERF.md section 5). Prefill ms, decode
     ms a step and tok/s, cache bytes, peak memory and the errors are
     printed per model beside the card's name and power limit.

 12. sharding, the dry-run, the roofline and GPipe
     (``repro_torch.sharding``, ``launch.{mesh,rules,specs,dryrun,
     roofline,pipeline}``; no kernel of B1-B9): (a) ``python -m
     repro_torch.launch.dryrun`` in subprocesses, all started at once
     beside (b) and (c) (a fake process group must not share a process
     with NCCL): stablelm-1.6b x train_4k on the (16, 16) and
     (2, 16, 16) meshes and mixtral-8x22b x decode_32k on the (16, 16)
     mesh at their full configs, and the (1, 1) cell of (b); each
     must exit 0 and write its JSON, whose per-device argument bytes,
     peak, flops, collectives by type, dominant term and H100 bound are
     printed; (b) stablelm-1.6b uncut (24 layers, B = 2, S = 4,096,
     phase 9's shape): three AdamW steps of the plain step, then the
     same from the same init on a (1, 1) ``("data", "model")`` mesh of
     a real NCCL group of one rank, the train state and batch placed as
     DTensors by ``rules_for(..., "train_4k")`` and the steps run under
     ``sharding.use_rules``: losses and updated parameters must equal
     the plain step's bitwise; the placed state's ``memory_allocated``
     is printed beside the dry-run's argument bytes, the step's peak
     beside the dry-run's, the traced flops
     beside the model flops, and the H100 roofline bound, which must
     not exceed the measured step, beside it; the group is destroyed in
     a ``finally``; (c) the same model's 24 blocks (the plain step's
     parameters) as 4 stages of 6 on ``[cuda:0] * 4``
     (``pipeline.gpipe_forward``: a stream per stage), 8 microbatches of
     (1, 4,096, 2,048) bf16 activations, twice, each bitwise the
     sequential forward; the ticks (11), the bubble (3/11) and the walls
     are printed beside the card's name and power limit.

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


def tile_chain(x: dict, kind: str, *, resolution: int, tile_n: int,
               position: float = 0.5):
    """The per-tile seeded entries on the card: B4 (``kind="slice"``,
    image and depth) or B5 called once per ``tile_n``-row BFS tile, the
    last one padded, with the carry threaded through: the twins' chain
    (``ops._run_tiles``) run by the kernel wrappers, one launch a tile.
    B5 gets no ``tile_n``: each call is one tile."""
    import torch

    from repro_torch.kernels import ops, raster
    r, L = resolution, x["n_levels"]
    dev, dt = x["values"].device, x["values"].dtype
    if kind == "slice":
        def call(c2, ca, lv, val, okk, img, depth):
            return raster.slice_raster_carry(
                c2, ca, lv, val, okk, position=position, resolution=r,
                n_levels=L, init=(img, depth))
        cols = (ops.plane_coords(x["coords"], 2),
                x["coords"][:, 2].to(torch.int32),
                x["levels"].to(torch.int32), x["values"], x["ok"])
        seed = (torch.full((r, r), float("nan"), dtype=dt, device=dev),
                torch.full((r, r), -1, dtype=torch.int32, device=dev))
    else:
        def call(c2, lv, val, okk, img):
            return (raster.projection_raster_carry(
                c2, lv, val, okk, resolution=r, n_levels=L, init=img),)
        cols = (ops.plane_coords(x["coords"], 2),
                x["levels"].to(torch.int32), x["values"], x["ok"])
        seed = (torch.zeros((r, r), dtype=dt, device=dev),)
    return ops._run_tiles(call, cols, seed, tile_n=tile_n,
                          block_n=ops.BLOCK_N)


def check_chain_routes(label: str, x: dict, kind: str, *, resolution: int,
                       tile_n: int, position: float = 0.5) -> float:
    """B4 (``kind="slice"``) or B5, in ``x``'s values' dtype, both ways
    on the card against the twins' chain (``ops`` with ``backend="ref"``)
    over ``tile_n``-row tiles, bitwise: the per-tile seeded entries (one
    launch a tile) and ``ops``' one call over the table (one launch).
    Returns the image (the one call's) and the max abs error (0.0)."""
    import torch

    from repro_torch.kernels import ops, raster
    fx = "_f32" if x["values"].dtype == torch.float32 else ""
    name = ("slice_raster_carry" if kind == "slice" else
            "projection_raster_carry") + fx
    n_tiles = max(1, -(-x["values"].shape[0] // tile_n))
    kw = dict(axis=2, resolution=resolution, n_levels=x["n_levels"],
              tile_n=tile_n)
    args = (x["coords"], x["levels"], x["values"], x["ok"])
    if kind == "slice":
        twin = ops.raster_slice_partial(*args, position=position,
                                        backend="ref", **kw)
    else:
        twin = (ops.raster_projection_partial(*args, backend="ref", **kw),)
    before = dict(raster.LAUNCHES)
    tiled = tile_chain(x, kind, resolution=resolution, tile_n=tile_n,
                       position=position)
    torch.cuda.synchronize()
    _check_launched(before, {name: n_tiles}, f"{label}: {name} per tile")
    err = _same_bits(f"{label}: {name} over {n_tiles} tiles", tiled, twin)
    before = dict(raster.LAUNCHES)
    if kind == "slice":
        one = ops.raster_slice_partial(*args, position=position, **kw)
    else:
        one = (ops.raster_projection_partial(*args, **kw),)
    torch.cuda.synchronize()
    _check_launched(before, {name: 1}, f"{label}: {name} one call")
    err = max(err, _same_bits(f"{label}: {name} in one call", one, twin))
    return one[0], err


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
        got, errs[name] = check_chain_routes(label, x, kind,
                                             resolution=resolution,
                                             tile_n=tile_n)
        if not np.array_equal(got.cpu().numpy().view(np.int64),
                              np.asarray(host[one]["image"]).view(np.int64)):
            raise AssertionError(f"{label}: chained {name} differs from "
                                 f"the one-shot image")
    print(f"parity {label}: B1-B3 bit-equal to plain twins and host "
          f"reducers, B4/B5 per tile over {n_tiles} tiles of {tile_n} rows "
          f"and in one call bit-equal to the seeded twins' chain and to the "
          f"one-shot images (R={resolution}, {x['values'].shape[0]} padded "
          f"rows)")
    return errs, x, edges, n_hist


def check_carry_boundaries(label: str, arrays: dict, device, *,
                           resolution: int = 64, tile_n: int = 512,
                           f32: bool = False) -> None:
    """B4 (``f32``: B4-f32 on the values cast to float32) per
    ``tile_n``-row tile and in one call against its seeded twins' chain,
    bitwise (image and depth; :func:`check_chain_routes`), at slice
    positions on exact cell boundaries, with the tree's levels and with
    every 7th valid row given a level outside [0, n_levels) (rows B4 must
    drop)."""
    import torch

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
            check_chain_routes(f"{label} at position {pos}",
                               {**x, "levels": levels}, "slice",
                               resolution=resolution, tile_n=tile_n,
                               position=pos)
            if not f32:
                check_slice_twice(f"{label}: slice_raster at position {pos}",
                                  {**x, "levels": levels}, position=pos,
                                  resolution=resolution)
    b1 = "" if f32 else ", and B1 twice a position on the kept scratch,"
    print(f"parity {label}: {name} per tile over {n_tiles} tiles and in one "
          f"call bit-equal to its seeded twins' chain{b1} at positions "
          f"{positions}, with and without {rows.numel()} rows of "
          f"out-of-range level (R={resolution})")


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
    """B1 (twice on the kept scratch), B4 and B4-f32 (per 512-row tile
    and in one call) against their twins, bitwise, on
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
        for dtype in (torch.float64, torch.float32):
            check_chain_routes(label, {**x, "coords": t["coords"],
                                       "values": t["values"].to(dtype)},
                               "slice", resolution=res, tile_n=512)
        print(f"parity {label}: {tbl['levels'].shape[0]} rows, "
              f"{int(hit.sum())} hit the plane, {coarse} of them coarse "
              f"(keyed into cells); B1 twice on the kept scratch, B4 and "
              f"B4-f32 per tile over {n_tiles} tiles of 512 rows and in one "
              f"call, bit-equal to their twins' chain")
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
    """B2 whole and B5 against their twins on the card, bitwise, on
    :func:`projection_table` tables: sub-pixel levels with n_levels >
    k + 1 at R = 16 and 64, and at R = 512 (12 levels) deep columns of
    512 leaves at level 9 and of 2,048 at sub-pixel level 11; B5 per
    512-row and ``MESH_TILE``-row tile (all-invalid and padded tiles) and
    in one call with that ``tile_n``, on the level-major table and on its
    rows shuffled (the one call's restart in the chain's order). Each
    check runs twice, the second on the kept scratch.
    ``f32``: the values cast to float32 through B5-f32 (B2 has no float32
    kernel). Returns the longest cell segment of the tables."""
    import numpy as np
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
        # level-major, and shuffled: kept rows not level-sorted, where
        # the one call re-adds pixels in the chain's (tile, level, row)
        # order
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(
            x["values"].shape[0])).to(device)
        for order, rows in (("level-major", None), ("shuffled", perm)):
            tt = t if rows is None else {k: v[rows] for k, v in t.items()}
            for tn in (512, tile_n):
                for _ in range(2):
                    check_chain_routes(
                        f"projection table R={res} L={L} {order} "
                        f"tile_n={tn}", {**tt, "n_levels": L}, "projection",
                        resolution=res, tile_n=tn)
        what = "B5-f32" if f32 else "B2 and B5"
        print(f"parity projection table R={res} L={L}: "
              f"{x['values'].shape[0]} rows, {what} (B5 per tile and in one "
              f"call, tiles of 512 and {tile_n}; level-major and shuffled) "
              f"bit-equal to their twins, twice each")
    print(f"parity projection tables: longest cell segment {longest} rows")
    return longest


def check_parity_f32(label: str, x: dict, edges, n_hist: int, *,
                     resolution: int, tile_n: int) -> dict:
    """B4-f32 and B5-f32 per ``tile_n``-row tile and in one call, and
    B3-f32, on ``x``'s table with its values cast to float32, against
    their float32 twins on the card, bitwise (float32 bits compared as
    int32); only the float32 counters move, once per tile (once for the
    one call) and once per histogram."""
    import torch

    from repro_torch.kernels import raster, ref
    x = f32_inputs(x)
    n_tiles = -(-x["values"].shape[0] // tile_n)
    errs = {}
    for kind, name in (("slice", "slice_raster_carry_f32"),
                       ("projection", "projection_raster_carry_f32")):
        _, errs[name] = check_chain_routes(label, x, kind,
                                           resolution=resolution,
                                           tile_n=tile_n)
    args = (x["values"], x["levels"], x["ok"], edges)
    before = dict(raster.LAUNCHES)
    got = raster.level_hist(*args, n_levels=n_hist)
    torch.cuda.synchronize()
    _check_launched(before, {"level_hist_f32": 1}, f"{label}: B3-f32")
    errs["level_hist_f32"] = _same_bits(
        f"{label}: level_hist_f32", (got,),
        (ref.level_hist_ref(*args, n_levels=n_hist),))
    print(f"parity {label} float32: B4-f32 and B5-f32 per tile over "
          f"{n_tiles} tiles of {tile_n} rows and in one call, and B3-f32 "
          f"({edges.numel() - 1} bins) "
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
    """The twins' ``MESH_TILE``-row tiles over every shard: the calls a
    step made per reducer before the card took a shard in one call."""
    from repro_torch.insitu.mesh_reduce import MESH_TILE, MeshTable
    mt = MeshTable(arrays, 1, ["cpu"] * n_shards)    # row split only
    return n_shards * -(-mt.rows_padded // MESH_TILE)


def check_mesh_launches(counts: dict, label: str, *, n_shards: int,
                        steps: int, suffix: str = "") -> None:
    """B4, B5 and B3 once per shard, every step, in the kernels of
    ``suffix`` ("" float64, "_f32" float32); every other raster kernel
    never."""
    from repro_torch.kernels import raster
    want = dict.fromkeys(raster.LAUNCHES, 0)
    want.update({f"slice_raster_carry{suffix}": n_shards * steps,
                 f"projection_raster_carry{suffix}": n_shards * steps,
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
        check_mesh_launches(launches, f"mesh S={n_shards}",
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
              f"B4/B5 one call per shard per step (the twins' chain: "
              f"{tiles} tiles), launches {launches}, "
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
                n_shards=n_shards, steps=len(walls),
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
              f"host's over the cast field; B4-f32/B5-f32 one call per "
              f"shard per step (the twins' chain: {tiles} tiles), launches "
              f"{f32['launches']}")
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
    mesh contract, its kernels launched once per shard per step."""
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
    folds = {}
    for s in range(1, n_steps + 1):
        tree = amrgen.generate_tree(
            fields.sedov(r_shock=0.1 + 0.25 * s / n_steps), min_level=3,
            max_level=max_level, threshold=1.15, level_factor=1.05)
        if s % 2 == 0:
            folds[s, proj.name] = shard_fold(tree.to_arrays(), MESH_SHARDS,
                                             proj)
    n = catalogs_equal(str(tmp / "mesh_cli"), str(tmp / "mesh_cli_host"),
                       folds=folds)
    calls = MESH_SHARDS * len(folds)      # one per shard per written step
    want = {"slice_raster_carry": calls, "projection_raster_carry": calls,
            "level_hist": calls}
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
    flushes, fallbacks, run_verdict = ledger_signals(run)
    reader = LedgerReader(run)
    try:
        attributed = sorted(reader.attribs())
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


# ---------------------------------------------------- 9. the LM stack

#: phase 9's full-width configs (``configs/<arch>.py`` ``CONFIG``, uncut)
LM_FULL = ("stablelm_1_6b", "granite_moe_1b_a400m", "mamba2_1_3b")
#: full-width configs whose float32 prompt is held only layer by layer
#: (each block on the CPU run's own input), not free-running: at the
#: reference's init their dynamics grow float32 rounding layer by layer,
#: granite's until MoE routing differs (PERF.md section 5)
LM_PER_LAYER = ("granite_moe_1b_a400m", "mamba2_1_3b")
LM_BATCH, LM_SEQ = 2, 4096     # B = 2 at train_4k's sequence length
LM_STEPS = 3                   # AdamW steps on one batch
LM_PROMPT = 16                 # the float32 card-against-CPU prompt
#: max |logit difference| / max |CPU logit| (tests/test_torch_models.py)
LM_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
#: a router gap (k-th less (k+1)-th probability) below which float32 sums
#: in another order may pick another expert
LM_ROUTE_TIE = 1e-4
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12


def lm_matmul_flags() -> str:
    import torch
    m = torch.backends.cuda.matmul
    return (f"matmul.allow_tf32={m.allow_tf32}, cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32}, "
            f"allow_bf16_reduced_precision_reduction="
            f"{m.allow_bf16_reduced_precision_reduction}, "
            f"float32_matmul_precision="
            f"{torch.get_float32_matmul_precision()}")


def lm_batch(cfg, b: int, s: int, device, seed: int) -> dict:
    """A seeded batch on ``device``: tokens, next-token labels (the last
    masked) and the family's extras."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                           device=device)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["patch_embeds"] = 0.1 * torch.randn(
            (b, cfg.n_patches, cfg.d_model), generator=g, device=device)
    if cfg.family == "encdec":
        batch["frames"] = 0.1 * torch.randn(
            (b, cfg.n_frames, cfg.d_model), generator=g, device=device)
    return batch


def lm_logits(cfg, params, batch: dict, device, routing=None):
    """``cfg``'s logits (``LM.forward``) on ``device`` for ``params`` (any
    device); with ``routing`` a list, each MoE layer's router
    probabilities are appended to it (``moe.register_router_hook``)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import LM
    lm = LM(cfg, device=device)
    lm.load_param_tree(params)
    extras = {k: v.to(device) for k, v in batch.items()
              if k in ("patch_embeds", "frames")}
    hook = contextlib.nullcontext() if routing is None else \
        moe.register_router_hook(lambda p: routing.append(p.cpu()))
    with hook, torch.no_grad():
        logits, _ = lm(batch["tokens"].to(device), extras)
    del lm
    return logits.float().cpu()


def lm_route_flips(cpu_routing: list, card_routing: list, k: int) -> list:
    """(layer, token, margin) of every token whose top-k experts differ
    between the runs; margin is the CPU run's gap between its k-th and
    (k+1)-th router probabilities."""
    import torch
    flips = []
    for layer, (a, b) in enumerate(zip(cpu_routing, card_routing)):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        top = lambda p: torch.sort(p, dim=-1, descending=True, stable=True)
        ia = top(a).indices[:, :k].sort(-1).values
        ib = top(b).indices[:, :k].sort(-1).values
        for t in (ia != ib).any(-1).nonzero().flatten().tolist():
            va = top(a[t]).values
            flips.append((layer, t, float(va[k - 1] - va[k])))
    return flips


def lm_card_vs_cpu(cfg, params, batch: dict, device, label: str) -> dict:
    """max |card - CPU| / max |CPU| of ``cfg``'s logits; raises past
    LM_TOL or on a non-finite logit. For MoE, a token whose top-k
    experts differ between the runs at a near-tie (margin below
    LM_ROUTE_TIE) routes differently from there on: it and every later
    token in (row, position) order (causal attention; capacity is taken
    in that order) are left out, and any other flip raises."""
    import torch
    cpu_r, card_r = [], []
    moe = cfg.n_experts > 0
    cpu = lm_logits(cfg, params, batch, torch.device("cpu"),
                    cpu_r if moe else None)
    card = lm_logits(cfg, params, batch, device, card_r if moe else None)
    if not torch.isfinite(card).all():
        raise AssertionError(f"{label}: non-finite logits on the card")
    flips = lm_route_flips(cpu_r, card_r, cfg.top_k) if moe else []
    if any(margin > LM_ROUTE_TIE for _, _, margin in flips):
        raise AssertionError(f"{label}: routing differs past a near-tie: "
                             f"{flips}")
    # tokens in (row, position) order: dispatch and capacity take them so
    first = min([t for _, t, _ in flips], default=batch["tokens"].numel())
    cpu = cpu.reshape(-1, cpu.shape[-1])[:first]
    card = card.reshape(-1, card.shape[-1])[:first]
    err = float((card - cpu).abs().max() / cpu.abs().max()) if first else 0.0
    if not err <= LM_TOL[cfg.compute_dtype]:
        raise AssertionError(f"{label} {cfg.compute_dtype}: card against "
                             f"CPU {err!r} > {LM_TOL[cfg.compute_dtype]} "
                             f"over {first} positions")
    return {"rel_err": err, "positions": first, "route_flips": flips}


def lm_step_once(cfg, params, batch: dict, device, label: str) -> dict:
    """One train step on the card from ``params``: the grads bitwise the
    same in two runs, finite loss and grad norm, ``step == 1``, every
    parameter moved."""
    import torch
    from repro_torch.models.transformer import LM, tree_leaves
    from repro_torch.train import optim, step
    lm = LM(cfg, device=device)
    lm.load_param_tree(params)
    batch = {k: v.to(device) for k, v in batch.items()}
    runs = [tree_leaves(step.loss_and_grads(lm, lm.param_tree(), batch)[1])
            for _ in range(2)]
    differ = [name for (name, a), (_, b) in zip(*runs)
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"{label}: grads differ between two runs: "
                             f"{differ}")
    before = {k: v.detach().clone() for k, v in lm.named_parameters()}
    state = {"params": lm.param_tree(),
             **optim.init_opt_state(lm.param_tree())}
    state, m = step.make_train_step(lm, optim.OptConfig(warmup_steps=1))(
        state, batch)
    if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
        raise AssertionError(f"{label}: loss {m['loss']} grad norm "
                             f"{m['grad_norm']}")
    if int(state["step"]) != 1 or state["step"].dtype != torch.int32:
        raise AssertionError(f"{label}: step {state['step']}")
    still = [k for k, v in lm.named_parameters()
             if torch.equal(v, before[k])]
    if still:
        raise AssertionError(f"{label}: parameters did not move: {still}")
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def lm_smoke_configs(device, card: str) -> dict:
    """Phase 9(a): each smoke config's forward on the card against the
    CPU at float32 and bf16 compute, and one train step on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.models.transformer import LM
    out = {}
    for i, arch in enumerate(ARCHS):
        base = get_smoke_config(arch)
        params = LM(base, device=torch.device("cpu")).init(
            torch.Generator().manual_seed(90 + i))
        batch = lm_batch(base, 2, 16, torch.device("cpu"), 90 + i)
        errs = {dt: lm_card_vs_cpu(dataclasses.replace(base, compute_dtype=dt),
                                   params, batch, device, f"lm {arch}")
                for dt in ("float32", "bfloat16")}
        out[arch] = {"card_vs_cpu": errs,
                     **lm_step_once(base, params, batch, device,
                                    f"lm {arch}")}
        said = ", ".join(
            f"{dt} {e['rel_err']!r} (tol {LM_TOL[dt]}; {e['positions']} "
            f"tokens, {len(e['route_flips'])} near-tie route flips)"
            for dt, e in errs.items())
        print(f"lm smoke {arch}: card against CPU, max rel err {said}; train "
              f"step: loss {out[arch]['loss']!r}, grad norm "
              f"{out[arch]['grad_norm']!r}, grads bitwise equal in two runs, step "
              f"1, every parameter moved; "
              f"[{card}]")
    return out


def lm_hidden(lm, tokens, inputs=None) -> list:
    """The embedding, each block's output and the logits of a stacked
    (dense, MoE or SSM) model on ``tokens``, as float32 CPU tensors.
    With ``inputs`` (another run's list), block i runs on its input
    there and the logits come from its last hidden state."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models.transformer import _unstack
    cfg, params = lm.cfg, lm.param_tree()
    dev = lm.device
    tokens = tokens.to(dev)
    pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=dev)[None].repeat(tokens.shape[0], 1)
    take = (lambda i, x: x) if inputs is None else \
        (lambda i, x: inputs[i].to(dev, layers.dtype_of(cfg.compute_dtype)))
    with torch.no_grad():
        x = layers.embed(params["embed"], tokens, cfg)
        out = [x]
        for i, lp in enumerate(_unstack(params["blocks"])):
            x, _, _ = lm._apply_block(lm.kinds[0], lp, take(i, x), pos)
            out.append(x)
        x = layers.apply_norm(params["final_norm"], take(len(out) - 1, x),
                              cfg)
        out.append(layers.unembed(params["embed"], x, cfg))
    return [t.float().cpu() for t in out]


def lm_stage_grads(lm, batch: dict, inputs: list, seed: int) -> list:
    """Each stage of a stacked model alone, on its input in ``inputs`` (a
    :func:`lm_hidden` list): the embedding, each block, and the head
    (final norm, unembed and the float32 NLL of ``batch["labels"]``).
    The embedding and blocks take a seeded normal cotangent on their
    output. Returns per stage the grads of its input and of every
    parameter it reads (a leaf it does not read has none), as float32
    CPU tensors."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models.transformer import _unstack, map_tree, tree_leaves
    cfg, params = lm.cfg, lm.param_tree()
    dev = lm.device
    dt = layers.dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"].to(dev)
    labels = batch["labels"].to(dev).long()
    pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=dev)[None].repeat(tokens.shape[0], 1)
    g = torch.Generator().manual_seed(seed)
    leaf = lambda t: t.detach().clone().requires_grad_(True)

    def grads(y, wrt: dict) -> dict:
        if y.dim():
            y = (y.float() * torch.randn(y.shape, generator=g).to(dev)).sum()
        names, flat = zip(*tree_leaves(wrt))
        return {n: t.float().cpu() for n, t in zip(
            names, torch.autograd.grad(y, flat, allow_unused=True))
            if t is not None}
    emb = map_tree(leaf, params["embed"])
    out = [grads(layers.embed(emb, tokens, cfg), {"embed": emb})]
    for i, lp in enumerate(_unstack(params["blocks"])):
        x = leaf(inputs[i].to(dev, dt))
        lp = map_tree(leaf, lp)
        y, _, _ = lm._apply_block(lm.kinds[0], lp, x, pos)
        out.append(grads(y, {"x": x, "block": lp}))
    x = leaf(inputs[len(out) - 1].to(dev, dt))
    head = {"final_norm": map_tree(leaf, params["final_norm"]),
            "embed": map_tree(leaf, params["embed"])}
    logits = layers.unembed(head["embed"], layers.apply_norm(
        head["final_norm"], x, cfg), cfg).float()
    nll = torch.logsumexp(logits, -1) - torch.gather(
        logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    out.append(grads(nll[labels >= 0].mean(), {"x": x, **head}))
    return out


def lm_layers_card_vs_cpu(cfg, params, batch: dict, device, label: str,
                          free: bool) -> dict:
    """The port's layers on the card against the CPU at full width: each
    block, and the final norm and unembed, on the CPU run's own input
    (max |card - CPU| / max |CPU| within LM_TOL, or raise), forward and
    backward (:func:`lm_stage_grads`, each grad within LM_TOL of its
    largest CPU value); and ``LM.forward``'s logits free-running, which
    must be the layer walk's bitwise on each device, and with ``free``
    must agree within LM_TOL (else the divergence by layer, which the
    model's own dynamics grow, is only printed). Also returns the CPU
    logits."""
    import torch
    from repro_torch.models.transformer import LM
    tokens = batch["tokens"]

    def rel(a, b):
        top = float(b.abs().max())
        return float((a - b).abs().max()) / (top if top > 0 else 1.0)
    runs = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", device)):
        lm = LM(cfg, device=dev)
        lm.load_param_tree(params)
        walk = lm_hidden(lm, tokens)
        with torch.no_grad():
            forward = lm(tokens.to(dev))[0].float().cpu()
        if not torch.equal(forward, walk[-1]):
            raise AssertionError(f"{label}: LM.forward's logits on {name} "
                                 f"differ from the layer walk's by "
                                 f"{rel(forward, walk[-1])!r}")
        cpu = runs["cpu"]["walk"] if runs else walk
        runs[name] = {"walk": walk,
                      "forced": lm_hidden(lm, tokens, inputs=cpu),
                      "grads": lm_stage_grads(lm, batch, cpu, seed=9)}
        del lm
    cpu, card = runs["cpu"], runs["card"]
    if not all(torch.isfinite(t).all() for t in card["forced"] + card["walk"]
               + [t for st in card["grads"] for t in st.values()]):
        raise AssertionError(f"{label}: non-finite values on the card")
    tol = LM_TOL[cfg.compute_dtype]
    errs = [rel(a, b) for a, b in zip(card["forced"][1:], cpu["walk"][1:])]
    if not max(errs) <= tol:
        raise AssertionError(f"{label}: card against CPU on the same "
                             f"inputs {errs!r} > {tol}")
    grad_errs = [max(rel(st[k], cst[k]) for k in cst)
                 for st, cst in zip(card["grads"], cpu["grads"])]
    if not max(grad_errs) <= tol:
        raise AssertionError(f"{label}: grads, card against CPU on the "
                             f"same inputs, by stage {grad_errs!r} > {tol}")
    out = {"layers": errs[:-1], "logits": errs[-1], "grads": grad_errs,
           "free": [rel(a, b) for a, b in zip(card["walk"][1:-1],
                                             cpu["walk"][1:-1])],
           "free_logits": rel(card["walk"][-1], cpu["walk"][-1]),
           "cpu_logits": cpu["walk"][-1]}
    if free and not out["free_logits"] <= tol:
        raise AssertionError(f"{label}: LM.forward, card against CPU "
                             f"{out['free_logits']!r} > {tol}")
    return out


def lm_prompt_check(arch: str, cfg, params, device, seed: int) -> dict:
    """Phase 9(b)'s float32 (1, LM_PROMPT) prompt, card against CPU on
    the same parameters (TF32 off): :func:`lm_layers_card_vs_cpu`, with
    ``LM.forward``'s free-running logits held to LM_TOL except for
    LM_PER_LAYER. Also the CPU logits' spread, their largest value and
    the label's, averaged over positions, and the NLL: a tied embedding
    drawn at scale 1 (the reference's ``embed_spec``) unembeds a hidden
    state of norm sqrt(d_model) onto rows of norm sqrt(d_model), so its
    logits spread by about sqrt(d_model) and the loss is about the
    largest of them."""
    import dataclasses
    import torch
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    prompt = lm_batch(cfg, 1, LM_PROMPT, torch.device("cpu"), seed)
    out = lm_layers_card_vs_cpu(cfg32, params, prompt, device,
                                f"lm {cfg.name} prompt",
                                free=arch not in LM_PER_LAYER)
    logits = out.pop("cpu_logits")[0, :-1]
    labels = prompt["labels"][0, :-1]
    pos = torch.arange(len(labels))
    out["logit_std"] = float(logits.std())
    out["max_logit"] = float(logits.max(-1).values.mean())
    out["label_logit"] = float(logits[pos, labels].mean())
    out["nll"] = float((torch.logsumexp(logits, -1)
                        - logits[pos, labels]).mean())
    return out


def lm_full_width(arch: str, device, card: str, seed: int) -> dict:
    """Phase 9(b) for one config: init on the card from a seeded
    generator, the float32 prompt on the card against the CPU, then
    LM_STEPS AdamW steps on one (LM_BATCH, LM_SEQ) batch at the config's
    compute dtype, timed with a sync each. The losses must be finite;
    whether they fall is printed (see the module docstring)."""
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    from repro_torch.train import optim, step
    cfg = get_config(arch)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    lm = LM(cfg, device=device)
    state = step.init_state(lm, torch.Generator(device=device)
                            .manual_seed(seed))
    torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    f32 = lm_prompt_check(arch, cfg, lm.param_tree(), device, seed)
    batch = lm_batch(cfg, LM_BATCH, LM_SEQ, device, seed + 1)
    train_step = step.make_train_step(lm, optim.OptConfig(warmup_steps=1))
    losses, grad_norms, step_ms = [], [], []
    for _ in range(LM_STEPS):
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))       # syncs
        torch.cuda.synchronize(device)
        step_ms.append(1e3 * (time.perf_counter() - t1))
        grad_norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(device)
    if not all(math.isfinite(x) for x in losses + grad_norms):
        raise AssertionError(f"lm {cfg.name}: losses {losses}, grad norms "
                             f"{grad_norms}")
    if int(state["step"]) != LM_STEPS:
        raise AssertionError(f"lm {cfg.name}: step {state['step']}")
    ms = statistics.median(step_ms[1:])
    tokens = LM_BATCH * LM_SEQ
    flops = 6.0 * cfg.active_param_count() * tokens
    fell = (losses[0] - losses[-1]) / losses[0]
    out = {"layers": cfg.n_layers, "params": n_params,
           "active_params": cfg.active_param_count(), "init_s": init_s,
           "prompt_f32": f32, "losses": losses, "grad_norms": grad_norms,
           "loss_fell": fell, "step_ms": step_ms, "step_ms_median_2_3": ms,
           "tokens_per_s": tokens / (ms / 1e3), "peak_bytes": peak,
           "model_flops_per_step": flops,
           "bf16_peak_share": flops / (ms / 1e3) / BF16_FLOPS_PER_S}
    del lm, state, train_step, batch, m
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    free = (f"free-running {f32['free_logits']!r} (by layer "
            f"{[float('%.2g' % x) for x in f32['free']]}; "
            + ("printed only: " + arch + "'s dynamics grow it)"
               if arch in LM_PER_LAYER else f"tol {LM_TOL['float32']})"))
    print(f"lm {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters, {cfg.compute_dtype} compute, remat "
          f"{cfg.remat}): B={LM_BATCH} S={LM_SEQ}, losses {losses!r} "
          f"({'fell' if fell > 0 else 'did not fall'}: {fell!r} of the "
          f"first), grad norms {grad_norms!r}; step {ms!r} ms (median of "
          f"steps 2-{LM_STEPS}; all {step_ms!r}), "
          f"{out['tokens_per_s']!r} tokens/s, peak memory {peak} bytes, "
          f"model FLOPs {flops!r} a step (6 x {cfg.active_param_count()} "
          f"active parameters x {tokens} tokens) = "
          f"{out['bf16_peak_share']!r} of 989 TFLOP/s bf16; float32 "
          f"(1, {LM_PROMPT}) prompt, card against CPU (tol "
          f"{LM_TOL['float32']}): each layer on the CPU's input, max rel "
          f"err {max(f32['layers'])!r} (logits {f32['logits']!r}), its "
          f"grads {max(f32['grads'])!r}; LM.forward {free}; CPU logits "
          f"spread {f32['logit_std']!r}, largest {f32['max_logit']!r}, "
          f"label's {f32['label_logit']!r}, NLL {f32['nll']!r} (means over "
          f"positions); {out['seconds']:.1f} s; [{card}]")
    return out


def lm_phase(device, card: str) -> dict:
    """Phase 9 (see the module docstring)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"lm phase: {lm_matmul_flags()}")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"smoke": lm_smoke_configs(device, card)}
    for i, arch in enumerate(LM_FULL):
        out[arch] = lm_full_width(arch, device, card, 100 + 10 * i)
    out["phase_s"] = time.perf_counter() - t0
    print(f"lm phase 9 took {out['phase_s']!r} s")
    return out


# ------------------------------------------ 10. the trainer on the card

#: phase 10(a)/(b)'s command (``launch.train``'s flags; cuda by default)
TRAIN_CLI = ["--arch", "minicpm_2b", "--smoke", "--steps", "12",
             "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "4",
             "--ckpt-async", "--ckpt-delta-every", "2", "--insitu-every",
             "2", "--insitu-device-reduce", "--ledger"]
TRAIN_CRASH_AT = 6
#: phase 10(c): stablelm-1.6b at its published widths and vocabulary,
#: depth cut 24 -> 2 (the uncut state, 1.644 G params x 12 B, and its
#: async clone would not fit the phase's time); phase 9's batch shape
TRAIN_FULL_ARCH, TRAIN_FULL_DEPTH = "stablelm_1_6b", 2
TRAIN_SEQ, TRAIN_BATCH = 4096, 2
TRAIN_FULL_STEPS, TRAIN_RESUME_AT = 6, 4


def ledger_signals(run: str) -> tuple:
    """(flushes, device_fallbacks per flush, verdict) of a run ledger."""
    from repro_torch.obs import LedgerReader
    reader = LedgerReader(run)
    try:
        flushes = reader.flushes()
        signals = [next(iter(f["parts"]["meta"].values()))["signals"]
                   for f in flushes]
        return (flushes, [sig.get("device_fallbacks") for sig in signals],
                reader.verdict(flushes))
    finally:
        reader.close()


def restore_state(root: str, lm, device):
    """The latest complete step of an async HProt run, restored onto
    ``device`` (the trainer's template), and that step."""
    from repro_torch.ckpt import AsyncCheckpointManager
    from repro_torch.train import step as step_lib
    mgr = AsyncCheckpointManager(root)
    try:
        latest = mgr.latest_step()
        state, _ = mgr.restore(step_lib.abstract_state(lm, device))
    finally:
        mgr.close()
    return state, latest


def states_bitwise(label: str, got, want) -> int:
    """Raise unless two train states hold the same bytes; their size."""
    import torch

    from repro_torch.models.transformer import tree_leaves
    a, b = tree_leaves(got), tree_leaves(want)
    if [n for n, _ in a] != [n for n, _ in b]:
        raise AssertionError(f"{label}: state trees differ")
    differ = [n for (n, x), (_, y) in zip(a, b)
              if x.dtype != y.dtype or not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"{label}: leaves differ bitwise: {differ}")
    return sum(_nbytes(x) for _, x in a)


def train_cli(tmp: Path, device, label: str, supervised: bool) -> dict:
    """Phase 10(a), or (b) with ``supervised``: ``python -m
    repro_torch.launch.train`` (TRAIN_CLI, no ``--device``: cuda) exits
    0 (under ``run_supervised`` with TRAIN_CRASH_AT on the first attempt,
    after at least one restart), its checkpoints end at step 12, its
    in-transit catalog holds the reducers at every second step, and its
    ledger's ``device_fallbacks`` reads 0 in every flush."""
    from repro_torch.insitu import Catalog
    from repro_torch.train.supervisor import run_supervised
    run = tmp / label
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
           "--ckpt-dir", str(run / "ck"), "--insitu-dir", str(run / "ins")]
    t0 = time.perf_counter()
    if supervised:
        rc, restarts = run_supervised(
            cmd, max_restarts=3, env={"PYTHONPATH": str(ROOT / "src")},
            env_first={"TRAIN_CRASH_AT": str(TRAIN_CRASH_AT)})
        text = ""
    else:
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              env=_src_env(), timeout=600)
        rc, restarts, text = proc.returncode, 0, proc.stdout + proc.stderr
    wall = time.perf_counter() - t0
    if rc != 0 or (supervised and restarts < 1):
        raise AssertionError(f"train cli {label}: rc {rc}, {restarts} "
                             f"restarts\n{text[-3000:]}")
    cat = Catalog(str(run / "ins"))
    steps = cat.steps()
    reducers = sorted(cat.reducers(steps[-1])) if steps else []
    if steps != list(range(2, 13, 2)) or reducers != ["spectra-k8", "tnorm"]:
        raise AssertionError(f"train cli {label}: catalog steps {steps}, "
                             f"reducers {reducers}")
    flushes, fallbacks, verdict = ledger_signals(str(run / "ins"))
    if not fallbacks or any(v != 0.0 for v in fallbacks):
        raise AssertionError(f"train cli {label}: ledger device_fallbacks "
                             f"{fallbacks}")
    if verdict == "critical":
        raise AssertionError(f"train cli {label}: ledger verdict critical")
    return {"rc": rc, "restarts": restarts, "seconds": wall,
            "catalog_steps": steps, "reducers": reducers,
            "ledger_flushes": len(flushes), "device_fallbacks": fallbacks,
            "verdict": verdict}


def ckpt_saves(trainer) -> list:
    """Wrap ``trainer.ckpt.save`` to record each call's step and its
    stall on the train thread (host wall, ms)."""
    saves = []
    save = trainer.ckpt.save

    def timed(step, state, **kw):
        t0 = time.perf_counter()
        save(step, state, **kw)
        saves.append({"step": step,
                      "stall_ms": 1e3 * (time.perf_counter() - t0)})
    trainer.ckpt.save = timed
    return saves


def submit_calls(trainer) -> list:
    """Wrap ``trainer.insitu.submit_state`` to record the ms of each call
    that stages a step (the others return at once)."""
    calls = []
    submit = trainer.insitu.submit_state

    def timed(step, state, **kw):
        t0 = time.perf_counter()
        staged = submit(step, state, **kw)
        if step % trainer.insitu.output_every == 0:
            calls.append({"step": step, "staged": staged,
                          "ms": 1e3 * (time.perf_counter() - t0)})
        return staged
    trainer.insitu.submit_state = timed
    return calls


def save_backgrounds(spans: list) -> dict:
    """Per saved step, seconds from the ``ckpt.snapshot`` span's start
    to the end of its ``ckpt.commit`` (the save's work off the train
    thread, the stall included)."""
    start = {s["args"]["step"]: s["ts"] for s in spans
             if s["name"] == "ckpt.snapshot"}
    return {s["args"]["step"]: (s["ts"] + s["dur"] - start[s["args"]["step"]])
            / 1e6 for s in spans if s["name"] == "ckpt.commit"}


def train_full_run(root: Path, device, steps: int,
                   ckpt_every: int = 2) -> tuple:
    """Phase 10(c): one ``Trainer`` on the cut stablelm in ``root``, run
    to ``steps`` (resuming from the latest checkpoint there) with a save
    every ``ckpt_every`` steps and at the last; its final state and what
    it measured."""
    import dataclasses
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.insitu import SpectraReducer, TensorNormReducer
    from repro_torch.models.transformer import LM
    from repro_torch.obs import TRACER
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(get_config(TRAIN_FULL_ARCH),
                              n_layers=TRAIN_FULL_DEPTH)
    TRACER.clear()
    trainer = Trainer(
        LM(cfg, device=device), opt_cfg=optim.OptConfig(warmup_steps=1),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH),
        ckpt_dir=str(root / "ck"), ckpt_every=ckpt_every, ckpt_async=True,
        ckpt_delta_every=0, insitu_dir=str(root / "ins"), insitu_every=2,
        insitu_device_reduce=True,
        insitu_reducers=[TensorNormReducer(), SpectraReducer(k=8)],
        ledger=True, log_every=0, device=device)
    saves, submits = ckpt_saves(trainer), submit_calls(trainer)
    restore_s = None
    if trainer.ckpt.latest_step() is not None:
        init = trainer.init_or_restore

        def timed_restore():
            nonlocal restore_s
            t0 = time.perf_counter()
            out = init()
            torch.cuda.synchronize(device)
            restore_s = time.perf_counter() - t0
            return out
        trainer.init_or_restore = timed_restore
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = trainer.run(steps)
    wall = time.perf_counter() - t0
    bg = save_backgrounds(TRACER.spans())
    TRACER.disable()
    TRACER.clear()
    for sv in saves:
        sv["background_s"] = bg.get(sv["step"])
    return state, {
        "steps": [m["step"] for m in trainer.metrics_log],
        "losses": [m["loss"] for m in trainer.metrics_log],
        "step_ms": [1e3 * m["dt"] for m in trainer.metrics_log],
        "saves": saves, "submits": submits, "restore_s": restore_s,
        "peak_bytes": torch.cuda.max_memory_allocated(device),
        "wall_s": wall, "params": sum(p.numel()
                                      for p in trainer.lm.parameters()),
        "ckpt": {k: v for k, v in trainer.ckpt.telemetry().items()
                 if k in ("committed", "bytes_to_host", "d2h_seconds",
                          "encode_seconds", "stall_seconds_total")},
        "ledger": ledger_signals(str(root / "ins"))[1:]}


def train_full_width(tmp: Path, device, card: str) -> dict:
    """Phase 10(c): TRAIN_FULL_STEPS steps uninterrupted, then
    TRAIN_RESUME_AT steps and a fresh ``Trainer`` resuming to
    TRAIN_FULL_STEPS; the two final states must be equal bitwise. The
    interrupted run saves only at its last step, so its steps 2 to
    TRAIN_RESUME_AT run with no save in flight (the unimpeded step)."""
    import statistics
    import torch
    whole, a = train_full_run(tmp / "full_a", device, TRAIN_FULL_STEPS)
    shutil.rmtree(tmp / "full_a", ignore_errors=True)
    _, b1 = train_full_run(tmp / "full_b", device, TRAIN_RESUME_AT,
                           ckpt_every=TRAIN_RESUME_AT)
    resumed, b2 = train_full_run(tmp / "full_b", device, TRAIN_FULL_STEPS)
    shutil.rmtree(tmp / "full_b", ignore_errors=True)
    nbytes = states_bitwise("train full width: resumed against whole",
                            resumed, whole)
    del whole, resumed
    torch.cuda.empty_cache()
    if b2["steps"] != list(range(TRAIN_RESUME_AT + 1,
                                 TRAIN_FULL_STEPS + 1)):
        raise AssertionError(f"train full width: resumed steps {b2['steps']}")
    if not all(math.isfinite(x) for x in a["losses"]) or \
            a["losses"] != b1["losses"] + b2["losses"]:
        raise AssertionError(f"train full width: losses {a['losses']}, "
                             f"interrupted {b1['losses']} and resumed "
                             f"{b2['losses']}")
    for run in (a, b1, b2):
        fallbacks, verdict = run["ledger"]
        if not fallbacks or any(v != 0.0 for v in fallbacks) or \
                verdict == "critical":
            raise AssertionError(f"train full width: ledger {run['ledger']}")
    step_ms = statistics.median(a["step_ms"][1:])
    free_ms = statistics.median(b1["step_ms"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"depth": TRAIN_FULL_DEPTH, "params": a["params"],
           "state_bytes": nbytes, "step_ms_median": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "step_ms_no_save": free_ms,
           "tokens_per_s_no_save": tokens / (free_ms / 1e3), "run": a,
           "resume_first": b1, "resume": b2,
           "restore_mb_per_s": nbytes / 1e6 / b2["restore_s"]}
    tel = a["ckpt"]
    saves = "; ".join(
        f"step {sv['step']} stall {sv['stall_ms']:.2f} ms "
        f"({sv['stall_ms'] / step_ms!r} of a step), background "
        f"{sv['background_s']!r} s" for sv in a["saves"])
    print(f"train full width: {TRAIN_FULL_ARCH} at its published widths "
          f"and vocabulary, depth cut 24 -> {TRAIN_FULL_DEPTH}: {a['params']} "
          f"parameters, a train state of {nbytes} bytes (float32 params, "
          f"mu, nu); B={TRAIN_BATCH} S={TRAIN_SEQ}, bf16 compute, async "
          f"full saves every 2 steps, device-reduced tnorm + spectra-k8 "
          f"every 2, ledger on; step {step_ms!r} ms (median of steps "
          f"2-{TRAIN_FULL_STEPS}, saves in flight from step 3; all "
          f"{a['step_ms']!r}), {out['tokens_per_s']!r} tokens/s; with no "
          f"save in flight (the interrupted run's steps "
          f"2-{TRAIN_RESUME_AT}: {b1['step_ms'][1:]!r}) {free_ms!r} ms, "
          f"{out['tokens_per_s_no_save']!r} tokens/s; losses "
          f"{a['losses']!r}; "
          f"saves: {saves}; submit_state ms "
          f"{[round(c['ms'], 3) for c in a['submits']]}; run {a['wall_s']!r} "
          f"s; peak memory {a['peak_bytes']} bytes; the saves' gathers: "
          f"{tel['bytes_to_host']} bytes to the host at "
          f"{hprot_rate(tel['bytes_to_host'], tel['d2h_seconds'])!r} MB/s, "
          f"encoded at {hprot_rate(tel['bytes_to_host'], tel['encode_seconds'])!r}"
          f" MB/s; [{card}]")
    print(f"train full width: resumed from step {TRAIN_RESUME_AT} in a "
          f"fresh Trainer to {TRAIN_FULL_STEPS}: restore {b2['restore_s']!r} "
          f"s ({out['restore_mb_per_s']!r} MB/s, CRC-verified, onto the "
          f"card), losses {b2['losses']!r}, final state bitwise the "
          f"uninterrupted run's; its saves' stalls "
          f"{[round(sv['stall_ms'], 2) for sv in b1['saves'] + b2['saves']]}"
          f" ms; [{card}]")
    return out


def trainer_phase(tmp: Path, device, card: str) -> dict:
    """Phase 10 (see the module docstring)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import LM
    t0 = time.perf_counter()
    out = {"cli": train_cli(tmp, device, "cli", supervised=False),
           "supervised": train_cli(tmp, device, "supervised",
                                   supervised=True)}
    lm = LM(get_smoke_config("minicpm_2b"), device=device)
    (a, sa), (b, sb) = (restore_state(str(tmp / run / "ck"), lm, device)
                        for run in ("cli", "supervised"))
    if sa != 12 or sb != 12:
        raise AssertionError(f"train cli: latest steps {sa}, {sb}")
    nbytes = states_bitwise("train cli: supervised crash against "
                            "uninterrupted", b, a)
    print(f"train cli: python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_CLI)} on cuda: rc 0 in "
          f"{out['cli']['seconds']:.1f} s, catalog steps "
          f"{out['cli']['catalog_steps']} ({out['cli']['reducers']}), "
          f"{out['cli']['ledger_flushes']} ledger flushes, device_fallbacks "
          f"{out['cli']['device_fallbacks']}, verdict "
          f"{out['cli']['verdict']}; under run_supervised with "
          f"TRAIN_CRASH_AT={TRAIN_CRASH_AT}: rc 0 after "
          f"{out['supervised']['restarts']} restart(s) in "
          f"{out['supervised']['seconds']:.1f} s, its step-12 checkpoint "
          f"({nbytes} bytes) restores bitwise the uninterrupted run's; "
          f"[{card}]")
    del a, b, lm
    torch.cuda.empty_cache()
    out["full_width"] = train_full_width(tmp, device, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"trainer phase 10 took {out['phase_s']!r} s")
    return out


# ---------------------------------------------------- 11. LM serving

#: phase 11(b)'s published configs, uncut
SERVE_FULL = ("stablelm_1_6b", "mamba2_1_3b", "recurrentgemma_2b")
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 512, 32
#: recurrentgemma's ring case: 2,040 + 32 positions pass its 2,048 window
SERVE_RING_BATCH, SERVE_RING_PROMPT = 2, 2040
#: max |decode - forward| / max |forward logit| (tests/test_models.py:74)
SERVE_TOL = 2e-2


def serve_cli(device) -> dict:
    """Phase 11(a): ``python -m repro_torch.launch.serve`` on the mamba2
    smoke config (no ``--device``: cuda) exits 0 and prints ``decode:``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "mamba2_1_3b", "--smoke", "--batch", "2", "--prompt-len", "8",
           "--tokens", "4"]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=_src_env(), timeout=600)
    if proc.returncode != 0 or "decode:" not in proc.stdout:
        raise AssertionError(f"serve cli: rc {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr[-3000:]}")
    lines = [ln.strip() for ln in proc.stdout.splitlines() if ln.strip()]
    print(f"serve cli: python -m repro_torch.launch.serve "
          f"{' '.join(cmd[3:])} on cuda: rc 0; {' | '.join(lines)}")
    return {"rc": 0, "stdout": lines}


def forward_walk(lm, tokens, prompt: int, embed=None) -> tuple:
    """``LM.forward`` over all of ``tokens``, with ``LM._apply_block``
    wrapped to record, in the forward's own order, each layer's input
    and output at the decoded positions (prompt ..); ``embed``, if set,
    maps the embeddings first. Returns (those per-layer (input, output)
    pairs, the logits of positions prompt-1 .. end as float32)."""
    import torch

    from repro_torch.models import layers
    block, emb = lm._apply_block, layers.embed
    seen = []

    def recorded(kind, p, x, positions, **kw):
        out = block(kind, p, x, positions, **kw)
        seen.append((x[:, prompt:].clone(), out[0][:, prompt:].clone()))
        return out
    lm._apply_block = recorded
    if embed is not None:
        layers.embed = lambda *a: embed(emb(*a))
    try:
        with torch.no_grad():
            logits = lm(tokens)[0][:, prompt - 1:].float()
    finally:
        del lm._apply_block
        layers.embed = emb
    return seen, logits


def teacher_forced(lm, params, tokens, prompt: int, seen, logits) -> dict:
    """``prefill`` over the prompt, then one ``decode_step`` a remaining
    token, with ``serving.decode_block`` wrapped so that the k-th layer
    ``decode_step`` calls takes the forward's k-th layer input at that
    position (:func:`forward_walk`) and hands the forward's output on.
    So every layer runs on the forward's own inputs while ``prefill``
    and ``decode_step`` assemble the model: the embedding (the first
    layer's input must be the forward's bitwise), the order of the
    layers, the cache slot each reads (as ``prefill`` placed it, the
    window's ring included) and the head. Per layer, max |its decode
    output - the forward's| / max |the forward's| over the decoded
    positions; and the head's logits against the forward's, / max
    |logit|. The step count must be the forward's layer count."""
    import torch

    from repro_torch.models import serving
    inner = serving.decode_block
    errs = [0.0] * len(seen)
    at = {}

    def forced(lm_, kind, p, x, lc, pos):
        k, i = at["layer"], pos - prompt
        at["layer"] += 1
        x_in, y_out = (t[:, i:i + 1] for t in seen[k])
        if k == 0 and not torch.equal(x, x_in):
            raise AssertionError(f"serve {lm.cfg.name}: decode_step's "
                                 f"embedding at position {pos} is not the "
                                 f"forward's")
        y = inner(lm_, kind, p, x_in, lc, pos)
        errs[k] = max(errs[k], float((y.float() - y_out.float()).abs().max())
                      / float(seen[k][1].float().abs().max()))
        return y_out
    head = 0.0
    scale = float(logits.abs().max())
    serving.decode_block = forced
    try:
        _, cache = serving.prefill(lm, params, tokens[:, :prompt],
                                   max_seq=tokens.shape[1])
        for i in range(tokens.shape[1] - prompt):
            at["layer"] = 0
            lg, cache = serving.decode_step(lm, params, tokens[:, prompt + i],
                                            prompt + i, cache)
            if at["layer"] != len(seen):
                raise AssertionError(f"serve {lm.cfg.name}: decode_step ran "
                                     f"{at['layer']} layers, the forward "
                                     f"{len(seen)}")
            head = max(head, float((lg.float() - logits[:, i + 1]).abs()
                                   .max()) / scale)
    finally:
        serving.decode_block = inner
    return {"layer_errs": errs, "head_err": head}


def free_running(lm, params, tokens, prompt: int):
    """``prefill`` of ``tokens[:, :prompt]`` and one teacher-forced
    ``decode_step`` per remaining token: the logits of positions
    prompt-1 .. end, (B, steps + 1, V) float32."""
    import torch

    from repro_torch.models import serving
    logits, cache = serving.prefill(lm, params, tokens[:, :prompt],
                                    max_seq=tokens.shape[1])
    out = [logits]
    for i in range(prompt, tokens.shape[1]):
        logits, cache = serving.decode_step(lm, params, tokens[:, i], i,
                                            cache)
        out.append(logits)
    return torch.stack(out, 1).float()


def forward_readings(lm, tokens, prompt: int, got, full) -> dict:
    """Free-running decode logits ``got`` against ``LM.forward``'s
    ``full`` (positions prompt-1 ..), / max |logit|: the largest, and
    step 0's (``prefill``'s logits, no decode step); and the forward
    over the prompt alone against ``full`` at the prompt's last position
    (the forward against itself at another sequence length)."""
    import torch
    with torch.no_grad():
        short = lm(tokens[:, :prompt])[0][:, -1].float()
    scale = float(full.abs().max())
    per = ((got - full).abs().amax(dim=(0, 2)) / scale).tolist()
    return {"free_running": max(per), "step0": per[0],
            "forward_prompt_only": float((short - full[:, 0]).abs().max())
            / scale, "max_abs_logit": scale}


def serve_f32(lm, tokens, prompt: int, device) -> dict:
    """:func:`forward_readings` at float32 compute (TF32 off, as in
    phase 9): ``lm``'s parameters in an LM of the same config computing
    in float32, free-running against its ``LM.forward`` over all of
    ``tokens``. Printed, not held (PERF.md section 5)."""
    import dataclasses
    import torch

    from repro_torch.models.transformer import LM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm32 = LM(dataclasses.replace(lm.cfg, compute_dtype="float32"),
              device=device)
    lm32.load_param_tree(lm.param_tree())
    with torch.no_grad():
        got = free_running(lm32, lm32.param_tree(), tokens, prompt)
        full = lm32(tokens)[0][:, prompt - 1:].float()
    if not (torch.isfinite(got).all() and torch.isfinite(full).all()):
        raise AssertionError(f"serve f32 {lm.cfg.name}: non-finite logits")
    return forward_readings(lm32, tokens, prompt, got, full)


def serve_decode(lm, params, tokens, prompt: int, device) -> dict:
    """Prefill ``tokens[:, :prompt]`` (twice: the second timed warm),
    then one ``decode_step`` per remaining token, teacher-forced, at the
    config's bf16 compute. Held: :func:`teacher_forced` against the
    forward, every layer and the head within SERVE_TOL. Printed: the
    free-running logits against ``LM.forward`` over all of ``tokens``
    (:func:`forward_readings`, also at float32 by :func:`serve_f32`),
    and the forward's own sensitivity to one rounding of its input: the
    forward from the embeddings moved by a relative 2^-7 (one to two
    bf16 ulps) up or down at random, max |its logits - the forward's| /
    max |the forward's| over the decoded positions."""
    import torch

    from repro_torch.models import serving
    from repro_torch.models.transformer import tree_leaves
    b, total = tokens.shape
    steps = total - prompt
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    prefill_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        logits, cache = serving.prefill(lm, params, tokens[:, :prompt],
                                        max_seq=total)
        torch.cuda.synchronize(device)
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
    out = [logits]
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = serving.decode_step(lm, params, tokens[:, prompt + i],
                                            prompt + i, cache)
        out.append(logits)
    torch.cuda.synchronize(device)
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    got = torch.stack(out, 1).float()
    cache_bytes = _nbytes(*(t for _, t in tree_leaves(cache)))
    del cache, out
    seen, full = forward_walk(lm, tokens, prompt)
    if not (torch.isfinite(got).all() and torch.isfinite(full).all()):
        raise AssertionError(f"serve {lm.cfg.name}: non-finite logits")
    readings = forward_readings(lm, tokens, prompt, got, full)
    del got
    forced = teacher_forced(lm, params, tokens, prompt, seen, full)
    del seen
    if not max(forced["layer_errs"] + [forced["head_err"]]) < SERVE_TOL:
        raise AssertionError(f"serve {lm.cfg.name} B={b} prompt={prompt}: "
                             f"teacher-forced decode against the forward, "
                             f"by layer {forced['layer_errs']}, head "
                             f"{forced['head_err']}, not all < {SERVE_TOL}")

    def rounded(x):
        up = torch.rand(x.shape, device=device, generator=torch.Generator(
            device=device).manual_seed(7)) < 0.5
        return (x.float() * torch.where(up, 1 + 2 ** -7, 1 - 2 ** -7)).to(
            x.dtype)
    _, moved = forward_walk(lm, tokens, prompt, embed=rounded)
    spread = float((moved - full).abs().max() / full.abs().max())
    del moved, full
    return {"batch": b, "prompt": prompt, "steps": steps,
            "prefill_ms": prefill_ms[1], "prefill_cold_ms": prefill_ms[0],
            "decode_ms_per_token": 1e3 * decode_s / steps,
            "tokens_per_s": steps * b / decode_s,
            "cache_bytes": cache_bytes, "peak_bytes": peak,
            "max_layer_err": max(forced["layer_errs"]),
            "layer_errs": forced["layer_errs"],
            "head_err": forced["head_err"], **readings,
            "forward_ulp_spread": spread,
            "f32": serve_f32(lm, tokens, prompt, device)}


def serve_full(arch: str, device, card: str, seed: int) -> dict:
    """Phase 11(b) for one config: parameters drawn on the card from a
    seeded generator, SERVE_BATCH x SERVE_PROMPT prompt tokens and
    SERVE_STEPS decode steps; recurrentgemma also the ring case, its
    forward in one query block (2,040 and 2,072 are not multiples of its
    ``attn_chunk`` of 1,024; the chunks split only the queries)."""
    import dataclasses
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM
    cfg = get_config(arch)
    runs = [(SERVE_BATCH, SERVE_PROMPT, cfg)]
    if cfg.window:
        runs.append((SERVE_RING_BATCH, SERVE_RING_PROMPT,
                     dataclasses.replace(cfg, attn_chunk=4096)))
    out = {"layers": cfg.n_layers, "runs": []}
    for b, prompt, c in runs:
        lm = LM(c, device=device)
        params = lm.init(torch.Generator(device=device).manual_seed(seed))
        g = torch.Generator(device=device).manual_seed(seed + 1)
        tokens = torch.randint(0, c.vocab_size, (b, prompt + SERVE_STEPS),
                               generator=g, device=device)
        r = serve_decode(lm, params, tokens, prompt, device)
        out["params"] = sum(p.numel() for p in lm.parameters())
        out["runs"].append(r)
        del lm, params, tokens
        torch.cuda.empty_cache()
        ring = (f", window {c.window}: the ring wraps at position "
                f"{c.window}") if c.window and prompt + SERVE_STEPS > \
            c.window else ""
        print(f"serve {cfg.name} ({cfg.n_layers} layers, {out['params']} "
              f"parameters, {c.compute_dtype} compute, uncut): B={b} "
              f"prompt {prompt} + {SERVE_STEPS} decode steps{ring}; prefill "
              f"{r['prefill_ms']!r} ms (first call {r['prefill_cold_ms']!r}); "
              f"decode {r['decode_ms_per_token']!r} ms a step, "
              f"{r['tokens_per_s']!r} tok/s; cache {r['cache_bytes']} bytes, "
              f"peak memory {r['peak_bytes']} bytes; prefill + decode_step "
              f"teacher-forced on the forward's layer inputs: max rel err "
              f"by layer {r['max_layer_err']!r}, head {r['head_err']!r} "
              f"(tol {SERVE_TOL}); printed: free-running logits against "
              f"LM.forward max {r['free_running']!r} (step 0, prefill "
              f"alone, {r['step0']!r}), the forward over the prompt alone "
              f"against it {r['forward_prompt_only']!r}, a relative 2^-7 "
              f"on the embeddings moves it by {r['forward_ulp_spread']!r}; "
              f"at float32 compute (TF32 off) free-running "
              f"{r['f32']['free_running']!r} (step 0 "
              f"{r['f32']['step0']!r}), the forward over the prompt alone "
              f"{r['f32']['forward_prompt_only']!r}; [{card}]")
    return out


def serve_phase(device, card: str) -> dict:
    """Phase 11 (see the module docstring)."""
    t0 = time.perf_counter()
    out = {"cli": serve_cli(device)}
    for i, arch in enumerate(SERVE_FULL):
        out[arch] = serve_full(arch, device, card, 110 + 10 * i)
    out["phase_s"] = time.perf_counter() - t0
    print(f"serving phase 11 took {out['phase_s']!r} s")
    return out


# ------------------- 12. sharding, the dry-run, the roofline and GPipe

#: phase 12(a)'s dry-run cells (full configs): (arch, shape, mesh flags),
#: one subprocess each
DRYRUN_CELLS = (("stablelm_1_6b", "train_4k", ["--mesh", "single"]),
                ("stablelm_1_6b", "train_4k", ["--mesh", "multi"]),
                ("mixtral_8x22b", "decode_32k", ["--mesh", "single"]))
MESH_ARCH = "stablelm_1_6b"    # phase 12(b)'s and (c)'s model, uncut
GPIPE_STAGES, GPIPE_MICRO = 4, 8


def dryrun_start(out: Path) -> list:
    """Start phase 12(a)'s dry-runs (and the (1, 1) cell of (b)) as
    subprocesses, all at once: a fake process group must not share a
    process with the NCCL group of (b)."""
    cmds = [[*c[:2], *c[2]] for c in DRYRUN_CELLS]
    cmds.append([MESH_ARCH, "train_4k", "--mesh-shape", "1,1", "--batch",
                 str(LM_BATCH), "--seq", str(LM_SEQ)])
    procs = []
    for i, (arch, shape, *flags) in enumerate(cmds):
        log = open(out / f"dryrun{i}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, *flags, "--out", str(out)],
            stdout=log, stderr=subprocess.STDOUT, env=_src_env(),
            cwd=ROOT)))
    return procs


def dryrun_finish(procs: list, out: Path, t0: float, card: str) -> dict:
    """Wait for the dry-runs, print every cell (argument bytes, peak,
    flops, collectives by type, the dominant term, the H100 bound)."""
    for log, proc in procs:
        try:
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
            log.close()
        if rc != 0:
            raise AssertionError(f"dryrun {proc.args} exited {rc}: "
                                 f"{Path(log.name).read_text()[-3000:]}")
    wall = time.perf_counter() - t0
    cells = {}
    for f in sorted(out.glob("*.json")):
        t = json.loads(f.read_text())
        cells[f.stem] = t
        coll = {k: v["count"] for k, v in t["collectives"].items()
                if v["count"]}
        print(f"dryrun {t['arch']} x {t['shape']} mesh={t['mesh']} "
              f"({t['kind']}, {t['chips']} devices, traced in "
              f"{t['trace_s']!r} s): argument bytes/device "
              f"{t['memory']['argument_bytes']}, peak "
              f"{t['memory']['peak_bytes']}, flops/device "
              f"{t['flops_per_device']!r} (model flops "
              f"{t['model_flops']!r}), bytes/device "
              f"{t['bytes_per_device']!r}, collectives {coll} "
              f"({t['collective_bytes_per_device']} bytes/device); "
              f"H100 roofline: compute {t['compute_s']!r} s, memory "
              f"{t['memory_s']!r} s, collective {t['collective_s']!r} s, "
              f"dominant {t['dominant']}, bound "
              f"{t['step_time_lower_bound_s']!r} s [{card}]")
    want = {f"{a}__{s}__{f[1]}" for a, s, f in DRYRUN_CELLS}
    want.add(f"{MESH_ARCH}__train_4k__1x1")
    if not want <= set(cells):
        raise AssertionError(f"dryrun cells {sorted(cells)}, want "
                             f"{sorted(want)}")
    print(f"dryrun phase 12(a): {len(cells)} cells, all ended "
          f"{wall!r} s after they started (beside (b) and (c)) [{card}]")
    return {"cells": cells, "wall_s": wall}


def mesh_step(device, card: str) -> dict:
    """Phase 12(b): three AdamW steps of the uncut stablelm-1.6b on a
    (1, 1) mesh of a real NCCL group of one rank, the train state placed
    by ``rules_for``, against the plain step from the same init: losses
    and updated parameters bitwise. Returns the plain parameters (for
    (c)) with the readings."""
    import socket
    import statistics
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch.rules import rules_for
    from repro_torch.models.transformer import LM, tree_leaves
    from repro_torch.train import optim, step
    cfg = get_config(MESH_ARCH)
    seed = 120

    def run(state, batch, train, place=None):
        losses, ms = [], []
        for _ in range(LM_STEPS):
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            if place is None:
                state, m = train(state, batch)
            else:
                with sharding.use_rules(*place):
                    state, m = train(state, batch)
            loss = m["loss"]
            losses.append((loss.full_tensor() if place else loss).clone())
            torch.cuda.synchronize(device)
            ms.append(1e3 * (time.perf_counter() - t1))
        return state, losses, ms

    def fresh():
        lm = LM(cfg, device=device)
        return lm, step.init_state(
            lm, torch.Generator(device=device).manual_seed(seed))
    lm, state = fresh()
    batch = lm_batch(cfg, LM_BATCH, LM_SEQ, device, seed + 1)
    opt = optim.OptConfig(warmup_steps=1)
    state, want, plain_ms = run(state, batch,
                                step.make_train_step(lm, opt))
    params = state["params"]
    del lm, state
    torch.cuda.empty_cache()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    cuda = device.type == "cuda"      # gloo on the CPU (a rehearsal)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=device if cuda else None)
    try:
        mesh = init_device_mesh(device.type, (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = rules_for(MESH_ARCH, "train_4k", multi_pod=False)
        torch.cuda.synchronize(device)
        before = torch.cuda.memory_allocated(device)
        lm2, state2 = fresh()
        batch2 = lm_batch(cfg, LM_BATCH, LM_SEQ, device, seed + 1)
        placed = sharding.tree_distribute(state2, step.state_axes(lm2),
                                          rules, mesh)
        pbatch = {k: sharding.distribute(v, ("batch", "seq"), rules, mesh)
                  for k, v in batch2.items()}
        del state2, batch2
        torch.cuda.synchronize(device)
        placed_bytes = torch.cuda.memory_allocated(device) - before
        kinds = sorted({str(t.placements) for _, t in
                        tree_leaves(placed["params"])})
        torch.cuda.reset_peak_memory_stats(device)
        placed, got, mesh_ms = run(
            placed, pbatch, step.make_train_step(lm2, opt), (rules, mesh))
        peak = torch.cuda.max_memory_allocated(device) - before
        same_loss = all(torch.equal(a, b) for a, b in zip(got, want))
        diff = [path for (path, a), (_, b) in zip(
            tree_leaves(params), tree_leaves(placed["params"]))
            if not torch.equal(a, b.full_tensor())]
        del lm2, placed, pbatch
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out = {"losses": [float(x) for x in want],
           "mesh_losses": [float(x) for x in got], "plain_ms": plain_ms,
           "mesh_ms": mesh_ms,
           "plain_ms_median_2_3": statistics.median(plain_ms[1:]),
           "mesh_ms_median_2_3": statistics.median(mesh_ms[1:]),
           "placed_bytes": placed_bytes, "peak_bytes": peak,
           "placements": kinds,
           "params_differ": diff}
    print(f"mesh step {cfg.name} ({cfg.n_layers} layers, B={LM_BATCH} "
          f"S={LM_SEQ}) on a (1, 1) NCCL mesh, state placed by "
          f"rules_for (placements {kinds}): losses {out['mesh_losses']!r} "
          f"against the plain step's {out['losses']!r} (bitwise "
          f"{same_loss}), parameters differing {len(diff)} "
          f"{diff[:4]}; step ms {mesh_ms!r} (median of 2-3 "
          f"{out['mesh_ms_median_2_3']!r}) against the plain step's "
          f"{plain_ms!r} ({out['plain_ms_median_2_3']!r}); "
          f"memory_allocated by the placed state and batch {placed_bytes} "
          f"bytes [{card}]")
    if not same_loss or diff:
        raise AssertionError(f"mesh step: losses {out['mesh_losses']} vs "
                             f"{out['losses']}, {len(diff)} parameters "
                             f"differ: {diff[:8]}")
    return out, params


def gpipe_phase(params, device, card: str) -> dict:
    """Phase 12(c): the uncut stablelm-1.6b blocks as GPIPE_STAGES stages
    of 6 layers on ``[device] * 4``, GPIPE_MICRO microbatches of 1 x
    LM_SEQ bf16 activations, against the sequential forward, bitwise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import pipeline
    from repro_torch.models import layers
    from repro_torch.models.transformer import LM, _unstack
    cfg = get_config(MESH_ARCH)
    lm = LM(cfg, device="meta")     # the block code; no parameters
    positions = torch.arange(LM_SEQ, dtype=torch.int32,
                             device=device)[None, :]

    def stage_fn(p, x):
        for lp in _unstack(p):
            x = lm._apply_block("attn", lp, x, positions)[0]
        return x
    g = torch.Generator(device=device).manual_seed(130)
    x = torch.randn((GPIPE_MICRO, 1, LM_SEQ, cfg.d_model), generator=g,
                    device=device).to(layers.dtype_of(cfg.compute_dtype))
    stages = pipeline.stack_stages(params["blocks"], GPIPE_STAGES)
    out = {}
    with torch.no_grad():
        for name, fn in (
                ("sequential", lambda: pipeline.sequential_forward(
                    stage_fn, stages, x, GPIPE_STAGES)),
                ("gpipe", lambda: pipeline.gpipe_forward(
                    stage_fn, stages, x, devices=[device] * GPIPE_STAGES)),
                ("gpipe_again", lambda: pipeline.gpipe_forward(
                    stage_fn, stages, x, devices=[device] * GPIPE_STAGES))):
            torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            out[name] = fn()
            torch.cuda.synchronize(device)
            out[name + "_ms"] = 1e3 * (time.perf_counter() - t1)
    same = torch.equal(out["gpipe"], out["sequential"]) and \
        torch.equal(out["gpipe_again"], out["sequential"])
    finite = bool(torch.isfinite(out["gpipe"]).all())
    ticks = len(pipeline.schedule(GPIPE_MICRO, GPIPE_STAGES))
    bubble = pipeline.bubble_fraction(GPIPE_MICRO, GPIPE_STAGES)
    res = {"ticks": ticks, "bubble": bubble, "bitwise": same,
           **{k: v for k, v in out.items() if k.endswith("_ms")}}
    print(f"gpipe {cfg.name} blocks: {GPIPE_STAGES} stages x "
          f"{cfg.n_layers // GPIPE_STAGES} layers on [{device}] * "
          f"{GPIPE_STAGES}, {GPIPE_MICRO} microbatches of (1, {LM_SEQ}, "
          f"{cfg.d_model}) {cfg.compute_dtype}: {ticks} ticks, bubble "
          f"{bubble!r}; bitwise the sequential forward {same}, finite "
          f"{finite}; walls: sequential {res['sequential_ms']!r} ms, "
          f"gpipe {res['gpipe_ms']!r} / {res['gpipe_again_ms']!r} ms "
          f"[{card}]")
    if not (same and finite) or ticks != GPIPE_MICRO + GPIPE_STAGES - 1:
        raise AssertionError(f"gpipe: bitwise {same}, finite {finite}, "
                             f"{ticks} ticks")
    return res


def mesh_phase(tmp: Path, device, card: str) -> dict:
    """Phase 12 (see the module docstring)."""
    t0 = time.perf_counter()
    procs = dryrun_start(tmp)
    try:
        step_out, params = mesh_step(device, card)
        gpipe = gpipe_phase(params, device, card)
        del params
    except BaseException:
        for log, proc in procs:
            proc.kill()
            proc.wait()
            log.close()
        raise
    dry = dryrun_finish(procs, tmp, t0, card)
    one = dry["cells"][f"{MESH_ARCH}__train_4k__1x1"]
    bound_ms = 1e3 * one["step_time_lower_bound_s"]
    args = one["memory"]["argument_bytes"]
    print(f"mesh step against the dry-run's (1, 1) cell: argument bytes "
          f"{args} predicted, {step_out['placed_bytes']} allocated "
          f"({step_out['placed_bytes'] / args!r} of it); peak bytes "
          f"{one['memory']['peak_bytes']} predicted (the dry-run's eager "
          f"count, arguments included), {step_out['peak_bytes']} "
          f"allocated at the most over the three steps "
          f"({step_out['peak_bytes'] / one['memory']['peak_bytes']!r} of "
          f"it); traced flops "
          f"{one['flops_per_device']!r} a step against model flops "
          f"{one['model_flops']!r} ({one['useful_flops_ratio']!r}), by "
          f"dtype {one['flops_by_dtype']!r}; H100 "
          f"roofline bound {bound_ms!r} ms ({one['dominant']}) against the "
          f"measured step {step_out['mesh_ms_median_2_3']!r} ms [{card}]")
    if bound_ms > step_out["mesh_ms_median_2_3"]:
        raise AssertionError(f"roofline bound {bound_ms} ms above the "
                             f"measured {step_out['mesh_ms_median_2_3']} ms")
    out = {"dryrun": dry, "mesh_step": step_out, "gpipe": gpipe,
           "bound_ms": bound_ms, "phase_s": time.perf_counter() - t0}
    print(f"mesh phase 12 took {out['phase_s']!r} s [{card}]")
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
    host time (the profiler's own cost included). A trace with no device
    time is taken once more."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):         # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = {e.key[:48]: e.self_device_time_total / calls / 1e3
                  for e in events if e.self_device_time_total > 0}
        if device:
            break
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


def carry_bounds(tables: list, resolution: int) -> dict:
    """Least time of one B4/B5 call (float64 or, for float32 tables,
    B4-f32/B5-f32), the mean over ``tables`` (the mesh path's one call a
    shard: the shard's table alone): each table's :func:`raster_work`
    plus its seed, read once — B4's (image, depth) seed and outputs are
    (2v + 8)·R² bytes, B5's 2v·R², for v-byte values."""
    px2 = resolution * resolution
    vb = tables[0]["values"].element_size()
    fx, kind = ("", "f64") if vb == 8 else ("_f32", "f32")
    sums = {"slice_raster_carry" + fx: [0, 0],
            "projection_raster_carry" + fx: [0, 0]}
    for x in tables:
        w = raster_work(x, resolution)
        for name, work, seed in (("slice_raster_carry", "slice",
                                  (vb + 8) * px2),
                                 ("projection_raster_carry", "projection",
                                  vb * px2)):
            sums[name + fx][0] += w[work][0] + seed
            sums[name + fx][1] += w[work][1]
    return {name: dict(_bound(nb // len(tables), ops // len(tables), kind),
                       calls=len(tables))
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


def mesh_shard_table(arrays: dict, device, n_shards: int = 1, dtype=None):
    """``MeshTable``'s shards of the Orion table on ``device`` as the mesh
    path uploads them (``dtype="float32"``: the float32 table), each a
    dict with the columns ``kernels.ops`` and the wrappers take."""
    from repro_torch.insitu.mesh_reduce import MeshTable
    from repro_torch.kernels import ops
    mt = MeshTable(arrays, 1, [device] * n_shards, dtype=dtype)
    return [{"coords": c, "coords2": ops.plane_coords(c, 2),
             "c_axis": c[:, 2], "levels": lv, "values": v, "ok": ok,
             "n_levels": mt.n_levels}
            for c, lv, v, ok in mt.shards("density")]


def cut_rows(x: dict, a: int, b: int) -> dict:
    """Rows [a, b) of table ``x``."""
    return {k: (v if k == "n_levels" else v[a:b]) for k, v in x.items()}


def check_shard_chain(arrays: dict, device) -> dict:
    """The mesh path's carry chain at its real shapes: every Orion shard
    at S = 1 and ``MESH_SHARDS``, float64 and float32 (the tables
    ``MeshTable`` uploads), through ``kernels.ops``' one call (B4, B5 and
    their float32 kernels, one launch a shard) against the twins' chain
    over ``MESH_TILE``-row tiles on the card, bitwise (image and depth);
    then the S = 1 shard with ``raster.MAX_ROWS`` cut to five tiles and
    seven rows, so ``ops._run_shard`` chains calls of whole tiles: the
    same bits, one launch a call. Returns the max abs error per kernel
    (0.0)."""
    import torch

    from repro_torch.insitu.mesh_reduce import MESH_TILE
    from repro_torch.kernels import raster
    geo = dict(resolution=LIVE_RESOLUTION, tile_n=MESH_TILE)
    errs = {}
    for n_shards in (1, MESH_SHARDS):
        for dtype in (None, "float32"):
            fx = "_f32" if dtype else ""
            shards = mesh_shard_table(arrays, device, n_shards, dtype)
            for g, x in enumerate(shards):
                for kind in ("slice", "projection"):
                    name = f"{kind}_raster_carry{fx}"
                    label = f"orion shard {g}/{n_shards} {dtype or 'float64'}"
                    twin = carry_chain(x, kind, "ref", **geo)
                    before = dict(raster.LAUNCHES)
                    got = carry_chain(x, kind, None, **geo)
                    torch.cuda.synchronize()
                    _check_launched(before, {name: 1}, f"{label}: {name}")
                    errs[name] = max(errs.get(name, 0.0), _same_bits(
                        f"{label}: {name} in one call", got, twin))
                    if n_shards > 1:
                        continue
                    limit, raster.MAX_ROWS = raster.MAX_ROWS, \
                        5 * MESH_TILE + 7
                    try:
                        before = dict(raster.LAUNCHES)
                        cut = carry_chain(x, kind, None, **geo)
                        torch.cuda.synchronize()
                    finally:
                        raster.MAX_ROWS = limit
                    calls = -(-x["values"].shape[0] // (5 * MESH_TILE))
                    _check_launched(before, {name: calls},
                                    f"{label}: {name} cut")
                    _same_bits(f"{label}: {name} in {calls} calls of 5 "
                               f"tiles", cut, twin)
            print(f"parity orion mesh chain S={n_shards} "
                  f"{dtype or 'float64'}: B4{fx.replace('_', '-')} and "
                  f"B5{fx.replace('_', '-')} in one call a "
                  f"shard bit-equal to the twins' {MESH_TILE}-row chain "
                  f"(image and depth), shard rows "
                  f"{[x['values'].shape[0] for x in shards]}"
                  + ("; cut at 5 tiles by the row limit: the same bits"
                     if n_shards == 1 else ""))
    return errs


def time_carries(arrays: dict, device, dtype=None) -> tuple:
    """B4/B5 at the mesh path's shapes (``dtype="float32"``: B4-f32/B5-f32
    on the float32 table), the one-shard Orion table: the wrapper alone
    in one call over the shard (``ms``, CUDA events; ``shard``: with its
    host and device time and the device split by kernel, B5's five
    steps), ``kernels.ops``' one call with its column prep (``ops_ms``),
    the twins' chain over the shard (``plain_ms``), and in the same run
    the old chain of one call per ``MESH_TILE``-row tile through ``ops``'
    cut (:func:`tile_chain`, ``tile_chain_ms``) and of the wrapper alone
    over the pre-cut tiles (``per_tile``); the bound of one shard call."""
    from repro_torch.insitu.mesh_reduce import MESH_TILE
    (shard,) = mesh_shard_table(arrays, device, 1, dtype)
    fx = "_f32" if dtype else ""
    n = shard["values"].shape[0]
    tiles = [cut_rows(shard, a, a + MESH_TILE) for a in range(0, n, MESH_TILE)]
    geo = dict(resolution=LIVE_RESOLUTION, tile_n=MESH_TILE)
    out = {}
    for kind, name in (("slice", "slice_raster_carry" + fx),
                       ("projection", "projection_raster_carry" + fx)):
        one = time_ms(lambda: carry_chain(shard, kind, None, **geo), reps=20)
        chain = time_ms(lambda: tile_chain(shard, kind, **geo), reps=5)
        plain = time_ms(lambda: carry_chain(shard, kind, "ref", **geo),
                        reps=1, warm=1)
        out[name] = {"ops_ms": one, "plain_ms": plain,
                     "tile_chain_ms": chain, "tiles": len(tiles)}
    out["slice_raster_carry" + fx].update(
        shard=slice_carry_calls([shard], device),
        per_tile=slice_carry_calls(tiles, device))
    out["projection_raster_carry" + fx].update(
        shard=projection_calls([shard], device, carry=True,
                               tile_n=MESH_TILE),
        per_tile=projection_calls(tiles, device, carry=True))
    for t in out.values():
        t["ms"] = t["shard"]["wrapper_ms"]
    return out, carry_bounds([shard], LIVE_RESOLUTION)


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
    (a carry over a shard, or chained over its pre-cut tiles with no
    ``_run_tiles`` slicing): ms
    per call with CUDA events, the host's own ms per call (a loop with no
    sync, then one sync), and the device ms per call by kernel and the
    host account from ``torch.profiler``."""
    wrapper_ms = time_ms(chain, reps=reps) / n_calls
    host_ms = host_us(chain, reps) / 1e3 / n_calls
    split, host_split = profiled(chain, reps * n_calls, reps)
    return {"wrapper_ms": wrapper_ms, "host_ms": host_ms,
            "device_ms": sum(split.values()) if split else None,
            "device_split_ms": split, "profiled_host_ms": host_split}


def slice_carry_calls(tables: list, device, reps: int = 20) -> dict:
    """B4's wrapper alone, one call a table chained over ``tables`` (the
    shard alone, or its pre-cut tiles; :func:`wrapper_calls`; device
    split: paint, resolve) and its host steps on the first table."""
    import torch

    from repro_torch.kernels import raster
    r = LIVE_RESOLUTION
    seed = (torch.full((r, r), float("nan"), dtype=tables[0]["values"].dtype,
                       device=device),
            torch.full((r, r), -1, dtype=torch.int32, device=device))

    def chain():
        carry = seed
        for t in tables:
            carry = raster.slice_raster_carry(
                t["coords2"], t["c_axis"], t["levels"], t["values"], t["ok"],
                position=0.5, resolution=r, n_levels=t["n_levels"],
                init=carry)
        return carry

    return {**wrapper_calls(chain, len(tables), reps),
            "host_steps_us": slice_carry_steps(tables[0], seed)}


def projection_calls(tables: list, device, *, carry: bool,
                     tile_n: int | None = None, reps: int = 20) -> dict:
    """B5's wrapper alone, one call a table chained over ``tables`` (the
    shard alone with the chain's ``tile_n``, or its pre-cut tiles;
    ``carry``), or B2's on the one table in ``tables``
    (:func:`wrapper_calls`; device split: key and count, scan, place,
    order, projection), its host steps, and the longest (level, cell)
    segment of the tables."""
    import torch

    from repro_torch.kernels import raster
    r = LIVE_RESOLUTION
    seed = torch.zeros((r, r), dtype=tables[0]["values"].dtype,
                       device=device)

    def cols(t):
        return t["coords2"], t["levels"], t["values"], t["ok"]

    def chain():
        img = seed
        for t in tables:
            img = raster.projection_raster_carry(
                *cols(t), resolution=r, n_levels=t["n_levels"], init=img,
                tile_n=tile_n) \
                if carry else raster.projection_raster(
                    *cols(t), resolution=r, n_levels=t["n_levels"])
        return img

    return {**wrapper_calls(chain, len(tables), reps),
            "host_steps_us": projection_steps(tables[0],
                                              seed if carry else None,
                                              tile_n),
            "longest_segment": max(longest_segment(
                t["coords2"], t["levels"], t["ok"], resolution=r,
                n_levels=t["n_levels"]) for t in tables)}


def projection_steps(t: dict, seed, tile_n: int | None = None) -> dict:
    """Host µs per call of each step of B5's wrapper (``seed`` the carry,
    ``tile_n`` the chain's tile rows) or B2's (``seed`` None), alone, on
    one table: the device and seed checks, the casts (none: the columns
    come in their dtypes), the scratch lookup, the one output
    allocation, the ctypes call with its five launches, and the whole
    wrapper."""
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
            *((seeds[0].data_ptr(), tile_n or 0) if seeds else ()),
            img.data_ptr())
    cudalib.lib()
    entry = cudalib._FNS["raster_projection_carry" + raster._SUFFIX[vd]
                         if seeds else "raster_projection_f64"]
    stream = cudalib.current_stream(i)
    wrapper = (lambda: raster.projection_raster_carry(
        *cols, resolution=r, n_levels=L, init=seed, tile_n=tile_n)) \
        if seeds else \
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
    """Host µs per call of each step of B4's wrapper, alone, on one table:
    the device and seed checks, one output allocation (it makes two),
    the ctypes call with its two launches, and the whole wrapper."""
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
    steps = {
        "checks": lambda: (cudalib.device_index(*cols, *seed),
                           raster._seed(seed, r, (vd, torch.int32))),
        "one allocation": lambda: torch.empty_like(seed[0]),
        "ctypes call and launches": lambda: entry(*args, i, stream),
        "whole wrapper": lambda: raster.slice_raster_carry(
            *cols, position=0.5, resolution=r, n_levels=t["n_levels"],
            init=seed),
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

def print_carry(name: str, t: dict, b: dict) -> None:
    """One line of :func:`time_carries`' numbers for B4/B5 (or -f32): the
    one call a shard beside the old chain of per-tile calls."""
    sh, pt = t["shard"], t["per_tile"]
    n = t["tiles"]
    print(f"time {name} per shard call (one-shard Orion table): wrapper "
          f"alone {sh['wrapper_ms']!r} ms (CUDA events), through "
          f"kernels.ops with its column prep {t['ops_ms']!r} ms; wrapper "
          f"host {sh['host_ms']!r} ms, device "
          f"{sh['device_ms']!r} ms {sh['device_split_ms']!r}; host us per "
          f"call of each step {sh['host_steps_us']!r}"
          + (f"; longest cell segment {sh['longest_segment']} rows"
             if "longest_segment" in sh else ""))
    print(f"time {name} old chain of {n} per-tile calls ({n} x "
          f"MESH_TILE rows, same run): {t['tile_chain_ms']!r} ms (CUDA "
          f"events); wrapper alone {pt['wrapper_ms']!r} ms a tile "
          f"({pt['wrapper_ms'] * n!r} a chain), host {pt['host_ms']!r} ms "
          f"a tile, device {pt['device_ms']!r} ms a tile "
          f"({(pt['device_ms'] or 0.0) * n!r} a chain) "
          f"{pt['device_split_ms']!r}; plain twins' chain "
          f"{t['plain_ms']!r} ms; bound of one shard call "
          f"{b['bound_ms']!r} ms by {b['bound_by']} ({b['bytes']} bytes, "
          f"{b['ops']} {b['ops_type']} ops)")


def projection_kernel_split(carries: dict) -> dict:
    """``projection_kernel``'s device ms a call, float32 and float64, in
    one shard call and in one tile call of the old chain."""
    out = {}
    for fx, dt in (("", "double"), ("_f32", "float")):
        t = carries["projection_raster_carry" + fx]
        for where in ("shard", "per_tile"):
            split = t[where]["device_split_ms"]
            out[f"{dt} {where}"] = next(
                (v for k, v in split.items()
                 if f"projection_kernel<{dt[:2]}" in k), None)
    return out


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
    for name, err in check_shard_chain(tree.to_arrays(), device).items():
        errs[name] = max(errs[name], err)
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
    b1, b3, b6, b7 = (times[k] for k in ("slice_raster", "level_hist",
                                         "encode_groups", "decode_groups"))
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
    print(f"time decode_groups: wrapper {b7['ms']!r} ms a call (CUDA "
          f"events), host {b7['host_ms']!r} ms a call, device "
          f"{b7['device_ms']!r} ms; library torch.bitwise_xor "
          f"{b7['library_ms']!r} ms")
    b2 = times["projection_raster"]
    print(f"time projection_raster wrapper alone on the Orion table: "
          f"{b2['wrapper_ms']!r} ms a call (CUDA events), host "
          f"{b2['host_ms']!r} ms a call, device {b2['device_ms']!r} ms a "
          f"call {b2['device_split_ms']!r}; longest cell segment "
          f"{b2['longest_segment']} rows, of the adversarial tables "
          f"{table_segment}")
    print(f"time host us per call of each step: projection_raster "
          f"{b2['host_steps_us']!r}; decode_groups {b7['host_steps_us']!r}")
    carries = {name: times[name] for name in (
        "slice_raster_carry", "projection_raster_carry",
        "slice_raster_carry_f32", "projection_raster_carry_f32")}
    for name, t in carries.items():
        print_carry(name, t, bnd[name])
    wall["projection_kernel_ms"] = projection_kernel_split(carries)
    print(f"time projection_kernel float32 against float64 (device ms a "
          f"call, torch.profiler): {wall['projection_kernel_ms']!r}")
    f32 = {name: times[name] for name in ("level_hist_f32",)}
    for name, t in f32.items():
        print(f"time {name} wrapper alone on the one-shard float32 table: "
              f"{t['wrapper_ms']!r} ms a call (CUDA events), host "
              f"{t['host_ms']!r} ms a call, device {t['device_ms']!r} ms a "
              f"call {t['device_split_ms']!r}; host us per call of each "
              f"step {t['host_steps_us']!r}")
    wall["wrapper_calls"] = {"slice_raster": b1, "level_hist": b3,
                             "encode_groups": b6,
                             "projection_raster": b2,
                             "decode_groups": b7, **carries, **f32}
    for name in ("slice_raster_carry", "projection_raster_carry"):
        launches[name] = mesh_launches[name]     # the mesh path's (S=1)
    launches.update({k: v for k, v in               # the float32 path's
                     wall["mesh_f32"][1]["float32"]["launches"].items()
                     if k.endswith("_f32")})
    launches.update(wall["codec"]["launches"])   # one Orion snapshot's

    # -- 9. the LM stack (no kernel of B1-B9 on its path)
    wall["lm"] = lm_phase(device, card)
    # -- 10. the trainer on the card; 11. LM serving (no kernel of B1-B9)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=ROOT / "build") as d:
        wall["trainer"] = trainer_phase(Path(d), device, card)
    wall["serve_lm"] = serve_phase(device, card)
    # -- 12. sharding, the dry-run, the roofline and GPipe (no kernel)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     dir=ROOT / "build") as d:
        wall["mesh_lm"] = mesh_phase(Path(d), device, card)
    records = []
    for name, (replaces, source) in KERNELS.items():
        t, b = times[name], bnd[name]
        per = "per shard call (the one-shard Orion table), " \
            if "calls" in b else ""
        where = "per Orion codec snapshot" if source == CODEC_SRC else \
            f"on the main path over {wall['steps']} steps"
        lib_ms = t.get("library_ms")
        if "device_ms" in t or "shard" in t:
            dev_ms = t["device_ms"] if "device_ms" in t else \
                t["shard"]["device_ms"]
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
