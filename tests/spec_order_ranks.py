"""One rank of a four-rank gloo run on a (2, 2, 1) ("pod", "data",
"model") mesh, where ``fsdp: ("data", "pod")`` names its two axes
against the mesh's order (nemotron, mixtral and llava under
``rules_for(..., multi_pod=True)``).

    python tests/spec_order_ranks.py RANK PORT OFFSETS.json ARCH[,ARCH...]

``OFFSETS.json`` maps arch -> parameter path -> "p,d,m" (a mesh
coordinate) -> [[start, stop], ...] per dim: the piece the reference's
``PartitionSpec`` gives that device. For each arch's smoke config at
float32 compute, the rank checks that every leaf of the placed train
state (parameters and both moments) holds exactly the plain state's
values at its coordinate's offsets (mixtral in two dispatch groups,
``CASES``), then takes the grads and three
AdamW steps of the placed state and of the plain one from the same
init and batch, and prints ``RESULT {json}``: the pieces checked and
mismatched, the losses of both runs, and the worst relative norm of a
leaf's piece against the plain leaf's at the same offsets (the first
step's grads, the parameters after it). The test and ``chip_smoke.py``
run it; it makes no JAX call.
"""
import contextlib
import dataclasses
import json
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.rules import rules_for  # noqa: E402
from repro_torch.models.transformer import LM, tree_leaves  # noqa: E402
from repro_torch.train import optim, step  # noqa: E402


def main(rank: int, port: str, offsets_path: str, archs: str) -> None:
    with open(offsets_path) as f:
        offsets = json.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 1),
                                mesh_dim_names=("pod", "data", "model"))
        coord = ",".join(str(c) for c in mesh.get_coordinate())
        out = {"coord": coord}
        for arch in archs.split(","):
            out[arch] = run_arch(arch, mesh, coord, offsets[arch])
        print("RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def _at(full, box):
    for d, (lo, hi) in enumerate(box):
        full = full.narrow(d, lo, hi - lo)
    return full


def _local(t):
    """A DTensor's piece, its partial sums reduced first."""
    from torch.distributed.tensor import Replicate
    if any(q.is_partial() for q in t.placements):
        t = t.redistribute(t.device_mesh, [Replicate() if q.is_partial()
                                           else q for q in t.placements])
    return t.to_local()


def _worst(placed: dict, plain: dict, boxes: dict):
    """(largest |piece - plain piece| / |plain piece|, its path)."""
    return max((float((_local(placed[k]) - _at(plain[k], boxes[k][0]))
                      .norm() / max(float(_at(plain[k], boxes[k][0]).norm()),
                                    1e-30)), k) for k in boxes)


# mixtral in two dispatch groups (2,048 tokens), which the four-way batch
# split does not divide: its tokens move to the groups' split and back
# (``sharding.regroup``: an all-gather over "data", an all-to-all over
# "pod")
CASES = {"mixtral_8x22b": ({"moe_groups": 2}, 256)}


def run_arch(arch: str, mesh, coord: str, offsets: dict) -> dict:
    over, seq = CASES.get(arch, ({}, 32))
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32",
                              **over)
    rules = rules_for(arch, "train_4k", multi_pod=True)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (8, seq), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    states, grads, params1, losses = [], [], [], []
    for placed in (False, True):
        lm = LM(cfg, device="cpu")
        st = step.init_state(lm, torch.Generator().manual_seed(3))
        b = batch
        if placed:
            st = sharding.tree_distribute(st, step.state_axes(lm), rules,
                                          mesh)
            b = {k: sharding.distribute(v, ("batch", "seq"), rules, mesh)
                 for k, v in batch.items()}
        # copies: AdamW below updates the state in place
        states.append({k: v.clone() for k, v in tree_leaves(
            {k: st[k] for k in ("params", "mu", "nu")})})

        def ctx():
            return sharding.use_rules(rules, mesh) if placed else \
                contextlib.nullcontext()
        with ctx():
            _, g = step.loss_and_grads(lm, st["params"], b)
        grads.append(dict(tree_leaves(g)))
        train = step.make_train_step(lm, optim.OptConfig(warmup_steps=1))
        run = []
        for i in range(3):
            with ctx():
                st, m = train(st, b)
            loss = m["loss"]
            run.append(float(loss.full_tensor() if placed else loss))
            if i == 0:
                params1.append({k: v.clone()
                                for k, v in tree_leaves(st["params"])})
        losses.append(run)
    plain, placed = states
    boxes = {}
    for path in placed:
        name = path.split(".", 1)[1]
        boxes[path] = (offsets[name][coord],)
    pieces = mismatched = strided = 0
    for path, t in placed.items():
        box = boxes[path][0]
        want = _at(plain[path], box)
        pieces += 1
        strided += any(sharding._strided(q) for q in t.placements)
        if tuple(t.to_local().shape) != tuple(want.shape) or \
                not torch.equal(t.to_local(), want):
            mismatched += 1
    pboxes = {k: (offsets[k][coord],) for k in offsets}
    return {"pieces": pieces, "mismatched": mismatched, "strided": strided,
            "losses": losses,
            "grads": _worst(grads[1], grads[0], pboxes),
            "params": _worst(params1[1], params1[0], pboxes)}


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
