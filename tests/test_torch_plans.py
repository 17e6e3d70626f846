"""Every collective of a sharded step is one the port names.

DTensor plans a move itself wherever an op meets operands it must lay
out again (``_dispatch``), where ``DTensor.redistribute`` or a
``local_map`` moves its inputs, and in their backward (``_redistribute``,
``from_local``'s backward). Its planner differs between torch versions,
so a collective issued there made the dry-run's counts depend on the
version (torch 2.11 on the card host, 2.13 here). The port moves data
only by its own calls: ``sharding.move``/``layout``/``per_rank``/
``reduce_to``/``gather``/``regroup`` and explicit ``_c10d_functional``
collectives. Here each family's step runs at its smoke config on a fake
mesh, and no collective may come from inside DTensor's planner.

:func:`dtensor_moves` is the site recorder for a full cell too
(:func:`map_cell`): ``python tests/test_torch_plans.py --out DIR``
maps every dry-run pair (its collectives by type, peak, and the moves
DTensor planned, each with its innermost ``repro_torch`` frame) into
one JSON file a pair; diff two torch versions' files by site. No JAX
here: the file runs on the card host's CPU as well (``python -m pytest
tests/test_torch_plans.py``).
"""
import collections
import contextlib
import math
import os
import traceback

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun, rules
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.specs import build_callable

_ROOT = os.sep + "repro_torch" + os.sep


def _site() -> str:
    """The innermost ``repro_torch`` frame of the stack, as file:line."""
    for f in reversed(traceback.extract_stack()):
        if _ROOT in f.filename:
            return f"{f.filename.split(_ROOT)[1]}:{f.lineno}"
    return "?"


class _Collectives(TorchDispatchMode):
    """Each collective a rank runs while ``inside`` is set, as (the move
    that issued it, the collective's name)."""

    def __init__(self):
        super().__init__()
        self.inside, self.seen = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if dryrun._is_dtensor_op(types):
            return NotImplemented
        name = func._schema.name.split("::")[-1]
        if self.inside and func.namespace in ("_c10d_functional",
                                              "_dtensor") and \
                name in dryrun._C10D:
            self.seen.append((self.inside[-1], name))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def dtensor_moves():
    """Record DTensor's own moves while the block runs: yields a
    ``Counter`` of (hook, site, from placements, to placements) -> calls,
    and after the block, ``counter.collectives``, the collectives issued
    inside those moves by (move, name). The hooks are
    ``redistribute_local_tensor`` as ``_dispatch`` (an op's operands),
    ``_api`` (``from_local``'s backward) and ``_redistribute``
    (``DTensor.redistribute`` and its backward) call it."""
    from torch.distributed.tensor import _api, _dispatch, _redistribute
    moves = collections.Counter()
    mode = _Collectives()
    saved = []

    def watch(hook, fn):
        def run(local, current, target, *args, **kwargs):
            if tuple(current.placements) == tuple(target.placements):
                return fn(local, current, target, *args, **kwargs)
            key = (hook, _site(), str(tuple(current.placements)),
                   str(tuple(target.placements)))
            moves[key] += 1
            mode.inside.append(key)
            try:
                return fn(local, current, target, *args, **kwargs)
            finally:
                mode.inside.pop()
        return run
    for hook, mod in (("dispatch", _dispatch), ("from_local", _api),
                      ("redistribute", _redistribute)):
        if hasattr(mod, "redistribute_local_tensor"):
            saved.append((mod, mod.redistribute_local_tensor))
            mod.redistribute_local_tensor = watch(
                hook, mod.redistribute_local_tensor)
    try:
        with mode:
            yield moves
    finally:
        for mod, fn in saved:
            mod.redistribute_local_tensor = fn
        moves.collectives = collections.Counter(mode.seen)


def _step_moves(arch: str, shape: str, mesh_shape: tuple):
    """(DTensor's moves, their collectives) in one step of ``arch``'s
    smoke config at ``shape``'s kind, batch 8 and sequence 64, on a fake
    mesh of ``mesh_shape``."""
    names = ("pod", "data", "model")[-len(mesh_shape):]
    cfg = get_smoke_config(arch)
    with dryrun.fake_group(math.prod(mesh_shape)):
        mesh = make_test_mesh(mesh_shape, names, "cpu")
        r = rules.rules_for(arch, shape, multi_pod=len(mesh_shape) == 3)
        _, placed = dryrun.cell_inputs(arch, shape, r, mesh, cfg=cfg,
                                       batch=8, seq=64)
        fn = build_callable(arch, shape, cfg=cfg, seq=64)
        with dryrun._alltoall_as_asked(), sharding.use_rules(r, mesh), \
                dtensor_moves() as moves:
            fn(**placed)
    return moves, moves.collectives


_CASES = [(arch, shape, (2, 2, 2)) for arch, shape in [
    ("mamba2_1_3b", "train_4k"), ("mamba2_1_3b", "prefill_32k"),
    ("mamba2_1_3b", "decode_32k"), ("mixtral_8x22b", "train_4k"),
    ("granite_moe_1b_a400m", "decode_32k"), ("llava_next_34b", "train_4k"),
    ("stablelm_1_6b", "train_4k"), ("stablelm_1_6b", "decode_32k"),
    ("recurrentgemma_2b", "train_4k")]] + [
    (arch, "train_4k", (4, 4)) for arch in (
        "mamba2_1_3b", "mixtral_8x22b", "llava_next_34b", "stablelm_1_6b",
        "recurrentgemma_2b")]


@pytest.mark.parametrize("arch,shape,mesh_shape", _CASES, ids=[
    f"{a}-{s}-{'x'.join(map(str, m))}" for a, s, m in _CASES])
def test_every_collective_is_the_ports(arch, shape, mesh_shape):
    """C8: no collective of the step (forward, backward, optimizer,
    cache writes) comes from a move DTensor's planner chose: each is one
    of the port's own calls, so torch 2.11 and 2.13 count the same
    collectives. (Left to DTensor, mamba2's SSD moved every chunk's
    state by an all-to-all, and a MoE decode reduced its partial expert
    products at the nonlinearity, each version as it chose.) Nor does
    DTensor plan any move that needs no collective here: one version's
    local move is another's collective (adding a norm branch's partial
    gradient to the skip's whole one, 2.13 split the whole one where
    2.11 all-reduced the partial one)."""
    moves, collectives = _step_moves(arch, shape, mesh_shape)
    assert not collectives, (collectives, moves)
    assert not moves, moves


def map_cell(arch: str, shape: str, mesh: str) -> dict:
    """One full dry-run cell (``dryrun.run_cell`` on the production
    ``mesh``, "single" or "multi") inside :func:`dtensor_moves`: its
    collectives by type, peak and argument bytes, collective term, and
    DTensor's own moves with the collectives inside them."""
    import torch
    with dtensor_moves() as moves:
        terms = dryrun.run_cell(arch, shape, mesh == "multi", verbose=False)
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "torch": torch.__version__,
            "counts": {k: v["count"] for k, v in terms["collectives"].items()},
            "peak": terms["memory"]["peak_bytes"],
            "argument_bytes": terms["memory"]["argument_bytes"],
            "collective_s": terms["collective_s"],
            "moves": [[*k, n] for k, n in moves.items()],
            "collectives_in_moves": [[*k, n] for k, n in
                                     moves.collectives.items()]}


def main(argv=None) -> int:
    """``python tests/test_torch_plans.py --out DIR [--jobs N]``: every
    dry-run pair (cell x production mesh) mapped by :func:`map_cell`,
    one subprocess a pair, N at a time, one JSON file a pair in DIR
    (``--one ARCH SHAPE MESH FILE`` runs one pair in this process)."""
    import argparse
    import json
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs.registry import cells
    p = argparse.ArgumentParser()
    p.add_argument("--out")
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--one", nargs=4)
    args = p.parse_args(argv)
    if args.one:
        arch, shape, mesh, path = args.one
        with open(path, "w") as f:
            json.dump(map_cell(arch, shape, mesh), f, indent=1)
        return 0
    os.makedirs(args.out, exist_ok=True)
    pairs = [(c["arch"], c["shape"], m) for c in cells()
             for m in ("single", "multi")]

    def one(pair):
        path = os.path.join(args.out, "__".join(pair) + ".json")
        return subprocess.run([sys.executable, __file__, "--one", *pair,
                               path]).returncode
    with ThreadPoolExecutor(args.jobs) as pool:
        failed = [pr for pr, rc in zip(pairs, pool.map(one, pairs)) if rc]
    print(f"{len(pairs) - len(failed)} pairs mapped; failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
