"""AdamW with the WSD (warmup–stable–decay) schedule (minicpm,
arXiv:2404.06395) and global-norm clipping.

The update runs in place on the parameter and moment tensors (the
reference returns new arrays), leaf by leaf in sorted path order, with
the reference's float32 arithmetic in the same order: weight decay on
every leaf (norms included), clipping by the float32 global norm, and
bias corrections ``1 - b ** step`` in float32. The step counter is an
int32 scalar tensor on the parameters' device, so a step never waits
for the host.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import sharding


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    stable_steps: int = 10_000
    decay_steps: int = 2_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _leaves(tree) -> list:
    if not isinstance(tree, dict):
        return [tree]
    return [x for k in sorted(tree) for x in _leaves(tree[k])]


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def wsd_schedule(step, cfg: OptConfig):
    """Warmup -> Stable -> (sqrt-like exponential) Decay."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    decay_t = (step - cfg.warmup_steps - cfg.stable_steps) / max(
        cfg.decay_steps, 1)
    decay_t = torch.clamp(decay_t, 0.0, 1.0)
    decay = cfg.min_lr_ratio ** decay_t  # exponential anneal to min ratio
    return cfg.lr * warm * decay


def init_opt_state(params):
    leaf = _leaves(params)[0]
    return {"mu": _zeros_like(params), "nu": _zeros_like(params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def local(x, like=None):
    """``x`` for a plain tensor; a DTensor's local piece (its storage),
    laid out first as ``like`` is where given, else with its partial
    sums reduced (``sharding.move``). The update and the norm run on
    local pieces, so a train state split out of the mesh's order
    (``sharding.strided``) never meets DTensor's own ops."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    want = tuple(like.placements) if like is not None else tuple(
        Replicate() if q.is_partial() else q for q in x.placements)
    return sharding.move(x, want).to_local()


def _scalar(x):
    """A scalar tensor whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    return sharding.move(x, (Replicate(),) * x.device_mesh.ndim).to_local()


def zeros_f32(x):
    """float32 zeros laid out as ``x``."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return torch.zeros_like(x, dtype=torch.float32)
    return sharding.like(x, torch.zeros_like(x.to_local(),
                                             dtype=torch.float32))


def global_norm(tree):
    """sqrt of the sum of every leaf's squares, in float32. For DTensors,
    each rank sums its pieces' squares apart for each layout of the
    leaves (a partial sum over the mesh dims that split them), and each
    layout's sum is all-reduced explicitly (``sharding.reduce_to``):
    adding partial sums of different placements leaves the reduction to
    DTensor, and torch 2.11 all-reduces every leaf's where 2.13 keeps
    them partial."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    total, parts = 0, {}
    for x in _leaves(tree):
        if not isinstance(x, DTensor):
            total = total + torch.sum(torch.square(x.float()))
            continue
        place = tuple(Replicate() if q.is_partial() or isinstance(
            q, Replicate) else Partial() for q in x.placements)
        key = (x.device_mesh, place)
        parts[key] = parts.get(key, 0) + torch.sum(torch.square(
            local(x).float()))
    for (mesh, place), part in parts.items():
        total = total + sharding.reduce_to(
            DTensor.from_local(part, mesh, place, run_check=False),
            (Replicate(),) * mesh.ndim)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_step(params, grads, opt_state, cfg: OptConfig):
    """One AdamW update, in place on ``params`` and the moments; returns
    (params, opt_state, metrics) with a new ``step`` tensor."""
    step = opt_state["step"] + 1
    lr = wsd_schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    s_scale, s_lr, s_c1, s_c2 = (_scalar(x) for x in (scale, lr, c1, c2))

    for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                            _leaves(opt_state["mu"]),
                            _leaves(opt_state["nu"])):
        # on each rank's piece (``local``); plain tensors as they are
        g = local(g, like=p)
        p, mu, nu = local(p), local(mu), local(nu)
        g = g.float() * s_scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        mhat = mu / s_c1
        nhat = nu / s_c2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_((p.float() - s_lr * delta).to(p.dtype))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}, metrics
