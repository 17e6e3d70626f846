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


def global_norm(tree):
    total = 0
    for x in _leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
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

    for p, g, mu, nu in zip(_leaves(params), _leaves(grads),
                            _leaves(opt_state["mu"]),
                            _leaves(opt_state["nu"])):
        g = g.float() * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        mhat = mu / c1
        nhat = nu / c2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}, metrics
