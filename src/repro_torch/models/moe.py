"""Mixture-of-Experts FFN with grouped sort-based dispatch.

Token-choice top-k routing, as the reference: tokens split into
``cfg.moe_groups`` groups (only when there are 2,048 tokens or more),
capacity per group, a sort by expert and segment starts for each
assignment's slot, and a gather-only dispatch and combine.

Where the reference's order decides the result, the port takes the
same order:
  * ``lax.top_k`` keeps the lower expert on ties, so the top k come
    from a stable descending sort;
  * ``jnp.argsort`` is stable, and the sorted order decides which
    assignments overflow an expert's capacity and are dropped, so every
    sort here is ``stable=True``;
  * the aux loss counts assignments with ``torch.bincount`` (integer,
    exact), not a float scatter-add, which sums in no fixed order on
    the card;
  * rows are gathered with ``F.embedding``, whose backward on the card
    sums duplicates in a fixed order; no scatter with duplicate indices.

:func:`register_router_hook` lets a caller read each call's router
probabilities (to tell a near-tie's routing flip between two devices
from a real difference) without changing the layer.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F
from torch.utils.hooks import RemovableHandle

from .layers import ParamSpec, dot, gelu, silu

_ROUTER_HOOKS: collections.OrderedDict = collections.OrderedDict()


def register_router_hook(fn) -> RemovableHandle:
    """Call ``fn(probs)`` in every :func:`moe_mlp` with its router
    probabilities ((groups, tokens per group, experts) float32, detached);
    ``handle.remove()`` unregisters it, as ``nn.Module``'s hooks."""
    handle = RemovableHandle(_ROUTER_HOOKS)
    _ROUTER_HOOKS[handle.id] = fn
    return handle


def moe_spec(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    gated = cfg.mlp_act in ("swiglu", "geglu")
    spec = {
        "router": ParamSpec((d, e), ("fsdp", None)),
        "wi": ParamSpec((e, d, f), ("experts", "expert_in", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "expert_in")),
    }
    if gated:
        spec["wg"] = ParamSpec((e, d, f), ("experts", "expert_in", "expert_mlp"))
    return spec


def capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def groups(cfg, t: int) -> int:
    """Dispatch groups for ``t`` tokens: grouping only pays at large t."""
    return math.gcd(getattr(cfg, "moe_groups", 1), t) if t >= 2048 else 1


def _take(x, idx):
    """``take_along_axis(x, idx[..., None], axis=1)`` for x (g, n, d) and
    idx (g, m): rows of each group, through ``F.embedding``."""
    g, n = x.shape[:2]
    flat = idx + torch.arange(g, device=idx.device)[:, None] * n
    return F.embedding(flat, x.reshape(g * n, -1))


def moe_mlp(p, x, cfg):
    """x: (B, S, D) -> (B, S, D), plus aux load-balancing loss (scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = groups(cfg, t)
    tl = t // g                                   # tokens per group
    dt = x.dtype
    dev = x.device
    xt = x.reshape(g, tl, d)

    logits = dot("gtd,de->gte", xt, p["router"], f32=True)
    probs = torch.softmax(logits, dim=-1)
    for hook in _ROUTER_HOOKS.values():
        hook(probs.detach())
    top_vals, top_ids = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gate_vals, expert_ids = top_vals[..., :k], top_ids[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # aux load-balancing loss (Switch-style), computed globally
    me = probs.mean(dim=(0, 1))
    ce = torch.bincount(expert_ids.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(me * ce)

    # ---- grouped sort-based dispatch, gather-only
    flat_expert = expert_ids.reshape(g, tl * k)
    flat_token = torch.arange(tl, device=dev).repeat_interleave(k)[None] \
        .expand(g, tl * k)
    flat_gate = gate_vals.reshape(g, tl * k)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    sorted_token = torch.gather(flat_token, 1, order)
    sorted_gate = _take(flat_gate[..., None], order)[..., 0]
    # per-group segment starts: O(tl*k), no one-hot cumsum
    seg_start = torch.searchsorted(
        sorted_expert, torch.arange(e, device=dev).expand(g, e).contiguous(),
        side="left")                                           # (g, E)
    seg_end = torch.cat(
        [seg_start[:, 1:], torch.full((g, 1), tl * k, device=dev)], dim=1)
    cap = capacity(cfg, tl)

    # bucket slot (e, c) <- the c-th sorted assignment of expert e
    pos = seg_start[:, :, None] + torch.arange(cap, device=dev)[None, None, :]
    valid = pos < seg_end[:, :, None]
    pos_c = torch.clamp(pos, 0, tl * k - 1).reshape(g, e * cap)
    tok_for_slot = torch.gather(sorted_token, 1, pos_c)
    vals = _take(xt, tok_for_slot)
    be = (vals * valid.reshape(g, e * cap, 1).to(dt)).reshape(g, e, cap, d)

    # ---- expert FFN: (e, g*cap, .) products, group merged into capacity
    bem = be.permute(1, 0, 2, 3).reshape(e, g * cap, d)
    h = dot("ecd,edf->ecf", bem, p["wi"], f32=True)
    if cfg.mlp_act in ("swiglu", "geglu"):
        gg = dot("ecd,edf->ecf", bem, p["wg"], f32=True)
        act = silu(gg) if cfg.mlp_act == "swiglu" else gelu(gg)
        h = act * h
    else:
        h = torch.square(F.relu(h)) if cfg.mlp_act == "relu2" else gelu(h)
    out_m = dot("ecf,efd->ecd", h.to(dt), p["wo"], f32=False)
    out_flat = out_m.reshape(e, g, cap, d).permute(1, 0, 2, 3) \
        .reshape(g, e * cap, d)

    # ---- combine: gather each assignment's slot output, un-sort via the
    # inverse permutation, then sum the k contributions per token
    pos_in_expert = (torch.arange(tl * k, device=dev)[None, :]
                     - torch.gather(seg_start, 1, sorted_expert))
    keep = pos_in_expert < cap
    slot = sorted_expert * cap + torch.clamp(pos_in_expert, max=cap - 1)
    contrib = _take(out_flat, slot) * (sorted_gate * keep).to(dt)[..., None]
    inv = torch.argsort(order, dim=1)
    unsorted = _take(contrib, inv)
    yt = unsorted.reshape(g, tl, k, d).sum(dim=2)
    return yt.reshape(b, s, d), aux
