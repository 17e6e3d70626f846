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
  * the aux loss counts assignments with an int64 ``scatter_add_``
    (exact in any order; ``bincount``'s output size depends on the data,
    so it has no ``meta`` kernel), not a float scatter-add, which sums
    in no fixed order on the card;
  * rows are gathered with ``F.embedding``, whose backward on the card
    sums duplicates in a fixed order; no scatter with duplicate indices.

:func:`register_router_hook` lets a caller read each call's router
probabilities (to tell a near-tie's routing flip between two devices
from a real difference) without changing the layer.
"""
from __future__ import annotations

import collections
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.hooks import RemovableHandle

from .. import sharding
from .layers import ParamSpec, dot, gelu, pin_out, silu, wcast

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


def _per_group(fn, args: tuple, n_out: int, n_partial: int = 0):
    """``fn(*args)``; under ``sharding.use_rules`` with DTensor
    ``args``, through ``local_map`` on each rank's groups: every arg and
    output is a (groups, ...) tensor placed as ("batch", None, ...)
    (the reference's ``xt`` constraint, under which its dispatch stays
    local to a data shard), and the last ``n_partial`` outputs are the
    rank's partial sums (``Partial`` on the mesh dims the groups are
    split over). The dispatch's sorts, ``searchsorted`` and row gathers
    have no DTensor strategy; on its local tensors they run as on one
    device."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    ctx = sharding.active()
    if ctx is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    rules, mesh = ctx
    g = args[0].shape[0]
    spec = sharding.resolve_spec((g,), ("batch",), rules, mesh) + (None,)
    grouped = sharding.placements(spec, mesh)
    partial = tuple(Partial() if isinstance(q, Shard) else q
                    for q in grouped)
    return sharding.local_call(
        fn, args, (grouped,) * len(args),
        (grouped,) * (n_out - n_partial) + (partial,) * n_partial, mesh)


def _dispatch(xt, probs, *, cfg):
    """Top-k routing and the grouped sort-based dispatch, gather-only:
    (buckets (g, E, cap, D), the groups' assignment counts per expert,
    and what the combine needs: sort order, sorted experts and gates,
    segment starts)."""
    g, tl, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xt.dtype
    dev = xt.device
    top_vals, top_ids = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gate_vals, expert_ids = top_vals[..., :k], top_ids[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    ids = expert_ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, ids, torch.ones_like(ids))

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
    return be, order, sorted_expert, sorted_gate, seg_start, counts


def _combine(out_flat, order, sorted_expert, sorted_gate, seg_start, *,
             cfg):
    """Gather each assignment's slot output, un-sort via the inverse
    permutation, then sum the k contributions per token."""
    g, n = sorted_expert.shape
    k = cfg.top_k
    cap = out_flat.shape[1] // cfg.n_experts
    dt = out_flat.dtype
    pos_in_expert = (torch.arange(n, device=out_flat.device)[None, :]
                     - torch.gather(seg_start, 1, sorted_expert))
    keep = pos_in_expert < cap
    slot = sorted_expert * cap + torch.clamp(pos_in_expert, max=cap - 1)
    contrib = _take(out_flat, slot) * (sorted_gate * keep).to(dt)[..., None]
    inv = torch.argsort(order, dim=1)
    unsorted = _take(contrib, inv)
    return unsorted.reshape(g, n // k, k, -1).sum(dim=2)


def moe_mlp(p, x, cfg):
    """x: (B, S, D) -> (B, S, D), plus aux load-balancing loss (scalar)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = groups(cfg, t)
    tl = t // g                                   # tokens per group
    dt = x.dtype
    ctx = sharding.active()
    if ctx is not None:
        # x's batch split only over the mesh axes that split the groups,
        # so that folding its tokens into groups keeps each rank's rows
        # (DTensor cannot refold a split the groups do not divide; a
        # site of the port only)
        part = sharding.resolve_spec((g,), ("batch",), *ctx)[0]
        x = sharding.constrain_spec(x, (part, None, None))
    xt = sharding.constrain(x.reshape(g, tl, d), "batch", None, None)

    logits = dot("gtd,de->gte", xt, p["router"], f32=True)
    probs = torch.softmax(logits, dim=-1)
    for hook in _ROUTER_HOOKS.values():
        hook(probs.detach())

    # ---- grouped sort-based dispatch, gather-only
    be, *route, counts = _per_group(
        functools.partial(_dispatch, cfg=cfg), (xt, probs), 6, n_partial=1)
    cap = be.shape[2]

    # aux load-balancing loss (Switch-style), computed globally
    me = probs.mean(dim=(0, 1))
    ce = counts.float() / (t * k)
    aux = e * torch.sum(me * ce)
    be_axes = ("batch", "experts", "expert_cap", "expert_in")
    be = sharding.constrain(be, *be_axes)
    if ctx is not None:
        # groups and capacity merge into one dim below, which DTensor
        # cannot do while both are split: capacity is gathered first (a
        # site of the port only)
        spec = list(sharding.resolve_spec(tuple(be.shape), be_axes, *ctx))
        if spec[0] is not None and spec[2] is not None:
            spec[2] = None
            be = sharding.constrain_spec(be, tuple(spec))

    # ---- expert FFN: (e, g*cap, .) products, group merged into capacity
    bem = be.permute(1, 0, 2, 3).reshape(e, g * cap, d)
    w_axes = ("experts", "expert_in", "expert_mlp")
    h = dot("ecd,edf->ecf", bem, wcast(p["wi"], dt, *w_axes), f32=True)
    if cfg.mlp_act in ("swiglu", "geglu"):
        gg = dot("ecd,edf->ecf", bem, wcast(p["wg"], dt, *w_axes), f32=True)
        act = silu(gg) if cfg.mlp_act == "swiglu" else gelu(gg)
        h = act * h
    else:
        h = torch.square(F.relu(h)) if cfg.mlp_act == "relu2" else gelu(h)
    h = sharding.constrain(h.to(dt), "experts", "expert_cap", "expert_mlp")
    out_m = dot("ecf,efd->ecd", h, wcast(
        p["wo"], dt, "experts", "expert_mlp", "expert_in"), f32=False)
    out_e = sharding.constrain(out_m.reshape(e, g, cap, d).permute(1, 0, 2, 3),
                               "batch", "experts", "expert_cap", "expert_in")
    # the combine takes each group's slots whole (``_per_group``); they
    # are gathered before the flatten, which DTensor cannot do across
    # two split dims (a site of the port only)
    out_flat = sharding.constrain(out_e, "batch", None, None, None) \
        .reshape(g, e * cap, d)

    # ---- combine
    yt = _per_group(functools.partial(_combine, cfg=cfg),
                    (out_flat, *route), 1)
    return pin_out(yt.reshape(b, s, d)), aux
