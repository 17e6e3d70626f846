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
from a real difference) without changing the layer. Under a traced
training step (``probe.ACTIVE``) the dispatch counts its assignments
and those past capacity, on the device (under ``sharding.use_rules``,
each rank its own groups').
"""
from __future__ import annotations

import collections
import functools
import itertools
import math

import torch
import torch.nn.functional as F
from torch.utils.hooks import RemovableHandle

from .. import sharding
from . import probe
from .layers import ParamSpec, dot, gelu, mlp, mlp_spec, pin_out, silu, wcast

_ROUTER_HOOKS: collections.OrderedDict = collections.OrderedDict()


def register_router_hook(fn) -> RemovableHandle:
    """Call ``fn(probs)`` in every :func:`moe_mlp` with its router
    probabilities ((groups, tokens per group, experts) float32, detached);
    ``handle.remove()`` unregisters it, as ``nn.Module``'s hooks."""
    handle = RemovableHandle(_ROUTER_HOOKS)
    _ROUTER_HOOKS[handle.id] = fn
    return handle


def moe_spec(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_held
    gated = cfg.mlp_act in ("swiglu", "geglu")
    spec = {
        "router": ParamSpec((d, cfg.n_experts), ("fsdp", None)),
        "wi": ParamSpec((e, d, f), ("experts", "expert_in", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "expert_in")),
    }
    if gated:
        spec["wg"] = ParamSpec((e, d, f), ("experts", "expert_in", "expert_mlp"))
    if cfg.shared_ff:
        spec["shared"] = mlp_spec(cfg, d_ff=cfg.shared_ff)
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


def group_rules(g: int) -> dict:
    """The active rules with "batch" taken, for the (g, ...) group
    tensors, as the largest split of the batch's mesh axes that divides
    ``g`` (the rule's own prefix where that is as large). The
    reference's prefix rule splits 16 groups over ("pod",) alone on the
    (2, 16, 16) mesh, so each rank would dispatch and combine 8 whole
    groups, 16 times a (16, 16) rank's one; ("data",) keeps one a rank,
    the same on both pods. Each group's result is the same on any
    layout (a site of the port only)."""
    rules, mesh = sharding.active()
    sizes = sharding.mesh_sizes(mesh)
    cand = rules.get("batch")
    cand = [a for a in ((cand,) if isinstance(cand, str) else cand or ())
            if a in sizes]
    best, most = None, 1
    for r in range(len(cand), 0, -1):
        for sub in itertools.combinations(cand, r):
            n = math.prod(sizes[a] for a in sub)
            if g % n == 0 and n > most:
                best, most = (sub[0] if r == 1 else sub), n
    return {**rules, "batch": best}


def _constrain(x, rules: dict, *axes):
    """``sharding.constrain`` under ``rules`` (a :func:`group_rules`)."""
    mesh = sharding.active()[1]
    return sharding.constrain_spec(
        x, sharding.resolve_spec(tuple(x.shape), axes, rules, mesh))


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
    mesh = ctx[1]
    g = args[0].shape[0]
    spec = sharding.resolve_spec((g,), ("batch",), group_rules(g), mesh) + \
        (None,)
    grouped = sharding.placements(spec, mesh)
    partial = tuple(Partial() if isinstance(q, Shard) else q
                    for q in grouped)
    return sharding.local_call(
        fn, args, (grouped,) * len(args),
        (grouped,) * (n_out - n_partial) + (partial,) * n_partial, mesh)


def _dispatch(xt, probs, *, cfg):
    """Top-k routing and the grouped sort-based dispatch, gather-only:
    (buckets (g, E held, cap, D), the groups' assignment counts per
    expert, and what the combine needs: sort order, sorted experts and
    gates, segment starts). The held experts are the first ones, so
    their assignments lead each group's sorted order."""
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
    held = cfg.n_held
    starts, ends = seg_start[:, :held], seg_end[:, :held]
    pr = probe.ACTIVE
    if pr:
        pr.count_moe(ends - starts, cap, g * tl * k, held < e)

    # bucket slot (e, c) <- the c-th sorted assignment of held expert e
    pos = starts[:, :, None] + torch.arange(cap, device=dev)[None, None, :]
    valid = pos < ends[:, :, None]
    pos_c = torch.clamp(pos, 0, tl * k - 1).reshape(g, held * cap)
    tok_for_slot = torch.gather(sorted_token, 1, pos_c)
    vals = _take(xt, tok_for_slot)
    be = (vals * valid.reshape(g, held * cap, 1).to(dt)).reshape(
        g, held, cap, d)
    return be, order, sorted_expert, sorted_gate, seg_start, counts


def _combine(out_flat, order, sorted_expert, sorted_gate, seg_start, *,
             cfg):
    """Gather each assignment's slot output, un-sort via the inverse
    permutation, then sum the k contributions per token. An assignment
    to an expert held elsewhere adds nothing here."""
    g, n = sorted_expert.shape
    k, held = cfg.top_k, cfg.n_held
    cap = out_flat.shape[1] // held
    dt = out_flat.dtype
    pos_in_expert = (torch.arange(n, device=out_flat.device)[None, :]
                     - torch.gather(seg_start, 1, sorted_expert))
    keep = pos_in_expert < cap
    slot = sorted_expert * cap + torch.clamp(pos_in_expert, max=cap - 1)
    if held < cfg.n_experts:
        keep = keep & (sorted_expert < held)
        slot = torch.clamp(slot, max=held * cap - 1)
    contrib = _take(out_flat, slot) * (sorted_gate * keep).to(dt)[..., None]
    inv = torch.argsort(order, dim=1)
    unsorted = _take(contrib, inv)
    return unsorted.reshape(g, n // k, k, -1).sum(dim=2)


def moe_mlp(p, x, cfg):
    """x: (B, S, D) -> (B, S, D), plus aux load-balancing loss (scalar).

    The router scores all ``cfg.n_experts``, and the aux loss and each
    group's capacity are theirs; the experts run are the
    ``cfg.n_held`` held here, the first ones (one device's share under
    expert parallelism: the others' part of the result is not computed
    here). With ``cfg.shared_ff`` a shared SwiGLU expert on every token
    is added to the routed experts' sum."""
    x_in = x
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    eh = cfg.n_held
    t = b * s
    g = groups(cfg, t)
    tl = t // g                                   # tokens per group
    dt = x.dtype
    ctx = sharding.active()
    if ctx is not None:
        # x's batch split only over the mesh axes that split the groups,
        # so that folding its tokens into groups keeps each rank's rows
        # (DTensor cannot refold a split the groups do not divide), moved
        # by ``sharding.regroup`` (DTensor's own redistribution between
        # the two gathers the whole batch first; a site of the port only)
        grules = group_rules(g)
        part = sharding.resolve_spec((g,), ("batch",), grules, ctx[1])[0]
        x_part = sharding.resolve_spec((b,), ("batch",), *ctx)[0]
        x = sharding.regroup(x, 0, part)
        xt = _constrain(x.reshape(g, tl, d), grules, "batch", None, None)
    else:
        xt = x.reshape(g, tl, d)

    # where d_model is split and the tokens are not (decode), the
    # products below are partial sums: each is reduced explicitly
    # before the nonlinearity that meets it (a site of the port only)
    logits = sharding.reduce_by(dot("gtd,de->gte", xt, p["router"],
                                    f32=True))
    probs = torch.softmax(logits, dim=-1)
    for hook in _ROUTER_HOOKS.values():
        hook(probs.detach())

    # ---- grouped sort-based dispatch, gather-only
    be, *route, counts = _per_group(
        functools.partial(_dispatch, cfg=cfg), (xt, probs), 6, n_partial=1)
    cap = be.shape[2]

    # aux load-balancing loss (Switch-style), computed globally
    me = sharding.mean(probs, (0, 1))
    ce = sharding.reduce_by(counts).float() / (t * k)
    aux = e * torch.sum(me * ce)
    be_axes = ("batch", "experts", "expert_cap", "expert_in")
    if ctx is not None:
        # groups and capacity merge into one dim below, which DTensor
        # cannot do while both are split: capacity is gathered first (a
        # site of the port only)
        spec = list(sharding.resolve_spec(tuple(be.shape), be_axes, grules,
                                          ctx[1]))
        if spec[0] is not None and spec[2] is not None:
            spec[2] = None
        be = sharding.constrain_spec(be, tuple(spec))

    # ---- expert FFN: (e, g*cap, .) products, group merged into capacity
    bem = be.permute(1, 0, 2, 3).reshape(eh, g * cap, d)
    w_axes = ("experts", "expert_in", "expert_mlp")
    h_axes = ("experts", "expert_cap", "expert_mlp")
    h = sharding.reduce_by(dot("ecd,edf->ecf", bem, wcast(
        p["wi"], dt, *w_axes), f32=True), *h_axes)
    if cfg.mlp_act in ("swiglu", "geglu"):
        gg = sharding.reduce_by(dot("ecd,edf->ecf", bem, wcast(
            p["wg"], dt, *w_axes), f32=True), *h_axes)
        act = silu(gg) if cfg.mlp_act == "swiglu" else gelu(gg)
        h = act * h
    else:
        h = torch.square(F.relu(h)) if cfg.mlp_act == "relu2" else gelu(h)
    h = sharding.constrain(h.to(dt), *h_axes)
    out_m = dot("ecf,efd->ecd", h, wcast(
        p["wo"], dt, "experts", "expert_mlp", "expert_in"), f32=False)
    out_e = out_m.reshape(eh, g, cap, d).permute(1, 0, 2, 3)
    if ctx is not None:
        out_e = _constrain(out_e, grules, "batch", "experts", "expert_cap",
                           "expert_in")
    # the combine takes each group's slots whole (``_per_group``): each
    # rank gathers its groups' slots by one all-gather a mesh dim that
    # splits them, before the flatten, which DTensor cannot do across
    # two split dims (DTensor's own redistribution to ("batch", None,
    # None, None) built a buffer 16 times that on the (2, 16, 16) mesh;
    # a site of the port only)
    for dim in (1, 2, 3):
        out_e = sharding.gather(out_e, dim)
    out_flat = out_e.reshape(g, eh * cap, d)

    # ---- combine
    yt = _per_group(functools.partial(_combine, cfg=cfg),
                    (out_flat, *route), 1)
    y = yt.reshape(b, s, d)
    if ctx is not None:
        y = sharding.regroup(y, 0, x_part)     # the tokens' split again
    y = pin_out(y)
    if cfg.shared_ff:
        y = y + mlp(p["shared"], x_in, cfg)
    return y, aux
