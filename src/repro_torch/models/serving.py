"""Prefill and single-token decode with per-family caches.

Caches are stacked along the layer axis, as the reference threads them
through its layer scan; here the layers are a Python loop (as in
``LM.apply_params``) and each layer reads and writes its slice in place.
:func:`cache_specs` allocates a batch's cache (zeros on the model's
device); :func:`prefill` fills it from the prompt and :func:`decode_step`
updates it: attention K/V at one slot (``pos``, or ``pos % C`` in a
window's ring), the SSM and RG-LRU states replaced slice by slice.

Cache shapes per family (C = cache capacity = min(window, max_seq)):
  attn/moe : {"k","v": (L, B, C, nkv, hd)}
  encdec   : + {"xk","xv": (L, B, F, nkv, hd)} (cross K/V, prefill-computed)
  ssm      : {"conv": (L, B, K-1, DI), "state": (L, B, H, P, N)}
  hybrid   : per-pattern-slot dicts stacked over macro blocks + tail.

Both entry points run under ``torch.no_grad()``. ``pos`` is a Python
int: the host knows it, and a device scalar would make every step wait
for the device.
"""
from __future__ import annotations

import torch

from .. import sharding
from . import attention, layers, moe, rglru, ssm
from .transformer import LM, _unstack


def cache_capacity(cfg, max_seq: int) -> int:
    return min(cfg.window, max_seq) if cfg.window else max_seq


# ----------------------------------------------------------- allocation

def attn_cache_spec(cfg, batch: int, cap: int, device) -> dict:
    nkv, hd = cfg.n_kv_heads, cfg.hd
    dt = layers.dtype_of(cfg.compute_dtype)
    return {k: torch.zeros((batch, cap, nkv, hd), dtype=dt, device=device)
            for k in ("k", "v")}


def attn_cache_axes() -> dict:
    return {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim")}


def _stack_axes(axes: dict) -> dict:
    return {k: (None, *a) for k, a in axes.items()}


def cache_axes(lm: LM) -> dict:
    """The logical axes of :func:`cache_specs`' tree, key for key (the
    reference's ``cache_specs(...)[1]``)."""
    cfg = lm.cfg

    def one(kind):
        return rglru.rglru_cache_axes() if kind == "rec" \
            else attn_cache_axes()
    if cfg.block_pattern:
        axes = {"blocks": {f"sub{i}_{k}": _stack_axes(one(k))
                           for i, k in enumerate(cfg.block_pattern)}}
        for i, k in enumerate(lm.tail_kinds):
            axes[f"tail{i}"] = one(k)
        return axes
    if cfg.family == "ssm":
        return _stack_axes(ssm.ssm_cache_axes())
    axes = _stack_axes(attn_cache_axes())
    if cfg.family == "encdec":
        for k in ("xk", "xv"):
            axes[k] = (None, "batch", "frames", "kv_heads", "head_dim")
    return axes


def _stacked(make, n: int) -> dict:
    """``make()``'s dict of zero tensors with a leading layer axis n."""
    return {k: torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
            for k, t in make().items()}


def _allocate(lm: LM, batch: int, max_seq: int, dev) -> dict:
    cfg = lm.cfg
    cap = cache_capacity(cfg, max_seq)

    def one(kind):
        if kind == "rec":
            return lambda: rglru.rglru_cache_spec(cfg, batch, dev)
        return lambda: attn_cache_spec(cfg, batch, cap, dev)
    if cfg.block_pattern:
        cache = {"blocks": {f"sub{i}_{k}": _stacked(one(k), lm.n_rep)
                            for i, k in enumerate(cfg.block_pattern)}}
        for i, k in enumerate(lm.tail_kinds):
            cache[f"tail{i}"] = one(k)()
        return cache
    if cfg.family == "ssm":
        return _stacked(lambda: ssm.ssm_cache_spec(cfg, batch, dev),
                        cfg.n_layers)
    cache = _stacked(one("attn"), cfg.n_layers)
    if cfg.family == "encdec":
        shape = (cfg.n_layers, batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
        for k in ("xk", "xv"):
            cache[k] = torch.zeros(shape, dtype=layers.dtype_of(
                cfg.compute_dtype), device=dev)
    return cache


def cache_specs(lm: LM, batch: int, max_seq: int) -> dict:
    """A decode batch's cache, allocated as zeros on the model's
    device; on a ``meta`` model, the abstract cache (the reference's
    ``cache_specs(...)[0]``). Its logical axes are :func:`cache_axes`';
    inside ``sharding.use_rules`` it is placed by them on the mesh, each
    rank allocating only its own piece (the whole cache's shapes come
    from a fake mode, which allocates nothing)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ctx = sharding.active()
    if ctx is None:
        return _allocate(lm, batch, max_seq, lm.device)
    with FakeTensorMode():
        shapes = _allocate(lm, batch, max_seq, "meta")
    return sharding.tree_zeros(shapes, cache_axes(lm), *ctx,
                               device=lm.device)


def _layer(cache: dict, i: int) -> dict:
    """Layer i's slice of a stacked cache (views)."""
    return {k: v[i] for k, v in cache.items()}


def _seed_attn_cache(k, v, cap: int, window: int | None):
    """(B,S,nkv,hd) prefill K/V -> (B,cap,nkv,hd) cache (ring for window)."""
    b, s, nkv, hd = k.shape
    if s == cap:
        return k, v
    if s > cap:  # windowed: keep last `cap`, placed at slot pos%cap
        kw, vw = k[:, s - cap:], v[:, s - cap:]
        roll = (s - cap) % cap
        return tuple(sharding.along(lambda t: torch.roll(t, roll, dims=1),
                                    (t,), 1) for t in (kw, vw))
    pad = (0, 0, 0, 0, 0, cap - s)
    return (torch.nn.functional.pad(k, pad),
            torch.nn.functional.pad(v, pad))


def layer_slots(lm: LM, params, cache):
    """(kind, block parameters, cache entry) of every layer, in the
    forward's order: the stacked blocks (each pattern slot of a hybrid
    macro block in turn), then a hybrid's tail."""
    cfg = lm.cfg
    if cfg.block_pattern:
        for j, lp in enumerate(_unstack(params["blocks"])):
            for i, k in enumerate(cfg.block_pattern):
                name = f"sub{i}_{k}"
                yield k, lp[name], _layer(cache["blocks"][name], j)
        for i, k in enumerate(lm.tail_kinds):
            yield k, params[f"tail{i}"], cache[f"tail{i}"]
        return
    kind = "xattn" if cfg.family == "encdec" else lm.kinds[0]
    for i, lp in enumerate(_unstack(params["blocks"])):
        yield kind, lp, _layer(cache, i)


def seed_layer(entry: dict, cache: dict, cap: int, window) -> None:
    """Copy a layer's prefill cache (``LM._apply_block``'s) into its
    slice ``entry`` (zeros, as :func:`cache_specs` allocates it):
    attention's K/V placed by :func:`_seed_attn_cache`, a prompt shorter
    than the cache into its first slots, every other entry as it is."""
    short = "k" in cache and cache["k"].shape[1] < cap
    if "k" in cache and not short:
        cache = dict(cache)
        cache["k"], cache["v"] = _seed_attn_cache(cache["k"], cache["v"],
                                                  cap, window)
    for k, v in cache.items():
        if short and k in ("k", "v"):
            sharding.write_slice(entry[k], 1, 0, v)
        else:
            entry[k].copy_(v)


def decode_block(lm: LM, kind: str, p, x, lc: dict, pos: int):
    """One layer of kind ``kind`` on one token's hidden state ``x``
    (B, 1, D) at position ``pos``; updates the layer's cache ``lc``."""
    cfg = lm.cfg
    h1 = layers.apply_norm(p["ln1"], x, cfg)
    if kind == "ssm":
        y, new = ssm.ssm_block(p["ssm"], h1, cfg, cache=lc)
    elif kind == "rec":
        y, new = rglru.rglru_block(p["rec"], h1, cfg, cache=lc)
    else:  # writes K/V into the cache itself
        y, _, _ = attention.decode_kv(p["attn"], h1, cfg=cfg,
                                      cache_k=lc["k"], cache_v=lc["v"],
                                      pos=pos)
        new = {}
    for k, v in new.items():
        lc[k].copy_(v)
    x = x + y
    if kind == "ssm":
        return x
    if kind == "xattn":
        hx = layers.apply_norm(p["lnx"], x, cfg)
        x = x + attention.decode_cross(p["xattn"], hx, cfg=cfg,
                                       enc_k=lc["xk"], enc_v=lc["xv"])
    h2 = layers.apply_norm(p["ln2"], x, cfg)
    if kind == "moe":
        return x + moe.moe_mlp(p["moe"], h2, cfg)[0]
    return x + layers.mlp(p["mlp"], h2, cfg)


# --------------------------------------------------------------- prefill

@torch.no_grad()
def prefill(lm: LM, params, tokens, *, extras=None, max_seq: int):
    """Process the prompt; returns (last-token logits (B, V), cache)."""
    cfg = lm.cfg
    extras = extras or {}
    b, s = tokens.shape
    cap = cache_capacity(cfg, max_seq)
    cache = cache_specs(lm, b, max_seq)
    x = layers.embed(params["embed"], tokens, cfg)
    if cfg.family == "vlm" and "patch_embeds" in extras:
        pe = extras["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:, :]], dim=1)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None, :].repeat(b, 1)
    enc_out, enc_pos = lm._encode(params, extras["frames"]) \
        if cfg.family == "encdec" else (None, None)
    for kind, p, entry in layer_slots(lm, params, cache):
        x, _, c = lm._apply_block(kind, p, x, positions, enc_out=enc_out,
                                  enc_pos=enc_pos)
        seed_layer(entry, c, cap, cfg.window)
    x = layers.apply_norm(params["final_norm"], x[:, -1:, :], cfg)
    logits = layers.unembed(params["embed"], x, cfg)[:, 0]
    return logits, cache


# ---------------------------------------------------------------- decode

@torch.no_grad()
def decode_step(lm: LM, params, token, pos: int, cache):
    """One decode step. token: (B,), pos: the token's position (a
    Python int) -> (logits (B, V), cache, updated in place)."""
    cfg = lm.cfg
    x = layers.embed(params["embed"], token[:, None], cfg)
    for kind, p, lc in layer_slots(lm, params, cache):
        x = decode_block(lm, kind, p, x, lc, pos)
    x = layers.apply_norm(params["final_norm"], x, cfg)
    logits = layers.unembed(params["embed"], x, cfg)[:, 0]
    return logits, cache
