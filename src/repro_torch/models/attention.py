"""Attention: GQA/MQA, RoPE, sliding window, query-chunked scan and
cross-attention, over full sequences (training and prefill).

Long sequences never materialize the full S x S score matrix: queries
are processed in ``cfg.attn_chunk`` blocks, each against the full K/V
(the reference's ``lax.scan`` over query blocks, here a Python loop).
The mask is additive (-1e30 in float32, added before a float32
softmax), and the probabilities are cast to the compute dtype before
the PV product, as in the reference.

Single-token decode (:func:`decode_kv`) writes the new K/V into the
cache in place at one slot (``pos``, or ``pos % capacity`` for a
window's ring) and attends over the cache with the GQA groups kept
apart (no repeat of the cache). ``pos`` is a Python int: the host knows
it, and a device scalar would make every step wait for the device.
"""
from __future__ import annotations

import torch

from .. import sharding
from . import layers
from .layers import ParamSpec, dot, wcast


def attn_spec(cfg, cross: bool = False) -> dict:
    d, hd, nh, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": ParamSpec((d, nh, hd), ("fsdp", "heads", "head_dim")),
        "wk": ParamSpec((d, nkv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, nkv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wo": ParamSpec((nh, hd, d), ("heads", "head_dim", "fsdp")),
    }


def _repeat_kv(k, n_rep: int):
    """``jnp.repeat`` on the head axis: each KV head n_rep times in a row."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _mask_bias(q_pos, k_pos, window):
    """(Sq, Sk) additive mask: causal + optional sliding window."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, -1e30)


def _sdpa(q, k, v, bias):
    """q: (B,Sq,H,hd) k/v: (B,Sk,H,hd); bias: (Sq,Sk) or None."""
    scale = q.shape[-1] ** -0.5
    scores = dot("bqhd,bkhd->bhqk", q, k, f32=True) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return dot("bhqk,bkhd->bqhd", probs, v, f32=False)


def multihead(p, x, *, cfg, positions, kv_x=None, kv_positions=None,
              causal=True, return_kv=False):
    """Full attention over a sequence (training / prefill / cross).

    x: (B, S, D). kv_x (cross-attention source) defaults to x.
    With ``return_kv`` also returns the (pre-GQA-repeat, post-RoPE)
    (B, S, nkv, hd) K/V for cache seeding at prefill.
    """
    b, s, _ = x.shape
    dt = x.dtype
    q = dot("bsd,dhk->bshk", x, wcast(p["wq"], dt, "fsdp", "heads",
                                      "head_dim"), f32=False)
    src = x if kv_x is None else kv_x
    k = dot("bsd,dhk->bshk", src, wcast(p["wk"], dt, "fsdp", "kv_heads",
                                        "head_dim"), f32=False)
    v = dot("bsd,dhk->bshk", src, wcast(p["wv"], dt, "fsdp", "kv_heads",
                                        "head_dim"), f32=False)
    kpos = positions if kv_positions is None else kv_positions
    if causal:  # cross-attention skips RoPE on purpose (whisper-style)
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, kpos, cfg.rope_theta)
    q = sharding.constrain(q, "batch", "seq", "heads", "head_dim")
    k = sharding.constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = sharding.constrain(v, "batch", "seq", "kv_heads", "head_dim")
    kv_raw = (k, v)
    k = _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)

    pos1 = positions[0] if positions.ndim > 1 else positions
    kpos1 = kpos[0] if kpos.ndim > 1 else kpos
    if not causal:
        out = _sdpa(q, k, v, None)
    elif s <= cfg.attn_chunk:
        out = _sdpa(q, k, v, _mask_bias(pos1, kpos1, cfg.window))
    else:
        # flash-style: loop over query blocks, full KV per block
        c = cfg.attn_chunk
        if s % c:
            raise ValueError(f"sequence {s} is not a multiple of "
                             f"attn_chunk {c}")
        out = torch.cat([
            _sdpa(q[:, i:i + c], k, v,
                  _mask_bias(pos1[i:i + c], kpos1, cfg.window))
            for i in range(0, s, c)], dim=1)

    out = sharding.constrain(out, "batch", "seq", "heads", "head_dim")
    # compute-dtype output: the TP partial sums cross ranks in bf16
    out = layers.pin_out(dot("bshk,hkd->bsd", out, wcast(
        p["wo"], dt, "heads", "head_dim", "fsdp"), f32=False))
    return (out, kv_raw) if return_kv else out


# ------------------------------------------------------------------ decode

def decode_kv(p, x, *, cfg, cache_k, cache_v, pos: int):
    """One-token attention against a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_cache, nkv, hd), written in place at
    slot ``pos`` (``pos % S_cache`` when cfg.window is set: a ring).
    Returns (out (B,1,D), cache_k, cache_v).
    """
    b = x.shape[0]
    dt = x.dtype
    s_cache = cache_k.shape[1]
    pos = int(pos)
    q = dot("bsd,dhk->bshk", x, p["wq"], f32=False)
    k_new = dot("bsd,dhk->bshk", x, p["wk"], f32=False)
    v_new = dot("bsd,dhk->bshk", x, p["wv"], f32=False)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = layers.rope(q, posv, cfg.rope_theta)
    k_new = layers.rope(k_new, posv, cfg.rope_theta)
    slot = pos % s_cache if cfg.window is not None else pos
    if not 0 <= slot < s_cache:
        raise IndexError(f"decode position {pos} past a cache of "
                         f"{s_cache} positions")
    sharding.write_slice(cache_k, 1, slot, k_new)
    sharding.write_slice(cache_v, 1, slot, v_new)
    cache_k = sharding.constrain(cache_k, "batch", "kv_seq", "kv_heads",
                                 "head_dim")
    cache_v = sharding.constrain(cache_v, "batch", "kv_seq", "kv_heads",
                                 "head_dim")

    # grouped-query attention without materializing the GQA repeat: the
    # (kv head, group) axes stay apart in both products
    n_rep = cfg.n_heads // cfg.n_kv_heads
    # DTensor splits a model-sharded head dim into (kv head, group) only
    # where the kv heads carry the split evenly; else q, one token, is
    # gathered whole first (a port-only site: GSPMD reshards the reshape)
    q = sharding.constrain(q, "batch", "seq", "kv_heads" if sharding.splits(
        cfg.n_kv_heads, "kv_heads") else None, "head_dim")
    qg = q.reshape(b, 1, cfg.n_kv_heads, n_rep, q.shape[-1])
    scale = q.shape[-1] ** -0.5
    scores = dot("bqhrd,bkhd->bhrqk", qg, cache_k, f32=True) * scale
    kidx = torch.arange(s_cache, device=x.device)
    if cfg.window is not None:
        # ring buffer: slot j holds the token written `(slot - j) % W` steps
        # ago; valid iff that age is within the number of tokens seen so far
        valid = (slot - kidx) % s_cache < min(pos + 1, s_cache)
    else:
        valid = kidx <= pos
    scores = torch.where(valid, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)          # (b,h,r,1,S)
    out = dot("bhrqk,bkhd->bqhrd", probs, cache_v, f32=False)
    out = out.reshape(b, 1, cfg.n_heads, q.shape[-1])
    out = layers.pin_out(dot("bshk,hkd->bsd", out, wcast(
        p["wo"], dt, "heads", "head_dim", "fsdp"), f32=False))
    return out, cache_k, cache_v


def decode_cross(p, x, *, cfg, enc_k, enc_v):
    """One-token cross-attention against precomputed encoder K/V."""
    dt = x.dtype
    q = dot("bsd,dhk->bshk", x, p["wq"], f32=False)
    k = _repeat_kv(enc_k, cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(enc_v, cfg.n_heads // cfg.n_kv_heads)
    out = _sdpa(q, k.to(dt), v.to(dt), None)
    return layers.pin_out(dot("bshk,hkd->bsd", out, p["wo"], f32=False))
