"""Attention: GQA/MQA, RoPE or none (NoPE), sliding window, a softmax
scale from the config or hd^-0.5, query-chunked scan and
cross-attention, over full sequences (training and prefill).

Long sequences never materialize the full S x S score matrix: queries
are processed in ``cfg.attn_chunk`` blocks, each against the full K/V
(the reference's ``lax.scan`` over query blocks, here a Python loop).
The mask is additive (-1e30 in float32, added before a float32
softmax), and the probabilities are cast to the compute dtype before
the PV product, as in the reference.

On the card, :func:`multihead` hands plain CUDA bf16 tensors to the
fused kernel (``kernels.attention``, A1): scores stay on chip, the mask
is by index, GQA by index. The kernel reads no positions, so causal
attention goes to it only where the caller states ``index_positions``:
its positions (and ``kv_positions``) are 0 … S-1 on every row, as
``sharding.positions`` makes them. The loop above stays the plain
version: the CPU, float32 compute (the kernel's products are bf16),
sharded DTensor steps and causal calls without that fact take it, and
``cfg.attn_chunk`` governs it alone.

Single-token decode (:func:`decode_kv`) writes the new K/V into the
cache in place at one slot (``pos``, or ``pos % capacity`` for a
window's ring) and attends over the cache with the GQA groups kept
apart (no repeat of the cache). ``pos`` is a Python int: the host knows
it, and a device scalar would make every step wait for the device.
"""
from __future__ import annotations

import torch

from .. import sharding
from ..kernels import attention as kernel
from . import layers, probe
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


def _sdpa(q, k, v, bias, scale=None):
    """q: (B,Sq,H,hd) k/v: (B,Sk,H,hd); bias: (Sq,Sk) or None; ``scale``
    of the scores (None: hd^-0.5)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = dot("bqhd,bkhd->bhqk", q, k, f32=True) * scale
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return dot("bhqk,bkhd->bqhd", probs, v, f32=False)


def _fused(q) -> bool:
    """Whether the fused kernel can take this attention: a plain (not
    DTensor) CUDA tensor in bf16. Sharded steps keep the plain loop,
    whose collectives the dry-run plans count."""
    return type(q) is torch.Tensor and q.is_cuda and \
        q.dtype == torch.bfloat16


def _plain(q, k, v, *, cfg, positions, kpos, causal, scale=None):
    """The plain version: GQA by repeat, then the query-block loop
    (``cfg.attn_chunk`` rows a block, every key per block); ``scale`` of
    the scores (None: hd^-0.5)."""
    s = q.shape[1]
    k = _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    v = _repeat_kv(v, cfg.n_heads // cfg.n_kv_heads)
    pos1 = sharding.first_row(positions) if positions.ndim > 1 else positions
    kpos1 = sharding.first_row(kpos) if kpos.ndim > 1 else kpos
    if not causal:
        return _sdpa(q, k, v, None, scale)
    if s <= cfg.attn_chunk:
        return _sdpa(q, k, v, _mask_bias(pos1, kpos1, cfg.window), scale)
    # flash-style: loop over query blocks, full KV per block
    c = cfg.attn_chunk
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of "
                         f"attn_chunk {c}")
    return torch.cat([
        _sdpa(q[:, i:i + c], k, v,
              _mask_bias(pos1[i:i + c], kpos1, cfg.window), scale)
        for i in range(0, s, c)], dim=1)


def multihead(p, x, *, cfg, positions, kv_x=None, kv_positions=None,
              causal=True, return_kv=False, index_positions=False):
    """Full attention over a sequence (training / prefill / cross).

    x: (B, S, D). kv_x (cross-attention source) defaults to x.
    With ``return_kv`` also returns the (pre-GQA-repeat, post-RoPE)
    (B, S, nkv, hd) K/V for cache seeding at prefill.
    ``index_positions`` states that ``positions`` (and ``kv_positions``)
    are 0 … S-1 on every row, so that the fused kernel's mask by index
    is the mask they give; without it causal attention takes the plain
    version (a check of the values would wait for the device).
    """
    b, s, _ = x.shape
    dt = x.dtype
    xq = x
    if kv_x is None and sharding.layout(
            (b, s, cfg.n_heads, cfg.hd), "batch", "seq", "heads",
            "head_dim") != sharding.layout((b, s, cfg.n_kv_heads, cfg.hd),
                                           "batch", "seq", "kv_heads",
                                           "head_dim"):
        # where the kv heads are not split like the heads, x's gradient
        # comes from the query as a partial sum and from the keys whole:
        # the query's is reduced first, not where DTensor adds the two
        xq = sharding.grad_at(x)
    q = dot("bsd,dhk->bshk", xq, wcast(p["wq"], dt, "fsdp", "heads",
                                       "head_dim"), f32=False)
    src = x if kv_x is None else kv_x
    k = dot("bsd,dhk->bshk", src, wcast(p["wk"], dt, "fsdp", "kv_heads",
                                        "head_dim"), f32=False)
    v = dot("bsd,dhk->bshk", src, wcast(p["wv"], dt, "fsdp", "kv_heads",
                                        "head_dim"), f32=False)
    kpos = positions if kv_positions is None else kv_positions
    # cross-attention skips RoPE on purpose (whisper-style); NoPE has none
    if causal and cfg.position_embedding == "rope":
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, kpos, cfg.rope_theta)
    q = sharding.constrain(q, "batch", "seq", "heads", "head_dim")
    k = sharding.constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = sharding.constrain(v, "batch", "seq", "kv_heads", "head_dim")
    kv_raw = (k, v)
    fused = _fused(q) and (index_positions or not causal)
    if probe.ACTIVE is not None:
        probe.ACTIVE.count_attention(fused)
    if fused:
        out = kernel.attention(q, k, v, causal=causal,
                               window=cfg.window if causal else None,
                               scale=cfg.attention_multiplier)
    else:
        out = _plain(q, k, v, cfg=cfg, positions=positions, kpos=kpos,
                     causal=causal, scale=cfg.attention_multiplier)
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
    if cfg.position_embedding == "rope":
        posv = sharding.positions(b, 1, x) + pos
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
    scale = cfg.attention_multiplier or q.shape[-1] ** -0.5
    scores = dot("bqhrd,bkhd->bhrqk", qg, cache_k, f32=True) * scale
    kidx = sharding.arange(s_cache, scores, -1)
    if cfg.window is not None:
        # ring buffer: slot j holds the token written `(slot - j) % W` steps
        # ago; valid iff that age is within the number of tokens seen so far
        valid = (slot - kidx) % s_cache < min(pos + 1, s_cache)
    else:
        valid = kidx <= pos
    scores = torch.where(valid, scores, -1e30)
    # the softmax takes the whole cache: its kv_seq split is gathered
    # explicitly (a site of the port only)
    probs = torch.softmax(sharding.gather(scores, -1), dim=-1).to(dt)
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
