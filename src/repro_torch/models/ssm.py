"""Mamba-2 (SSD, state-space duality) block — arXiv:2405.21060.

Chunked SSD algorithm: within-chunk "attention-like" term via the decay
matrix L, cross-chunk linear recurrence on the (H, P, N) state, here a
Python loop over the chunks (the reference's ``lax.scan``). S is padded
up to a multiple of the chunk with ``dt = 0`` pads, which leave the
state as it is. Decode is the O(1) recurrent update of one token against
the cache ``{"conv": (B, K-1, DI), "state": (B, H, P, N)}``.

Layout: x (B, S, H, P) with H = d_inner/head_dim heads, P = head_dim,
shared B/C of state size N (single group), scalar-per-head A.

On a mesh the block runs at one layout the port names, never one that
DTensor's propagation picks: activations split as ("batch", None,
"mlp"), the heads as "heads" (both the "model" axis), B and C whole on
every rank (gathered over the state's split by ``sharding.gather``).
The convolution, the SSD with its inter-chunk loop, the skip and the
decode update run on each rank's own heads (``sharding.per_rank``), so
none of them makes a collective; the gated norm's mean over the split
width is each rank's share, summed by ``sharding.reduce_to``. Left to
DTensor, the loop moved every chunk's state by an all-to-all (the
chunk states split on P, the carried state on the heads), and torch
2.11 and 2.13 chose other moves.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import sharding
from .layers import ParamSpec, dot, dtype_of, pin_out, silu, softplus


def ssm_spec(cfg) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    spec = {
        "in_x": ParamSpec((d, di), ("fsdp", "mlp")),
        "in_z": ParamSpec((d, di), ("fsdp", "mlp")),
        "in_b": ParamSpec((d, n), ("fsdp", "state")),
        "in_c": ParamSpec((d, n), ("fsdp", "state")),
        "in_dt": ParamSpec((d, h), ("fsdp", "heads")),
        "dt_bias": ParamSpec((h,), ("heads",), "zeros"),
        "a_log": ParamSpec((h,), ("heads",), "zeros"),
        "d_skip": ParamSpec((h,), ("heads",), "ones"),
        "conv_w": ParamSpec((cfg.ssm_conv, di), (None, "mlp"), scale=0.5),
        "norm_scale": ParamSpec((di,), ("mlp",), "zeros"),
        "out": ParamSpec((di, d), ("mlp", "fsdp")),
    }
    if cfg.ssm_conv_xbc:
        # the conv's bias over x, and its weight and bias over B and C
        spec.update(
            conv_bias=ParamSpec((di,), ("mlp",), "zeros"),
            conv_bc_w=ParamSpec((cfg.ssm_conv, 2 * n), (None, None),
                                scale=0.5),
            conv_bc_bias=ParamSpec((2 * n,), (None,), "zeros"))
    return spec


def _proj(x, w):
    return dot("...d,dk->...k", x, w, f32=False)


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv over seq, then silu. x: (B,S,DI), w: (K,DI);
    the K-1 inputs before x are zeros, or ``conv_state`` (decode)."""
    out, new_state = _conv(x, w, conv_state)
    return silu(out), new_state


def _causal_conv_bias(x, w, bias):
    """:func:`_causal_conv` with a bias added before the silu (Mamba-2's
    ``conv1d``), over the full sequence."""
    out, new_state = _conv(x, w)
    return silu(out + bias.to(out.dtype)), new_state


def _conv(x, w, conv_state=None):
    """The depthwise causal conv of :func:`_causal_conv`, no activation:
    (out, the last K-1 inputs)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
              for i in range(k))
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad
    return out, new_state


def _gate(x, z, *, width: int):
    """``x`` gated by silu(z), and the mean of its float32 square over
    the last dim as this piece's share of ``width`` columns (the mean
    itself where the piece holds them all: the scale is then 1)."""
    x = x * silu(z.float()).to(x.dtype)
    xf = x.float()
    return x, torch.mean(xf * xf, -1, keepdim=True) * (x.shape[-1] / width)


def _normed(x, ms, scale, *, eps: float):
    xf = x.float()
    xf = xf * torch.rsqrt(ms + eps)
    return (xf * (1 + scale.float())).to(x.dtype)


def _rmsnorm_gated(x, z, scale, eps: float):
    """The gated RMS norm over the last dim (B, S, DI), its mean summed
    across the ranks that split DI."""
    act = sharding.layout(tuple(x.shape), "batch", None, "mlp")
    row = sharding.layout(tuple(x.shape[:-1]) + (1,), "batch", None, None)
    share = sharding.summed(act, x.ndim - 1)
    g, ms = sharding.per_rank(functools.partial(_gate, width=x.shape[-1]),
                              (x, z), (act, act), (act, share))
    ms = sharding.reduce_to(ms, row)
    return sharding.per_rank(functools.partial(_normed, eps=eps),
                             (g, ms, scale), (
        act, row, sharding.layout(tuple(scale.shape), "mlp")), (act,))


def ssd_chunked(xh, dt, a, bmat, cmat, chunk: int):
    """SSD forward. xh: (B,S,H,P); dt: (B,S,H); a: (H,) (negative);
    bmat/cmat: (B,S,N). Returns y: (B,S,H,P), final state (B,H,P,N)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc = s // chunk
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    adt = dt * a[None, None, :]                       # (B,S,H) negative
    xdt = (xh * dt[..., None]).float()
    adt_c = adt.reshape(b, nc, chunk, h)
    xdt_c = xdt.reshape(b, nc, chunk, h, p)
    b_c = bmat.reshape(b, nc, chunk, n).float()
    c_c = cmat.reshape(b, nc, chunk, n).float()
    cum = torch.cumsum(adt_c, dim=2)
    # within-chunk: L[q,t] = exp(cum[q] - cum[t]) for q >= t. The upper
    # triangle is masked before the exp, not after (the reference's
    # where(mask, exp(seg), 0)): the values are the same, but there
    # exp(seg) overflows once a chunk's decay passes ~88 and the masked
    # zero cotangent times inf makes the gradient NaN
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,NC,Q,Q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))
    l_mat = torch.exp(seg.masked_fill(~mask[None, None, :, :, None],
                                      float("-inf")))
    cb = torch.einsum("bcqn,bctn->bcqt", c_c, b_c)
    y_diag = torch.einsum("bcqth,bcthp->bcqhp", cb[..., None] * l_mat, xdt_c)
    # chunk-final states: S_c = sum_t exp(cum[last]-cum[t]) * B_t x_t^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # (B,NC,Q,H)
    s_chunk = torch.einsum("bctn,bcthp->bchpn", b_c,
                           decay_to_end[..., None] * xdt_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B,NC,H)

    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    prev = []                                          # state BEFORE chunk
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)             # (B,NC,H,P,N)
    # cross-chunk contribution: C_q exp(cum[q]) h_prev
    decay_in = torch.exp(cum)                          # (B,NC,Q,H)
    y_cross = torch.einsum("bcqn,bchpn->bcqhp", c_c, prev_states) \
        * decay_in[..., None]
    y = (y_diag + y_cross).reshape(b, s, h, p)
    return y.to(xh.dtype), state


def _seq(xin, dt_raw, dt_bias, a_log, bmat, cmat, d_skip, *, pdim: int,
         chunk: int):
    """The full-sequence SSD of one block's heads (all of them, or a
    rank's): (y (B, S, DI), final state (B, H, P, N))."""
    a = -torch.exp(a_log.float())
    dt = softplus(dt_raw.float() + dt_bias.float())
    bmat, cmat = bmat.float(), cmat.float()
    xh = xin.reshape(*xin.shape[:2], -1, pdim)
    # pad S to the chunk multiple: dt=0 pads are exact no-ops on the
    # state (decay exp(0)=1, contribution 0)
    s_len = xh.shape[1]
    pad = (-s_len) % chunk
    if pad:
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_p = F.pad(dt, (0, 0, 0, pad))
        b_p = F.pad(bmat, (0, 0, 0, pad))
        c_p = F.pad(cmat, (0, 0, 0, pad))
    else:
        xh_p, dt_p, b_p, c_p = xh, dt, bmat, cmat
    y, state = ssd_chunked(xh_p, dt_p, a, b_p, c_p, chunk)
    y = y[:, :s_len]
    y = y + xh * d_skip.to(y.dtype)[None, None, :, None]
    return y.reshape(*xin.shape), state.float()


def _step(xin1, dt_raw, dt_bias, a_log, bmat, cmat, d_skip, state, *,
          pdim: int, dtype):
    """One decode step of one block's heads (all, or a rank's): (y (B,
    1, DI), new state (B, H, P, N))."""
    a = -torch.exp(a_log.float())
    dt = softplus(dt_raw.float() + dt_bias.float())[:, 0]        # (B,H)
    bmat = bmat.float()[:, 0]                                   # (B,N)
    cmat = cmat.float()[:, 0]
    bsz = xin1.shape[0]
    xh = xin1.reshape(bsz, -1, pdim).float()
    decay = torch.exp(dt * a[None, :])                          # (B,H)
    upd = (dt[:, :, None] * xh)[..., None] * bmat[:, None, None, :]
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat, state)
    y = y + xh * d_skip.float()[None, :, None]
    return y.reshape(bsz, 1, -1).to(dtype), state


def ssm_block(p, x, cfg, cache=None, pos=None):
    """Full-sequence (cache=None) or one-step decode (cache set).

    cache: {"conv": (B, K-1, DI), "state": (B, H, P, N)}.
    Returns (y, new cache); the input cache is not written. With
    ``cfg.ssm_conv_xbc`` the conv, with a bias, runs over B and C too,
    over full sequences only (its conv state would have to hold B and C
    too): a cache raises.
    """
    if cache is not None and cfg.ssm_conv_xbc:
        raise NotImplementedError(
            f"{cfg.name}: the conv over x, B and C runs over full "
            f"sequences only; there is no decode step for it")
    bsz, s = x.shape[:2]
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    k, di = p["conv_w"].shape
    act = sharding.layout((bsz, s, di), "batch", None, "mlp")
    conv = sharding.layout((bsz, k - 1, di), "batch", None, "mlp")
    heads = sharding.layout((bsz, s, h), "batch", None, "heads")
    bc = sharding.layout((bsz, s, n), "batch", None, None)
    per_head = sharding.layout((h,), "heads")
    state = sharding.layout((bsz, h, pdim, n), "batch", "heads", None, None)
    args, place = (_proj(x, p["in_x"]), p["conv_w"]), \
        (act, sharding.layout((k, di), None, "mlp"))
    if cfg.ssm_conv_xbc:
        xin, conv_state = sharding.per_rank(
            _causal_conv_bias, args + (p["conv_bias"],),
            place + (sharding.layout((di,), "mlp"),), (act, conv))
    else:
        if cache is not None:
            args, place = args + (cache["conv"],), place + (conv,)
        xin, conv_state = sharding.per_rank(_causal_conv, args, place,
                                            (act, conv))
    z = _proj(x, p["in_z"])
    dt_raw = _proj(x, p["in_dt"])
    # B and C are shared by every head: whole on every rank
    bmat, cmat = (sharding.gather(_proj(x, p[w]), 2)
                  for w in ("in_b", "in_c"))
    if cfg.ssm_conv_xbc:
        # the conv over B and C: per channel, so apart from x's
        conved, _ = _causal_conv_bias(torch.cat([bmat, cmat], dim=-1),
                                      p["conv_bc_w"], p["conv_bc_bias"])
        bmat, cmat = conved[..., :n], conved[..., n:]
    args = (xin, dt_raw, p["dt_bias"], p["a_log"], bmat, cmat, p["d_skip"])
    place = (act, heads, per_head, per_head, bc, bc, per_head)
    if cache is None:
        y, new = sharding.per_rank(
            functools.partial(_seq, pdim=pdim, chunk=cfg.ssm_chunk), args,
            place, (act, state))
    else:
        y, new = sharding.per_rank(
            functools.partial(_step, pdim=pdim, dtype=x.dtype),
            args + (cache["state"],), place + (state,), (act, state))
    eps = 1e-6 if cfg.norm_eps is None else cfg.norm_eps
    out = pin_out(_proj(_rmsnorm_gated(y, z, p["norm_scale"], eps),
                        p["out"]))
    return out, {"conv": conv_state, "state": new}


def ssm_cache_spec(cfg, batch: int, device) -> dict:
    """One layer's decode cache, allocated as zeros on ``device``."""
    h, pdim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype_of(cfg.compute_dtype),
                            device=device),
        "state": torch.zeros((batch, h, pdim, n), dtype=torch.float32,
                             device=device),
    }


def ssm_cache_axes() -> dict:
    return {"conv": ("batch", None, "mlp"),
            "state": ("batch", "heads", None, None)}
