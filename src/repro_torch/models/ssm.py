"""Mamba-2 (SSD, state-space duality) block — arXiv:2405.21060.

Chunked SSD algorithm: within-chunk "attention-like" term via the decay
matrix L, cross-chunk linear recurrence on the (H, P, N) state, here a
Python loop over the chunks (the reference's ``lax.scan``). S is padded
up to a multiple of the chunk with ``dt = 0`` pads, which leave the
state as it is. Decode is the O(1) recurrent update of one token against
the cache ``{"conv": (B, K-1, DI), "state": (B, H, P, N)}``.

Layout: x (B, S, H, P) with H = d_inner/head_dim heads, P = head_dim,
shared B/C of state size N (single group), scalar-per-head A.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import sharding
from .layers import ParamSpec, dot, dtype_of, pin_out, silu, softplus


def ssm_spec(cfg) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
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


def _proj(x, w):
    return dot("...d,dk->...k", x, w, f32=False)


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv over seq. x: (B,S,DI), w: (K,DI); the
    K-1 inputs before x are zeros, or ``conv_state`` (decode)."""
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
    return silu(out), new_state


def _rmsnorm_gated(x, z, scale):
    x = x * silu(z.float()).to(x.dtype)
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
    return (xf * (1 + scale.float())).to(x.dtype)


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
    cum = sharding.along(lambda t: torch.cumsum(t, dim=2), (adt_c,), 2)
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
    cb = sharding.einsum("bcqn,bctn->bcqt", c_c, b_c)
    y_diag = sharding.einsum("bcqth,bcthp->bcqhp", cb[..., None] * l_mat,
                             xdt_c)
    # chunk-final states: S_c = sum_t exp(cum[last]-cum[t]) * B_t x_t^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # (B,NC,Q,H)
    s_chunk = sharding.einsum("bctn,bcthp->bchpn", b_c,
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
    y_cross = sharding.einsum("bcqn,bchpn->bcqhp", c_c, prev_states) \
        * decay_in[..., None]
    y = (y_diag + y_cross).reshape(b, s, h, p)
    return y.to(xh.dtype), state


def ssm_block(p, x, cfg, cache=None, pos=None):
    """Full-sequence (cache=None) or one-step decode (cache set).

    cache: {"conv": (B, K-1, DI), "state": (B, H, P, N)}.
    Returns (y, new cache); the input cache is not written.
    """
    bsz = x.shape[0]
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    xin = _proj(x, p["in_x"])
    z = _proj(x, p["in_z"])
    a = -torch.exp(p["a_log"].float())

    if cache is None:
        xin, conv_state = _causal_conv(xin, p["conv_w"])
        dt = softplus(_proj(x, p["in_dt"]).float() + p["dt_bias"].float())
        bmat = _proj(x, p["in_b"]).float()
        cmat = _proj(x, p["in_c"]).float()
        xh = xin.reshape(*xin.shape[:2], h, pdim)
        xh = sharding.constrain(xh, "batch", "seq", "heads", None)
        # pad S to the chunk multiple: dt=0 pads are exact no-ops on the
        # state (decay exp(0)=1, contribution 0)
        s_len = xh.shape[1]
        pad = (-s_len) % cfg.ssm_chunk
        if pad:
            xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt_p = F.pad(dt, (0, 0, 0, pad))
            b_p = F.pad(bmat, (0, 0, 0, pad))
            c_p = F.pad(cmat, (0, 0, 0, pad))
        else:
            xh_p, dt_p, b_p, c_p = xh, dt, bmat, cmat
        y, state = ssd_chunked(xh_p, dt_p, a, b_p, c_p, cfg.ssm_chunk)
        y = y[:, :s_len]
        y = y + xh * p["d_skip"].to(y.dtype)[None, None, :, None]
        y = y.reshape(*xin.shape)
        out = pin_out(_proj(_rmsnorm_gated(y, z, p["norm_scale"]), p["out"]))
        return out, {"conv": conv_state, "state": state.float()}

    # ---- decode: single token, O(1) state update
    xin1, conv_state = _causal_conv(xin, p["conv_w"], cache["conv"])
    dt = softplus(_proj(x, p["in_dt"]).float()
                  + p["dt_bias"].float())[:, 0]                 # (B,H)
    bmat = _proj(x, p["in_b"]).float()[:, 0]                    # (B,N)
    cmat = _proj(x, p["in_c"]).float()[:, 0]
    xh = xin1.reshape(bsz, h, pdim).float()
    decay = torch.exp(dt * a[None, :])                          # (B,H)
    upd = (dt[:, :, None] * xh)[..., None] * bmat[:, None, None, :]
    state = cache["state"] * decay[:, :, None, None] + upd
    y = sharding.einsum("bn,bhpn->bhp", cmat, state)
    y = y + xh * p["d_skip"].float()[None, :, None]
    y = y.reshape(bsz, 1, -1).to(x.dtype)
    out = pin_out(_proj(_rmsnorm_gated(y, z, p["norm_scale"]), p["out"]))
    return out, {"conv": conv_state, "state": state}


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
