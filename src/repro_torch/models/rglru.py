"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Gated linear recurrence:  a_t = exp(-c * softplus(Lambda) * r_t),
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t).
Training scans the (a, b) pairs in log2(S) doubling steps in float32
(the reference's ``lax.associative_scan``; a loop over S positions would
be S tiny launches a layer on the card). The doubling scan sums in
another order than XLA's tree, so the two agree to float32 rounding, not
bit for bit. Decode is the single-step update ``h = a h_prev + b`` of
one token against the cache ``{"conv": (B, 3, W), "h": (B, W)}``.

On a mesh the block runs at one layout the port chooses, never one
DTensor's propagation picks: (B, S, W) activations split as ("batch",
None, "state") name them, the seq dim whole. The convolution, the gates,
the scan and the output gating run on each rank's pieces
(``sharding.per_rank``), and the gate products' partial sums over the
width reduce-scatter into that layout (``sharding.reduce_to``). Left to
DTensor, torch 2.11 reduced those sums to whole rows and scanned at 16
times a rank's width, where 2.13 split the batch and moved the pieces
back and forth by all-to-alls.

The input's weight sqrt(1 - a_t^2) is the reference's ``1 - a * a``.
Where a_t is near 1 (r_t near 0) that keeps only the digits of a_t that
survive the rounding of ``exp``, so the result hangs on exp's last bit,
and the card's float32 ``expf`` (within 2 ulp) put the card's logits
further from a float64 run than the CPU's (within 1 ulp). The port takes
a_t as the float32 rounding of a float64 exp, the same on every device.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import sharding
from .layers import ParamSpec, dot, dtype_of, gelu, pin_out, sigmoid, softplus

_C = 8.0


def rglru_spec(cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "in_x": ParamSpec((d, w), ("fsdp", "state")),
        "in_gate": ParamSpec((d, w), ("fsdp", "state")),
        "conv_w": ParamSpec((4, w), (None, "state"), scale=0.5),
        "gate_r": ParamSpec((w, w), ("fsdp", "state")),
        "gate_i": ParamSpec((w, w), ("fsdp", "state")),
        "lam": ParamSpec((w,), ("state",), "zeros"),
        "out": ParamSpec((w, d), ("state", "fsdp")),
    }


def _proj(x, w):
    return dot("...d,dk->...k", x, w, f32=False)


def _gates(r_pre, i_pre, lam, xw):
    r = sigmoid(r_pre.float())
    i = sigmoid(i_pre.float())
    log_a = -_C * softplus(lam.float()) * r
    a = torch.exp(log_a.double()).float()    # rounded alike everywhere
    gated = i * xw.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated
    return a, b


def _causal_conv(x, w, state=None):
    k = w.shape[0]
    pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    return out, xp[:, -(k - 1):, :]


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t with h_{-1} = 0, along axis 1, in
    ceil(log2 S) doubling steps: after the step of offset o each
    position holds the composition of the o-wide window ending there."""
    s = a.shape[1]
    off = 1
    while off < s:
        a_prev = F.pad(a[:, :-off], (0, 0, off, 0), value=1.0)
        b_prev = F.pad(b[:, :-off], (0, 0, off, 0))
        a, b = a * a_prev, a * b_prev + b
        off *= 2
    return b


def _recur(xw, r_pre, i_pre, lam, g, h_prev=None, *, dtype):
    """Gates, recurrence and output gating of one block's pieces: (y,
    the last h). ``g`` is the gate branch's product, ``h_prev`` decode's
    cached state."""
    gate_in = gelu(g.float())
    a, b = _gates(r_pre, i_pre, lam, xw)
    h = linear_scan(a, b) if h_prev is None else a * h_prev[:, None] + b
    return (h * gate_in).to(dtype), h[:, -1]


def rglru_block(p, x, cfg, cache=None, pos=None):
    """x: (B, S, D) full-seq, or (B, 1, D) decode with cache
    {"conv": (B,3,W), "h": (B,W)} (not written). Returns (y, new cache)."""
    bsz, s = x.shape[:2]
    k, w = p["conv_w"].shape
    act = sharding.layout((bsz, s, w), "batch", None, "state")
    conv = sharding.layout((bsz, k - 1, w), "batch", None, "state")
    row = sharding.layout((bsz, w), "batch", "state")
    lam = sharding.layout((w,), "state")
    args, place = (_proj(x, p["in_x"]), p["conv_w"]), \
        (act, sharding.layout((k, w), None, "state"))
    if cache is not None:
        args, place = args + (cache["conv"],), place + (conv,)
    xw, conv_state = sharding.per_rank(_causal_conv, args, place,
                                       (act, conv))
    # the width is contracted: each model rank holds a partial sum
    args = (xw, *(sharding.reduce_to(_proj(xw, p[k]), act)
                  for k in ("gate_r", "gate_i")),
            p["lam"], _proj(x, p["in_gate"]))
    place = (act, act, act, lam, act)
    if cache is not None:
        args, place = args + (cache["h"],), place + (row,)
    y, h = sharding.per_rank(functools.partial(_recur, dtype=x.dtype), args,
                             place, (act, row))
    return pin_out(_proj(y, p["out"])), {"conv": conv_state, "h": h}


def rglru_cache_spec(cfg, batch: int, device) -> dict:
    """One layer's decode cache, allocated as zeros on ``device``."""
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, 3, w), dtype=dtype_of(cfg.compute_dtype),
                            device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_cache_axes() -> dict:
    return {"conv": ("batch", None, "state"), "h": ("batch", "state")}
