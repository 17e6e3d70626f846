"""A1: fused attention on the card (``csrc/attention.cu``), forward and
backward, as one autograd function.

:func:`attention` takes q (B, Sq, H, hd) and k, v (B, Sk, Hkv, hd) in
bf16, in the layout the projection einsums leave them (contiguous, no
transpose copy), and returns out (B, Sq, H, hd) in bf16. Query head h
reads kv head ``h // (H // Hkv)`` (``repeat_interleave``'s order) with no
repeated copy; the gradients of k and v are summed over the query heads
that share them, inside the kernel.

The mask is by index, as ``models.attention._mask_bias`` builds it from
the positions 0 … S-1 that ``sharding.positions`` gives every caller on
one card: with ``causal`` (Sq == Sk) key j is seen by query i iff j <= i
and, with ``window``, i - j < window; without it every key is seen.

The kernels take head dims 64, 128 and 256 (:data:`HEAD_DIMS`); any other
is zero-padded to the next of them here (zero columns of q and k leave
QK^T unchanged, and the zero columns of v's output are sliced off), with
the default scale still that of the caller's head dim.

The plain version of the same function is ``models.attention``'s
query-block loop around ``_sdpa``; ``multihead`` routes CPU, float32 and
sharded (DTensor) attention there, and hands a plain CUDA bf16 tensor
here. For a CUDA tensor this wrapper launches the kernel or raises: there
is no fallback. :data:`LAUNCHES` counts the launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cudalib

#: the kernels' head dims; others are padded to the next
HEAD_DIMS = (64, 128, 256)
#: C calls made: one forward kernel, two backward kernels a call
LAUNCHES = {"attn_fwd": 0, "attn_bwd": 0}
_INT32 = 2 ** 31 - 1


def kernel_head_dim(hd: int) -> int:
    """The kernel template that takes head dim ``hd``: the least of
    :data:`HEAD_DIMS` at or above it."""
    for k in HEAD_DIMS:
        if 0 < hd <= k:
            return k
    raise ValueError(f"head dim {hd} is not in 1..{HEAD_DIMS[-1]}")


def check(q, k, v, causal: bool, window) -> None:
    """Raise on what the kernels do not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention kernel: {name} is {t.dtype}, "
                            f"it takes bfloat16")
        if t.ndim != 4:
            raise ValueError(f"attention kernel: {name} has shape "
                             f"{tuple(t.shape)}, it takes (B, S, H, hd)")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"attention kernel: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match")
    sk, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"attention kernel: {h} query heads over {hkv} kv "
                         f"heads")
    if causal and sq != sk:
        raise ValueError(f"attention kernel: causal with {sq} queries and "
                         f"{sk} keys")
    if window is not None and (not causal or window <= 0):
        raise ValueError(f"attention kernel: window {window} needs causal "
                         f"attention and a positive size")
    kernel_head_dim(hd)
    if max(b * sq * h, b * sk * hkv) * HEAD_DIMS[-1] > _INT32:
        raise ValueError("attention kernel: a tensor of more than 2^31 "
                         "elements")


def _padded(t, kd: int):
    """``t`` contiguous, 16-byte aligned (the kernels' 16-byte copies)
    and ``kd`` wide: itself where it is all three."""
    if t.shape[-1] != kd:
        return F.pad(t, (0, kd - t.shape[-1]))
    t = cudalib.dense(t)
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        hd = q.shape[-1]
        kd = kernel_head_dim(hd)
        q, k, v = (_padded(t, kd) for t in (q, k, v))
        b, sq, h, _ = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        dev = cudalib.device_index(q, k, v)
        out = torch.empty_like(q)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        cudalib.launch("attn_fwd", dev, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h,
                       hkv, sq, sk, kd, int(causal), window or 0, scale)
        LAUNCHES["attn_fwd"] += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, hd, scale)
        return out if kd == hd else out[..., :hd].contiguous()

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, hd, scale = ctx.attrs
        kd = q.shape[-1]
        dout = _padded(dout, kd)
        b, sq, h, _ = q.shape
        sk, hkv = k.shape[1], k.shape[2]
        dev = cudalib.device_index(q, dout)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty_like(lse)
        cudalib.launch("attn_bwd", dev, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), b, h, hkv, sq, sk, kd,
                       int(causal), window or 0, scale)
        LAUNCHES["attn_bwd"] += 1
        if kd != hd:
            dq, dk, dv = (t[..., :hd] for t in (dq, dk, dv))
        return dq, dk, dv, None, None, None


def attention(q, k, v, *, causal: bool, window=None, scale=None):
    """out (B, Sq, H, hd) bf16 of q (B, Sq, H, hd) against k, v (B, Sk,
    Hkv, hd) on one CUDA device (see the module), the scores scaled by
    ``scale`` (None: hd^-0.5 of the caller's head dim); raises on CPU
    tensors and on whatever :func:`check` refuses."""
    if not cudalib.on_cuda(q, k, v):
        raise ValueError("attention kernel: CPU tensors take the plain "
                         "version (models.attention)")
    check(q, k, v, causal, window)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _Attention.apply(q, k, v, bool(causal), window, scale)
