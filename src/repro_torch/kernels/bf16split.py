"""G1: the exact three-piece bf16 split of a float32 cotangent on the card
(``csrc/bf16split.cu``), and its plain version.

:func:`split` takes g (rows, n) float32, or a column block of a wider
matrix (its row stride), and returns pieces (rows, 3, n) bf16 with
``hi + mid + lo == g`` exactly: each piece is the bf16 value nearest to
what the earlier ones leave of g (the source's note says why that is
exact, and where it is not: pieces under bf16's smallest normal). The layout serves both products of a backward (see
``models.layers``): viewed as (rows, 3n), it is the cotangent's three
pieces side by side along the contraction of dA = g Bᵀ; viewed as
(3 rows, n), it is the pieces row by row along the contraction of
dB = Aᵀ g.

For a CUDA tensor :func:`split` launches the kernel or raises; a CPU
tensor takes :func:`split_ref`, the plain version. :data:`LAUNCHES`
counts the launches.
"""
from __future__ import annotations

import torch

from . import cudalib

#: C calls made (one kernel launch each)
LAUNCHES = {"bf16x3_split": 0}


def _truncated(g):
    """g rounded toward zero to bf16 (as float32): its low 16 bits
    cleared."""
    return (g.view(torch.int32) & -65536).view(torch.float32)


def split_ref(g):
    """The plain version of :func:`split` in torch ops: the same three
    round-to-nearest steps, hi by truncation where g is finite and past
    bf16's largest finite value, and a non-finite g as hi alone."""
    bf = torch.bfloat16
    hi = g.to(bf)
    finite = torch.isfinite(g)
    hi = torch.where(finite & torch.isinf(hi), _truncated(g).to(bf), hi)
    r = torch.where(finite, g - hi.float(), 0.0)
    mid = r.to(bf)
    lo = (r - mid.float()).to(bf)
    return torch.stack((hi, mid, lo), dim=-2)


def split(g):
    """pieces (rows, 3, n) bf16 of g (rows, n) float32, a matrix or a
    column block of one (see the module); raises on what the kernel does
    not take."""
    if g.dtype != torch.float32:
        raise TypeError(f"bf16x3 split: g is {g.dtype}, it takes float32")
    if g.ndim != 2:
        raise ValueError(f"bf16x3 split: g has shape {tuple(g.shape)}, it "
                         f"takes (rows, n)")
    if not cudalib.on_cuda(g):
        return split_ref(g)
    rows, n = g.shape
    if g.stride(1) != 1 or g.stride(0) < n:
        g = g.contiguous()
    out = torch.empty((rows, 3, n), dtype=torch.bfloat16, device=g.device)
    cudalib.launch("bf16x3_split", cudalib.device_index(g), g.data_ptr(),
                   out.data_ptr(), rows, n, max(g.stride(0), n))
    LAUNCHES["bf16x3_split"] += 1
    return out
