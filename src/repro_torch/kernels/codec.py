"""CUDA codec kernels B6-B9: father–son XOR delta and bitfields.

Wrappers around the hand-written kernels in ``csrc/codec.cu`` (see the
header there for the designs) and their launch counters. Each wrapper
takes the same arguments as its plain twin in :mod:`.ref`: a CPU tensor
runs the twin, a CUDA tensor launches the kernel or raises — there is no
fallback. Words are ``torch.int32`` tensors holding uint32 bit patterns.
The kernels are built at first use by :mod:`.cudalib`.
"""
from __future__ import annotations

import torch

from ..core.fpdelta import WIDTHS
from . import ref
from .cudalib import check, lib, on_cuda, ptr, stream

#: kernel launches per wrapper; each wrapper adds one where it launches
LAUNCHES = {"encode_groups": 0, "decode_groups": 0, "bitpack": 0,
            "bitunpack": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _same_words(*ts: torch.Tensor) -> None:
    """All ``ts`` int32 and of one shape."""
    bad = [t.dtype for t in ts if t.dtype != torch.int32]
    if bad:
        raise TypeError(f"codec kernels take int32 word tensors, got {bad}")
    if len({tuple(t.shape) for t in ts}) != 1:
        raise ValueError(f"word arrays differ in shape: "
                         f"{[tuple(t.shape) for t in ts]}")


def encode_groups(pred_hi, pred_lo, son_hi, son_lo, zbits: int, width: int):
    """B6: (S, G) words -> residues (S, G) and clamped nlz (G,), int32;
    same contract as :func:`.ref.group_residues_ref`."""
    _same_words(pred_hi, pred_lo, son_hi, son_lo)
    if son_hi.dim() != 2:
        raise ValueError(f"encode_groups takes (S, G) words, got "
                         f"{tuple(son_hi.shape)}")
    if width not in WIDTHS or not 1 <= zbits <= 31:
        raise ValueError(f"width must be one of {WIDTHS} and zbits in "
                         f"[1, 31]; got width={width}, zbits={zbits}")
    if not on_cuda(pred_hi, pred_lo, son_hi, son_lo):
        return ref.group_residues_ref(pred_hi, pred_lo, son_hi, son_lo,
                                      zbits, width)
    dev = son_hi.device
    s, g = son_hi.shape
    ins = [t.contiguous() for t in (pred_hi, pred_lo, son_hi, son_lo)]
    res_hi, res_lo = torch.empty_like(ins[2]), torch.empty_like(ins[3])
    nlz = torch.empty(g, dtype=torch.int32, device=dev)
    if g:
        with torch.cuda.device(dev):
            check(lib().codec_encode_groups(
                *map(ptr, ins), s, g, width, (1 << zbits) - 1, ptr(res_hi),
                ptr(res_lo), ptr(nlz), stream(dev)), "encode_groups")
        LAUNCHES["encode_groups"] += 1
    return res_hi, res_lo, nlz


def decode_groups(res_hi, res_lo, pred_hi, pred_lo):
    """B7: son words ``res ^ pred`` (int32, the inputs' shape); same
    contract as :func:`.ref.decode_residues_ref`."""
    _same_words(res_hi, res_lo, pred_hi, pred_lo)
    if not on_cuda(res_hi, res_lo, pred_hi, pred_lo):
        return ref.decode_residues_ref(res_hi, res_lo, pred_hi, pred_lo)
    dev = res_hi.device
    ins = [t.contiguous() for t in (res_hi, res_lo, pred_hi, pred_lo)]
    son_hi, son_lo = torch.empty_like(ins[0]), torch.empty_like(ins[1])
    if son_hi.numel():
        with torch.cuda.device(dev):
            check(lib().codec_decode_groups(
                *map(ptr, ins), son_hi.numel(), ptr(son_hi), ptr(son_lo),
                stream(dev)), "decode_groups")
        LAUNCHES["decode_groups"] += 1
    return son_hi, son_lo


def bitpack(bits: torch.Tensor) -> torch.Tensor:
    """B8: (N,) uint8 or bool flags -> ceil(N/32) int32 words; same
    contract as :func:`.ref.bitpack_ref`."""
    if bits.dim() != 1 or bits.dtype not in (torch.uint8, torch.bool):
        raise ValueError(f"bitpack takes (N,) uint8 or bool flags, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if not on_cuda(bits):
        return ref.bitpack_ref(bits)
    dev = bits.device
    flags = bits.contiguous().view(torch.uint8)
    n = flags.shape[0]
    words = torch.empty(-(-n // 32), dtype=torch.int32, device=dev)
    if n:
        with torch.cuda.device(dev):
            check(lib().codec_bitpack(ptr(flags), n, ptr(words),
                                      stream(dev)), "bitpack")
        LAUNCHES["bitpack"] += 1
    return words


def bitunpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """B9: the first ``n`` flags of int32 ``words``, uint8 {0, 1}; same
    contract as :func:`.ref.bitunpack_ref`."""
    _same_words(words)
    if words.dim() != 1 or not 0 <= n <= 32 * words.shape[0]:
        raise ValueError(f"bitunpack takes (W,) words and n <= 32 W, got "
                         f"{tuple(words.shape)} and n={n}")
    if not on_cuda(words):
        return ref.bitunpack_ref(words, n)
    dev = words.device
    w = words.contiguous()
    bits = torch.empty(n, dtype=torch.uint8, device=dev)
    if n:
        with torch.cuda.device(dev):
            check(lib().codec_bitunpack(ptr(w), n, ptr(bits), stream(dev)),
                  "bitunpack")
        LAUNCHES["bitunpack"] += 1
    return bits
