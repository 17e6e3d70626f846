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
from .cudalib import dense, device_index, launch

#: kernel launches per wrapper; each wrapper adds one where it launches
LAUNCHES = {"encode_groups": 0, "decode_groups": 0, "bitpack": 0,
            "bitunpack": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _same_words(*ts: torch.Tensor) -> None:
    """All ``ts`` int32 and of one shape."""
    shape = ts[0].shape
    for t in ts:
        if t.dtype != torch.int32 or t.shape != shape:
            break
    else:
        return
    bad = [t.dtype for t in ts if t.dtype != torch.int32]
    if bad:
        raise TypeError(f"codec kernels take int32 word tensors, got {bad}")
    raise ValueError(f"word arrays differ in shape: "
                     f"{[tuple(t.shape) for t in ts]}")


def encode_block(pred_hi, pred_lo, son_hi, son_lo, zbits: int,
                 width: int) -> torch.Tensor:
    """B6 into one int32 buffer of ``2·S·G + G`` words: the residues in
    the order ``ops.compress_bits`` packs them — at width 64 the (G, S,
    2) block, each son's lo word before its hi word; at widths 32 and 16
    the lo words (G, S), then the hi words (G, S) — then the clamped nlz
    (G,). :func:`block_views` gives the (S, G) residues back. On the CPU
    the twin's result in the same layout
    (:func:`.ref.group_residues_block_ref`)."""
    _same_words(pred_hi, pred_lo, son_hi, son_lo)
    if son_hi.dim() != 2:
        raise ValueError(f"encode_groups takes (S, G) words, got "
                         f"{tuple(son_hi.shape)}")
    if width not in WIDTHS or not 1 <= zbits <= 31:
        raise ValueError(f"width must be one of {WIDTHS} and zbits in "
                         f"[1, 31]; got width={width}, zbits={zbits}")
    dev = device_index(pred_hi, pred_lo, son_hi, son_lo)
    if dev < 0:
        return ref.group_residues_block_ref(pred_hi, pred_lo, son_hi, son_lo,
                                            zbits, width)
    s, g = son_hi.shape
    # held in locals: a copy freed before the launch could be handed to
    # the next copy by the caching allocator
    ph, pl, sh, sl = dense(pred_hi), dense(pred_lo), dense(son_hi), \
        dense(son_lo)
    block = torch.empty(2 * s * g + g, dtype=torch.int32,
                        device=son_hi.device)
    if g:
        launch("codec_encode_groups", dev, ph.data_ptr(), pl.data_ptr(),
               sh.data_ptr(), sl.data_ptr(), s, g, width, (1 << zbits) - 1,
               block.data_ptr())
        LAUNCHES["encode_groups"] += 1
    return block


def block_views(block: torch.Tensor, s: int, g: int, width: int):
    """``(res_hi, res_lo, nlz)`` of an :func:`encode_block` buffer: the
    (S, G) residues and the (G,) nlz, as views of it (one ``as_strided``
    each: the cheapest view on the host)."""
    at = block.storage_offset()
    if width == 64:        # son i of group j: lo at 2(jS + i), hi after it
        shape, strides, hi = (s, g), (2, 2 * s), 1
    else:                  # lo at jS + i, hi S·G words further on
        shape, strides, hi = (s, g), (1, s), s * g
    return (block.as_strided(shape, strides, at + hi),
            block.as_strided(shape, strides, at),
            block.as_strided((g,), (1,), at + 2 * s * g))


def encode_groups(pred_hi, pred_lo, son_hi, son_lo, zbits: int, width: int):
    """B6: (S, G) words -> residues (S, G) and clamped nlz (G,), int32;
    same contract as :func:`.ref.group_residues_ref`. The three are views
    of one :func:`encode_block` buffer."""
    block = encode_block(pred_hi, pred_lo, son_hi, son_lo, zbits, width)
    return block_views(block, *son_hi.shape, width)


def decode_groups(res_hi, res_lo, pred_hi, pred_lo):
    """B7: son words ``res ^ pred`` (int32, the inputs' shape); same
    contract as :func:`.ref.decode_residues_ref`. On the card the two
    results are the halves of one ``(2, *shape)`` buffer (views)."""
    _same_words(res_hi, res_lo, pred_hi, pred_lo)
    dev = device_index(res_hi, res_lo, pred_hi, pred_lo)
    if dev < 0:
        return ref.decode_residues_ref(res_hi, res_lo, pred_hi, pred_lo)
    # held in locals: a copy freed before the launch could be handed to
    # the next copy by the caching allocator
    rh, rl, ph, pl = dense(res_hi), dense(res_lo), dense(pred_hi), \
        dense(pred_lo)
    son = rh.new_empty(2, *rh.shape)   # ints, not a tuple: half the cost
    n = rh.numel()
    if n:
        out = son.data_ptr()
        launch("codec_decode_groups", dev, rh.data_ptr(), rl.data_ptr(),
               ph.data_ptr(), pl.data_ptr(), n, out, out + 4 * n)
        LAUNCHES["decode_groups"] += 1
    return son[0], son[1]


def bitpack(bits: torch.Tensor) -> torch.Tensor:
    """B8: (N,) uint8 or bool flags -> ceil(N/32) int32 words; same
    contract as :func:`.ref.bitpack_ref`."""
    if bits.dim() != 1 or bits.dtype not in (torch.uint8, torch.bool):
        raise ValueError(f"bitpack takes (N,) uint8 or bool flags, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    dev = device_index(bits)
    if dev < 0:
        return ref.bitpack_ref(bits)
    flags = dense(bits)            # bool and uint8 share the byte layout
    n = flags.shape[0]
    words = torch.empty(-(-n // 32), dtype=torch.int32, device=bits.device)
    if n:
        launch("codec_bitpack", dev, flags.data_ptr(), n, words.data_ptr())
        LAUNCHES["bitpack"] += 1
    return words


def bitunpack(words: torch.Tensor, n: int) -> torch.Tensor:
    """B9: the first ``n`` flags of int32 ``words``, uint8 {0, 1}; same
    contract as :func:`.ref.bitunpack_ref`."""
    _same_words(words)
    if words.dim() != 1 or not 0 <= n <= 32 * words.shape[0]:
        raise ValueError(f"bitunpack takes (W,) words and n <= 32 W, got "
                         f"{tuple(words.shape)} and n={n}")
    dev = device_index(words)
    if dev < 0:
        return ref.bitunpack_ref(words, n)
    w = dense(words)
    bits = torch.empty(n, dtype=torch.uint8, device=words.device)
    if n:
        launch("codec_bitunpack", dev, w.data_ptr(), n, bits.data_ptr())
        LAUNCHES["bitunpack"] += 1
    return bits
