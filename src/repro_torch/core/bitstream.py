"""Vectorized variable-length bit packing on 32-bit words (plain torch).

Packing is a cumsum + dual segment-sum over disjoint bit ranges: every
value writes its low/high word contribution and the (disjoint-bit) sum
reassembles the stream, so no sequential walk is needed. The stream
layout is identical to ``repro.core.bitstream``'s, word for word.

Words are carried as int64 masked with ``0xFFFFFFFF``: ``torch.uint32``
has no shifts, comparisons or ``index_add_``. The host entry points take
and return numpy ``uint32`` arrays.
"""
from __future__ import annotations

import numpy as np
import torch

UINT32_FULL = np.uint32(0xFFFFFFFF)
_FULL = 0xFFFFFFFF


def _mask(nbits: torch.Tensor) -> torch.Tensor:
    """Bitmask with the low ``nbits`` set; nbits in [0, 32] (int64)."""
    return (torch.ones_like(nbits) << nbits) - 1


def pack_bits(values: torch.Tensor, nbits: torch.Tensor, num_words: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack ``values[i]``'s low ``nbits[i]`` bits densely into 32-bit words.

    Args:
      values: (M,) integer payloads in [0, 2^32) (only the low nbits kept).
      nbits:  (M,) integers in [0, 32], bits to keep per value.
      num_words: output length (>= ceil(sum(nbits)/32)).

    Returns:
      (words, total_bits): (num_words,) int64 words in [0, 2^32) and the
      scalar bit count.
    """
    values = values.to(torch.int64) & _FULL
    nbits = nbits.to(torch.int64)
    offsets = torch.cumsum(nbits, 0) - nbits        # exclusive prefix
    total_bits = nbits.sum()
    # zero-bit entries at the very end may sit one word past the stream;
    # they contribute nothing, so clamping them in is exact
    word_idx = torch.clamp(offsets >> 5, max=num_words - 1)
    bit_in = offsets & 31
    masked = values & _mask(nbits)
    lo = (masked << bit_in) & _FULL
    hi = masked >> (32 - bit_in)                    # 0 when bit_in == 0
    words = torch.zeros(num_words, dtype=torch.int64, device=values.device)
    words.index_add_(0, word_idx, lo)
    words.index_add_(0, torch.clamp(word_idx + 1, max=num_words - 1), hi)
    return words & _FULL, total_bits


def unpack_bits(words: torch.Tensor, offsets: torch.Tensor,
                nbits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits` given per-value bit offsets.

    Args:
      words: (W,) stream words in [0, 2^32).
      offsets: (M,) exclusive bit offsets (cumsum(nbits) - nbits).
      nbits: (M,) integers in [0, 32].

    Returns:
      (M,) int64 payloads (high bits zero).
    """
    offsets = offsets.to(torch.int64)
    nbits = nbits.to(torch.int64)
    word_idx = offsets >> 5
    bit_in = offsets & 31
    padded = torch.cat([words.to(torch.int64) & _FULL,
                        torch.zeros(1, dtype=torch.int64,
                                    device=words.device)])
    last = padded.shape[0] - 1
    w0 = padded[torch.clamp(word_idx, max=last)]
    w1 = padded[torch.clamp(word_idx + 1, max=last)]
    lo = w0 >> bit_in
    hi = torch.where(bit_in == 0, torch.zeros_like(w1),
                     (w1 << (32 - bit_in)) & _FULL)
    return (lo | hi) & _mask(nbits)


# ---------------------------------------------------------------------------
# Host-side convenience (exact sizing, numpy in/out).
# ---------------------------------------------------------------------------

def pack_bits_host(values: np.ndarray, nbits: np.ndarray) -> tuple[np.ndarray, int]:
    """Host packing with exact output size. Returns (words, total_bits)."""
    nbits = np.asarray(nbits, np.int64)
    total = int(nbits.sum())
    n_words = max(1, (total + 31) // 32)
    vals = np.asarray(values, np.uint32).astype(np.int64)
    words, _ = pack_bits(torch.from_numpy(vals), torch.from_numpy(nbits),
                         n_words)
    return words.numpy().astype(np.uint32), total


def unpack_bits_host(words: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    nbits64 = np.asarray(nbits, np.int64)
    offsets = np.cumsum(nbits64) - nbits64
    w = np.asarray(words, np.uint32).astype(np.int64)
    out = unpack_bits(torch.from_numpy(w), torch.from_numpy(offsets),
                      torch.from_numpy(nbits64))
    return out.numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# (hi, lo) pair helpers for 64-bit payloads.
# ---------------------------------------------------------------------------

def f64_to_pair(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """View float64 as (hi, lo) uint32 pair arrays (little-endian layout)."""
    v = np.ascontiguousarray(x, np.float64).view(np.uint32).reshape(*x.shape, 2)
    return v[..., 1].copy(), v[..., 0].copy()


def pair_to_f64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    out = np.empty((*hi.shape, 2), np.uint32)
    out[..., 1] = hi
    out[..., 0] = lo
    return out.view(np.float64).reshape(hi.shape)


def f32_to_u32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def u32_to_f32(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.uint32).view(np.float32)


def bf16_to_u32(x) -> np.ndarray:
    """bfloat16 -> uint16 payload widened to uint32 (high 16 bits zero).

    ``x`` is a ``torch.bfloat16`` tensor or anything numpy reads as
    float32; float32 input rounds to nearest-even bfloat16 first.
    """
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)
                             ).to(torch.bfloat16)
    u16 = x.contiguous().view(torch.int16).cpu().numpy().view(np.uint16)
    return u16.astype(np.uint32)


def u32_to_bf16(x: np.ndarray) -> torch.Tensor:
    """Inverse of :func:`bf16_to_u32`: a ``torch.bfloat16`` tensor."""
    u16 = np.ascontiguousarray(x, np.uint32).astype(np.uint16)
    return torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)


# On the host, bfloat16 lives as a numpy ``uint16`` array of its bits
# (numpy has no bfloat16 of its own), always beside the dtype name
# "bfloat16"; only the torch boundary views it as ``torch.bfloat16``.

def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16), round to nearest even.

    NaN becomes 0x7FC0, or 0xFFC0 with the sign bit, as ``ml_dtypes``
    does; a float64 cast to float32 first rounds as ``ml_dtypes``'
    float64 -> bfloat16 cast does.
    """
    x = np.ascontiguousarray(x, np.float32)
    b = x.view(np.uint32).astype(np.uint64)
    out = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(x)
    out[nan] = np.where(np.signbit(x[nan]), 0xFFC0, 0x7FC0)
    return out


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits (uint16) -> float32 values, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16
            ).view(np.float32)
