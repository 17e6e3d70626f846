"""Lossless boolean-array codec: run-length + base-52 character encoding.

Paper §2.2: the AMR refinement/ownership arrays are boolean but stored one
byte per value; even a bitfield wastes space because these arrays contain
long runs of identical values. The paper's codec run-length-encodes the
array and writes run lengths with "base-52 and character encoding",
reaching 63.4 % (refinement) / 99.3 % (ownership) compression *relative to
a bitfield* on the Orion data (1 M cells -> ~1.5 KB in ~0.5 ms).

Encoding used here (the paper does not spell out the digit scheme; this one
is prefix-free, uses exactly 52 letters, and hits the same size regime):

  * Runs alternate starting with value 0. If the array starts with 1, the
    first run has length 0.
  * A run length L >= 0 is written little-endian in base 26 where each
    digit d in [0, 25] maps to 'a'+d when more digits follow and 'A'+d for
    the final digit. 52 characters total; decoding is unambiguous.

A run of 1e6 needs 5 characters ('1e6 = sum d_i * 26^i'), so ownership
arrays with a handful of giant runs collapse to a few bytes.
"""
from __future__ import annotations

import numpy as np

_LOWER = ord("a")
_UPPER = ord("A")


def runs_of(bits: np.ndarray) -> np.ndarray:
    """Run lengths of a boolean array, alternating and starting at value 0."""
    bits = np.asarray(bits, bool)
    if bits.size == 0:
        return np.zeros(0, np.int64)
    change = np.flatnonzero(np.diff(bits.view(np.int8)))
    edges = np.concatenate([[0], change + 1, [bits.size]])
    lengths = np.diff(edges)
    if bits[0]:  # first run must be of value 0
        lengths = np.concatenate([[0], lengths])
    return lengths.astype(np.int64)


def _encode_lengths(lengths: np.ndarray) -> bytes:
    """Vectorized little-endian base-26 with case as the continuation bit."""
    if lengths.size == 0:
        return b""
    # Max digits needed across all runs (bounded, loop over digit index).
    out_cols = []
    rem = lengths.astype(np.int64).copy()
    alive = np.ones(rem.shape, bool)
    while alive.any():
        digit = rem % 26
        rem //= 26
        more = alive & (rem > 0)
        ch = np.where(more, _LOWER + digit, _UPPER + digit).astype(np.uint8)
        ch = np.where(alive, ch, 0).astype(np.uint8)
        out_cols.append(ch)
        alive = more
    cols = np.stack(out_cols, axis=1)  # (runs, max_digits)
    flat = cols.reshape(-1)
    return flat[flat != 0].tobytes()


def _decode_lengths(data: bytes) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8)
    if buf.size == 0:
        return np.zeros(0, np.int64)
    is_final = (buf >= _UPPER) & (buf < _UPPER + 26)
    digit = np.where(is_final, buf - _UPPER, buf - _LOWER).astype(np.int64)
    # Position of each digit within its run: distance since last final char.
    ends = np.flatnonzero(is_final)
    starts = np.concatenate([[0], ends[:-1] + 1])
    run_id = np.repeat(np.arange(ends.size), ends - starts + 1)
    pos = np.arange(buf.size) - starts[run_id]
    vals = digit * (26 ** pos)
    return np.bincount(run_id, weights=vals).astype(np.int64)


def encode(bits: np.ndarray) -> bytes:
    """Boolean array -> base-52 byte string (ASCII letters only)."""
    return _encode_lengths(runs_of(bits))


def decode(data: bytes, n: int | None = None) -> np.ndarray:
    """Inverse of :func:`encode`. ``n`` (if given) checks the total length."""
    lengths = _decode_lengths(data)
    total = int(lengths.sum())
    if n is not None and total != n:
        raise ValueError(f"decoded length {total} != expected {n}")
    vals = (np.arange(lengths.size) % 2).astype(bool)
    out = np.repeat(vals, lengths)
    return out


def bitfield_bytes(n: int) -> int:
    """Size of the bitfield equivalent the paper compares against."""
    return max(1, (n + 7) // 8)


def compression_vs_bitfield(bits: np.ndarray) -> float:
    """Paper fig. 4 metric: 1 - len(encoded)/len(bitfield)."""
    enc = encode(bits)
    return 1.0 - len(enc) / bitfield_bytes(len(bits))
