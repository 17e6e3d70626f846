"""Father–son lossless FP delta compression (paper §2.3).

The predictor for an AMR cell's value is its *father* cell's value (which
RAMSES already stores — the intensive restriction of its sons). Per group
of 8 sons:

  1. residue_j = bits(son_j) XOR bits(father)      (lossless delta)
  2. m = OR_j residue_j; nlz = clz(m)              (shared leading zeros)
  3. nlz is clamped to 2**zbits - 1 (default zbits=4 -> <= 15, the paper's
     default; "this parameter can be optimized at runtime") and stored as a
     zbits-wide code; every residue is stored with width - nlz bits.

Asymptotic best rate at zbits=4/width=64: (8*15-4)/(8*64) = 22.66 % — the
paper's "22.65 %". Measured on Orion data the paper gets 16.26 % (density,
~11 zeros stripped) and 17.91 % (v_y, ~12): reproduced by
``benchmarks/bench_fpdelta.py``.

Format note (TPU adaptation, DESIGN.md §2): codes and residues go to two
separate packed streams instead of an interleaved one so that decode is a
pure vectorized cumsum+gather — same total size, no sequential walk. The
paper's top-down order is kept: groups are emitted level by level, so
partial decompression down to a chosen level works (``decode_to_level``).

Everything here is host-side numpy orchestration, and nothing here
calls a kernel. ``kernels.ops.compress_bits`` is the compute-hot inner
step (XOR + group-OR + CLZ) as a CUDA kernel; it writes the same code
and payload words as :func:`encode_tree_field`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import bitstream as bs
from .amr import AMRTree

WIDTHS = (16, 32, 64)


def _clz32(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint32, vectorized (clz(0) = 32)."""
    x = np.asarray(x, np.uint32)
    # float64 mantissa (53 bits) represents uint32 exactly; frexp gives bitlength
    exp = np.frexp(x.astype(np.float64))[1]
    return (32 - exp).astype(np.int32)


def group_residues(pred_hi, pred_lo, son_hi, son_lo, zbits: int, width: int):
    """Residues + clamped shared leading-zero count per group.

    pred_*: (G,) or (G, S) predictor bit patterns; son_*: (G, S).
    Returns (res_hi (G,S), res_lo (G,S), nlz (G,) int32).
    """
    g, s = son_hi.shape
    if g == 0:
        return (np.zeros((0, s), np.uint32), np.zeros((0, s), np.uint32),
                np.zeros((0,), np.int32))
    pred_hi = np.broadcast_to(np.asarray(pred_hi, np.uint32).reshape(g, -1), son_hi.shape)
    pred_lo = np.broadcast_to(np.asarray(pred_lo, np.uint32).reshape(g, -1), son_lo.shape)
    res_hi = son_hi ^ pred_hi
    res_lo = son_lo ^ pred_lo
    m_hi = np.bitwise_or.reduce(res_hi, axis=1)
    m_lo = np.bitwise_or.reduce(res_lo, axis=1)
    if width == 64:
        nlz = np.where(m_hi != 0, _clz32(m_hi), 32 + _clz32(m_lo))
    elif width == 32:
        nlz = _clz32(m_lo)
    else:  # 16-bit payload in lo
        nlz = _clz32(m_lo) - 16
    nlz = np.minimum(nlz, (1 << zbits) - 1).astype(np.int32)
    return res_hi, res_lo, nlz


@dataclasses.dataclass
class Compressed:
    """A compressed stream of S-son groups."""
    codes: np.ndarray        # packed zbits-wide nlz codes (uint32 words)
    payload: np.ndarray      # packed residues (uint32 words)
    n_groups: int
    group_size: int
    zbits: int
    width: int               # 16 / 32 / 64

    @property
    def nbytes(self) -> int:
        return self.codes.nbytes + self.payload.nbytes

    def rate_vs_raw(self) -> float:
        raw = self.n_groups * self.group_size * (self.width // 8)
        return 1.0 - self.nbytes / raw if raw else 0.0


def _to_bits(x: np.ndarray, width: int):
    if width == 64:
        return bs.f64_to_pair(np.asarray(x, np.float64))
    if width == 32:
        return np.zeros(x.shape, np.uint32), bs.f32_to_u32(np.asarray(x, np.float32))
    return np.zeros(x.shape, np.uint32), bs.bf16_to_u32(x)


def _from_bits(hi: np.ndarray, lo: np.ndarray, width: int):
    if width == 64:
        return bs.pair_to_f64(hi, lo)
    if width == 32:
        return bs.u32_to_f32(lo)
    return bs.u32_to_bf16(lo)


def encode(pred: np.ndarray, sons: np.ndarray, *, zbits: int = 4,
           width: int = 64) -> Compressed:
    """Compress ``sons`` (G, S) floats against predictor ``pred`` (G,) or (G, S)."""
    assert width in WIDTHS
    G, S = sons.shape
    ph, plo = _to_bits(np.asarray(pred), width)
    sh, slo = _to_bits(np.asarray(sons), width)
    res_hi, res_lo, nlz = group_residues(ph, plo, sh, slo, zbits, width)
    nbits = (width - nlz).astype(np.int64)            # per son, per group

    codes, _ = bs.pack_bits_host(nlz.astype(np.uint32),
                                 np.full(G, zbits, np.int32))
    if width == 64:
        # each son -> two entries: (lo, min(nbits,32)) then (hi, nbits-32)
        nb = np.repeat(nbits, S)
        vals = np.empty(G * S * 2, np.uint32)
        lens = np.empty(G * S * 2, np.int64)
        vals[0::2] = res_lo.ravel(); lens[0::2] = np.minimum(nb, 32)
        vals[1::2] = res_hi.ravel(); lens[1::2] = np.maximum(nb - 32, 0)
        payload, _ = bs.pack_bits_host(vals, lens.astype(np.int32))
    else:
        nb = np.repeat(np.minimum(nbits, width), S)
        payload, _ = bs.pack_bits_host(res_lo.ravel().astype(np.uint32),
                                       nb.astype(np.int32))
    return Compressed(codes=codes, payload=payload, n_groups=G, group_size=S,
                      zbits=zbits, width=width)


def decode(blk: Compressed, pred: np.ndarray) -> np.ndarray:
    """Inverse of :func:`encode`; ``pred`` must match the encode-time predictor."""
    G, S, width = blk.n_groups, blk.group_size, blk.width
    if G == 0:
        return np.zeros((0, S), np.float64 if width == 64 else np.float32)
    nlz = bs.unpack_bits_host(blk.codes, np.full(G, blk.zbits, np.int32))
    nbits = (np.int64(width) - nlz.astype(np.int64))
    nb = np.repeat(nbits, S)
    if width == 64:
        lens = np.empty(G * S * 2, np.int64)
        lens[0::2] = np.minimum(nb, 32)
        lens[1::2] = np.maximum(nb - 32, 0)
        flat = bs.unpack_bits_host(blk.payload, lens.astype(np.int32))
        res_lo = flat[0::2].reshape(G, S)
        res_hi = flat[1::2].reshape(G, S)
    else:
        flat = bs.unpack_bits_host(blk.payload, nb.astype(np.int32))
        res_lo = flat.reshape(G, S)
        res_hi = np.zeros((G, S), np.uint32)
    ph, plo = _to_bits(np.asarray(pred), width)
    ph = np.broadcast_to(ph.reshape(G, -1), (G, S))
    plo = np.broadcast_to(plo.reshape(G, -1), (G, S))
    return _from_bits(res_hi ^ ph, res_lo ^ plo, width)


# ------------------------------------------------------------------ trees

@dataclasses.dataclass
class TreeCompressed:
    """Level-fused compressed field over an AMR tree (top-down decodable).

    The paper's format is conceptually per-level; here all levels' groups
    are packed into ONE stream in level-major order (a beyond-paper perf
    change: one vectorized encode per field instead of one per level; the
    prefix property keeps partial decompression to a level intact).
    ``level_groups[l]`` = number of 8-son groups contributed by level l.
    """
    root_raw: np.ndarray             # level-0 values, stored raw
    stream: Compressed               # all groups, level-major
    level_groups: list[int]
    field: str
    width: int

    @property
    def nbytes(self) -> int:
        return self.root_raw.nbytes + self.stream.nbytes

    # kept for older callers/tests
    @property
    def levels(self):
        return [self.stream]


def _tree_groups(tree: AMRTree, v: np.ndarray):
    cs = tree.child_start()
    preds, sons, counts = [], [], []
    for l in range(tree.n_levels - 1):
        sl = tree.level_slice(l)
        fathers = np.flatnonzero(tree.refine[sl]) + sl.start
        counts.append(fathers.size)
        if fathers.size:
            preds.append(v[fathers])
            sons.append(v[(cs[fathers][:, None] + np.arange(8)[None, :])])
    pred = np.concatenate(preds) if preds else np.zeros(0)
    son = np.concatenate(sons) if sons else np.zeros((0, 8))
    return pred, son, counts


def encode_tree_field(tree: AMRTree, field: str, *, zbits: int = 4,
                      width: int = 64) -> TreeCompressed:
    """Compress a per-node field (fathers predict sons), level-fused."""
    v = tree.fields[field]
    pred, sons, counts = _tree_groups(tree, v)
    stream = encode(pred, sons, zbits=zbits, width=width)
    root = v[tree.level_slice(0)].astype(np.float64 if width == 64 else np.float32)
    return TreeCompressed(root_raw=root.copy(), stream=stream,
                          level_groups=counts, field=field, width=width)


def _unpack_residues(blk: Compressed, n_groups: int | None = None):
    """Unpack nlz codes + residue bit patterns for the first ``n_groups``
    groups (prefix slice = the paper's level-bounded partial decode)."""
    G, S, width = blk.n_groups, blk.group_size, blk.width
    n = G if n_groups is None else min(n_groups, G)
    nlz = bs.unpack_bits_host(blk.codes, np.full(G, blk.zbits, np.int32))[:n]
    nbits = (np.int64(width) - nlz.astype(np.int64))
    nb = np.repeat(nbits, S)
    if width == 64:
        lens = np.empty(n * S * 2, np.int64)
        lens[0::2] = np.minimum(nb, 32)
        lens[1::2] = np.maximum(nb - 32, 0)
        flat = bs.unpack_bits_host(blk.payload, lens.astype(np.int32))
        return flat[1::2].reshape(n, S), flat[0::2].reshape(n, S)  # (hi, lo)
    flat = bs.unpack_bits_host(blk.payload, nb.astype(np.int32))
    return np.zeros((n, S), np.uint32), flat.reshape(n, S)


def decode_tree_field(tree: AMRTree, tc: TreeCompressed,
                      to_level: int | None = None) -> np.ndarray:
    """Decode top-down; ``to_level`` stops early (partial decompression —
    the paper's memory-saving visualization path). Values beyond the level
    are left zero. Residues are unpacked in one vectorized pass; the
    level walk is a pure XOR chain (fathers from the already-decoded
    level)."""
    n_levels = tree.n_levels if to_level is None else min(to_level + 1,
                                                          tree.n_levels)
    width = tc.width
    v = np.zeros(tree.n_nodes, np.float64 if width == 64 else np.float32)
    v[tree.level_slice(0)] = tc.root_raw
    need = sum(tc.level_groups[:max(0, n_levels - 1)])
    res_hi, res_lo = _unpack_residues(tc.stream, need)
    cs = tree.child_start()
    g0 = 0
    for l in range(n_levels - 1):
        sl = tree.level_slice(l)
        fathers = np.flatnonzero(tree.refine[sl]) + sl.start
        g1 = g0 + fathers.size
        if fathers.size == 0:
            continue
        ph, plo = _to_bits(v[fathers], width)
        sh = res_hi[g0:g1] ^ ph[:, None]
        slo = res_lo[g0:g1] ^ plo[:, None]
        sons = _from_bits(sh, slo, width)
        v[(cs[fathers][:, None] + np.arange(8)[None, :])] = \
            np.asarray(sons, v.dtype)
        g0 = g1
    return v


def tree_field_rate(tree: AMRTree, tc: TreeCompressed) -> float:
    """Paper figs. 5/6 metric: 1 - compressed/raw over the whole field."""
    raw = tree.n_nodes * (tc.width // 8)
    return 1.0 - tc.nbytes / raw
