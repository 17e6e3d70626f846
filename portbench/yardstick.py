"""The yardstick: what portbench measures with, kept apart from the port.

Token stream, device peaks, the reduction of a profiler trace to busy
time and idle gaps, tensor statistics and the gaps that decide
``correct``. A model's FLOP count is its reference module's. Nothing here imports the port, so a change
to ``repro_torch`` cannot move it.
"""
from __future__ import annotations

import bisect
import itertools
import math

import numpy as np

# ------------------------------------------------------------ token stream


def _hash64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer, vectorized (the port's data pipeline's)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class TokenStream:
    """Token batches as a pure function of (seed, step, row, position):
    a counter hash mapped through a Zipf CDF over the vocabulary. The
    arithmetic of ``repro_torch/data/pipeline.py`` (``TokenPipeline``),
    copied so that the inputs stay fixed whatever the port does.
    ``batch(step)`` gives int32 ``tokens`` and ``labels`` of shape
    (batch, seq), the labels shifted by one position."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int, zipf: float):
        self.vocab_size, self.seq_len, self.rows = vocab_size, seq_len, batch
        self.seed = int(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        w = 1.0 / ranks ** zipf
        self.cdf = np.cumsum(w) / w.sum()

    def batch(self, step: int) -> dict:
        b_idx = np.arange(self.rows, dtype=np.uint64)[:, None]
        s_idx = np.arange(self.seq_len + 1, dtype=np.uint64)[None, :]
        key = (np.uint64(self.seed) * np.uint64(0x1000003)
               + np.uint64(step) * np.uint64(0x85EBCA77))
        h = _hash64(key + b_idx * np.uint64(1_000_003) + s_idx)
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = np.searchsorted(self.cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, self.vocab_size - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ------------------------------------------------------------ peaks

#: published dense peaks of one card (NVIDIA's data sheets, SXM parts,
#: no sparsity), by ``torch.cuda.get_device_name()``
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                              "tf32_flops": 495e12, "hbm_bytes": 3.35e12},
}


# ---------------------------------------------------------- device trace


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps in [lo, hi] that no interval covers, in time order."""
    gaps, at = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def outermost(ops) -> list:
    """The (start, end, name, thread) ops that no other op of their
    thread encloses: what the host was doing at the top of its stack."""
    out, end = [], {}
    for op in sorted(ops, key=lambda o: (o[3], o[0], -o[1])):
        if op[0] >= end.get(op[3], -math.inf):
            out.append(op)
            end[op[3]] = op[1]
    return out


class HostOps:
    """Host ops (start, end, name, thread) indexed for :meth:`during`:
    each thread's sorted by start, beside the running maximum of their
    ends (no op before the first whose running end passes a time can
    reach that time)."""

    def __init__(self, ops):
        by: dict = {}
        for s, e, n, t in sorted(ops):
            by.setdefault(t, []).append((s, e, n))
        self.threads = [(o, list(itertools.accumulate(
            (e for _, e, _ in o), max))) for o in by.values()]

    def during(self, gap) -> str:
        """What the host was doing in ``gap``: the name of the op that
        overlaps it most, else ``python`` (host time between ops)."""
        best, name = 0.0, "python"
        for ops, ends in self.threads:
            i = bisect.bisect_right(ends, gap[0])
            while i < len(ops) and ops[i][0] < gap[1]:
                s, e, n = ops[i]
                ov = min(e, gap[1]) - max(s, gap[0])
                if ov > best:
                    best, name = ov, n
                i += 1
        return name


def top_by_name(pairs, n: int = 10) -> list[list]:
    """[[name, total seconds], ...] of (name, seconds) pairs, largest first."""
    tot: dict = {}
    for name, sec in pairs:
        tot[name] = tot.get(name, 0.0) + sec
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])][:n]


# ------------------------------------------------------- what is compared

def tensor_stats(x) -> list[float]:
    """(l2, rms, absmax, mean) of a tensor, in float64."""
    x = x.detach().double()
    l2 = float(x.norm())
    return [l2, l2 / math.sqrt(x.numel()), float(x.abs().max()),
            float(x.mean())]


def gap_of_norms(prog: dict, ref: dict, keep=None) -> float:
    """Worst leaf's |prog norm - ref norm| over the larger of the ref
    leaf's norm and the median ref leaf's; ``keep`` names the leaves
    that count (all by default). A leaf missing on one side reads inf."""
    names = [k for k in ref if keep is None or k in keep]
    if not names:
        return math.inf
    med = float(np.median([ref[k] for k in names]))
    worst = 0.0
    for k in names:
        if k not in prog or not math.isfinite(prog[k]):
            return math.inf
        worst = max(worst, abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300))
    return worst


def stats_gap(prog: dict, ref: dict) -> float:
    """Worst gap between two {leaf: (l2, rms, absmax, mean)} tables: l2,
    rms and absmax against the reference's own value, the mean against
    the reference's rms. Leaves that differ between the two read inf."""
    if set(prog) != set(ref) or not ref:
        return math.inf
    worst = 0.0
    for k, r in ref.items():
        p = prog[k]
        scales = (r[0], r[1], r[2], r[1])
        for a, b, sc in zip(p, r, scales):
            if not math.isfinite(a):
                return math.inf
            worst = max(worst, abs(a - b) / max(abs(sc), 1e-300))
    return worst


def rel_gap(prog: list, ref: list) -> float:
    """Worst |prog - ref| / |ref| over paired readings (inf on a
    missing or non-finite one)."""
    if len(prog) != len(ref) or not ref:
        return math.inf
    worst = 0.0
    for a, b in zip(prog, ref):
        if not math.isfinite(a):
            return math.inf
        worst = max(worst, abs(a - b) / max(abs(b), 1e-300))
    return worst
