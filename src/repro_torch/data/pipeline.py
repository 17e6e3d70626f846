"""Deterministic synthetic token pipeline, shardable by host.

Tokens are a pure function of (seed, step, batch row, position) via a
counter-based hash, so (a) any host can produce exactly its shard without
coordination, and (b) restart-at-step-k reproduces the same stream —
which is what makes the crash/restart integration test bitwise exact.
A Zipf-ish transform skews the id distribution so losses move like real
text rather than uniform noise.

The pipeline stays numpy, and is the JAX package's line for line, so
its tokens are bitwise the reference's for every (seed, step,
host_index, host_count): a run can restart in either package on the
same stream. The trainer moves a batch to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf: float = 1.1


def _hash64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer, vectorized."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # zipf-ish CDF over vocab for realistic id frequencies
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        w = 1.0 / ranks ** cfg.zipf
        self.cdf = np.cumsum(w) / w.sum()

    def batch(self, step: int, *, host_index: int = 0, host_count: int = 1):
        """Return this host's shard {'tokens','labels'} for ``step``."""
        cfg = self.cfg
        rows = cfg.global_batch // host_count
        row0 = host_index * rows
        b_idx = (np.arange(rows, dtype=np.uint64) + np.uint64(row0))[:, None]
        s_idx = np.arange(cfg.seq_len + 1, dtype=np.uint64)[None, :]
        key = (np.uint64(cfg.seed) * np.uint64(0x1000003)
               + np.uint64(step) * np.uint64(0x85EBCA77))
        h = _hash64(key + b_idx * np.uint64(1_000_003) + s_idx)
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        toks = np.searchsorted(self.cdf, u).astype(np.int32)
        toks = np.clip(toks, 0, cfg.vocab_size - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
