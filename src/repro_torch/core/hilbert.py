"""3D (n-D) Hilbert space-filling curve, vectorized (Skilling's algorithm).

RAMSES load-balances AMR cells over MPI ranks by sorting cells along a
Hilbert curve and cutting the curve into equal-count segments (paper §2.1:
"Because of the Hilbert space filling curve, domain boundaries of Ramses can
occur on leafs of the tree and at different levels"). We reproduce that
domain decomposition for the simulation substrate.

Reference: J. Skilling, "Programming the Hilbert curve", AIP Conf. Proc.
707 (2004). Transpose-form algorithm, vectorized over points with numpy.
"""
from __future__ import annotations

import numpy as np


def coords_to_key(coords: np.ndarray, bits: int, ndim: int = 3) -> np.ndarray:
    """Map integer coords (N, ndim) in [0, 2**bits) to Hilbert keys (N,)."""
    x = np.array(coords, dtype=np.uint64, copy=True)
    n = x.shape[0]
    if x.shape[1] != ndim:
        raise ValueError(f"coords must be (N, {ndim})")
    m = np.uint64(1) << np.uint64(bits - 1)
    # Inverse undo excess work
    q = m
    while q > 1:
        p = q - np.uint64(1)
        for i in range(ndim):
            flip = (x[:, i] & q) != 0
            # invert low bits of x[0] where flip
            x[:, 0] = np.where(flip, x[:, 0] ^ p, x[:, 0])
            # else exchange low bits of x[i] and x[0]
            t = (x[:, 0] ^ x[:, i]) & p
            t = np.where(flip, np.uint64(0), t)
            x[:, 0] ^= t
            x[:, i] ^= t
        q >>= np.uint64(1)
    # Gray encode
    for i in range(1, ndim):
        x[:, i] ^= x[:, i - 1]
    t = np.zeros(n, np.uint64)
    q = m
    while q > 1:
        t = np.where((x[:, ndim - 1] & q) != 0, t ^ (q - np.uint64(1)), t)
        q >>= np.uint64(1)
    for i in range(ndim):
        x[:, i] ^= t
    # Interleave transpose-form bits into a single key
    key = np.zeros(n, np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(ndim):
            bit = (x[:, i] >> np.uint64(b)) & np.uint64(1)
            key = (key << np.uint64(1)) | bit
    return key


def key_to_coords(keys: np.ndarray, bits: int, ndim: int = 3) -> np.ndarray:
    """Inverse of :func:`coords_to_key`."""
    keys = np.asarray(keys, np.uint64)
    n = keys.shape[0]
    x = np.zeros((n, ndim), np.uint64)
    # De-interleave into transpose form
    pos = bits * ndim
    for b in range(bits - 1, -1, -1):
        for i in range(ndim):
            pos -= 1
            bit = (keys >> np.uint64(pos)) & np.uint64(1)
            x[:, i] |= bit << np.uint64(b)
    # Gray decode
    m = np.uint64(1) << np.uint64(bits)
    t = x[:, ndim - 1] >> np.uint64(1)
    for i in range(ndim - 1, 0, -1):
        x[:, i] ^= x[:, i - 1]
    x[:, 0] ^= t
    # Undo excess work
    q = np.uint64(2)
    while q != m:
        p = q - np.uint64(1)
        for i in range(ndim - 1, -1, -1):
            flip = (x[:, i] & q) != 0
            x[:, 0] = np.where(flip, x[:, 0] ^ p, x[:, 0])
            tt = (x[:, 0] ^ x[:, i]) & p
            tt = np.where(flip, np.uint64(0), tt)
            x[:, 0] ^= tt
            x[:, i] ^= tt
        q <<= np.uint64(1)
    return x


def domain_split(keys: np.ndarray, n_domains: int) -> np.ndarray:
    """Assign each key's cell to a domain by equal-count Hilbert segments.

    Returns (N,) int32 domain ids. Ties broken by sort order, matching
    RAMSES' contiguous-curve-segment ownership.
    """
    order = np.argsort(keys, kind="stable")
    n = keys.shape[0]
    dom_of_rank = (np.arange(n, dtype=np.int64) * n_domains) // n
    out = np.empty(n, np.int32)
    out[order] = dom_of_rank.astype(np.int32)
    return out
