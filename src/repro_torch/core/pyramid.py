"""Father–son compression for dense ML tensors (paper technique -> ML).

Two predictors, both lossless (XOR residue):

  * **Spatial (pyramid)** — build an 8-way mean pyramid over the flattened
    tensor: level k+1 is the mean of 8 consecutive level-k values. The mean
    is an *intensive* restriction, exactly the AMR father the paper's codec
    assumes, so fathers predict sons well wherever the tensor is locally
    smooth (embeddings, layernorm scales, optimizer second moments).
  * **Temporal (delta)** — predictor = the same tensor from the previous
    checkpoint context; groups are 8 consecutive values sharing one
    leading-zero code. This is the paper's "different output frequency"
    HProt flow turned into delta-encoded checkpoint chains.

Both reuse :mod:`repro_torch.core.fpdelta` and decode exactly (bitwise), so
restart correctness is unaffected.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import fpdelta

GROUP = 8


def _width_of(dtype: np.dtype) -> int:
    name = np.dtype(dtype).name if not str(dtype) == "bfloat16" else "bfloat16"
    return {"float64": 64, "float32": 32, "bfloat16": 16}[str(name)]


def _pad_flat(x: np.ndarray) -> tuple[np.ndarray, int]:
    flat = np.asarray(x).reshape(-1)
    pad = (-flat.size) % GROUP
    if pad:
        filler = flat[-1] if flat.size else 0
        flat = np.concatenate([flat, np.full(pad, filler, flat.dtype)])
    return flat, pad


@dataclasses.dataclass
class PyramidCompressed:
    levels: list[fpdelta.Compressed]   # fine -> coarse order
    root: np.ndarray                   # coarsest level, raw
    shape: tuple
    dtype: str
    pad: int

    @property
    def nbytes(self) -> int:
        return self.root.nbytes + sum(c.nbytes for c in self.levels)


def encode_pyramid(x: np.ndarray, *, zbits: int = 4,
                   min_root: int = 512) -> PyramidCompressed:
    """Compress a tensor against its own 8-way mean pyramid."""
    width = _width_of(x.dtype)
    flat, pad = _pad_flat(x)
    # build mean pyramid in float64 reduced precision of source dtype:
    # fathers must be representable in the source dtype so the decoder can
    # rebuild them exactly -> cast each level back to the source dtype.
    levels_vals = [flat]
    while levels_vals[-1].size > max(min_root, GROUP):
        cur = levels_vals[-1]
        nxt_size = cur.size // GROUP
        trunc = cur[:nxt_size * GROUP].reshape(nxt_size, GROUP)
        nxt = trunc.astype(np.float64).mean(axis=1).astype(cur.dtype)
        nxt, _ = _pad_flat(nxt)
        levels_vals.append(nxt)
    blocks = []
    for k in range(len(levels_vals) - 1):
        sons = levels_vals[k]
        fathers = levels_vals[k + 1][: sons.size // GROUP]
        blocks.append(fpdelta.encode(fathers, sons.reshape(-1, GROUP),
                                     zbits=zbits, width=width))
    return PyramidCompressed(levels=blocks, root=np.asarray(levels_vals[-1]).copy(),
                             shape=tuple(np.asarray(x).shape), dtype=str(x.dtype),
                             pad=pad)


def decode_pyramid(pc: PyramidCompressed) -> np.ndarray:
    cur = pc.root
    for blk in reversed(pc.levels):
        fathers = cur[: blk.n_groups]
        cur = fpdelta.decode(blk, fathers).reshape(-1)
    n = int(np.prod(pc.shape)) if pc.shape else 1
    out = cur[:n].reshape(pc.shape)
    return out


@dataclasses.dataclass
class DeltaCompressed:
    block: fpdelta.Compressed
    shape: tuple
    dtype: str
    pad: int

    @property
    def nbytes(self) -> int:
        return self.block.nbytes


def encode_delta(x: np.ndarray, prev: np.ndarray, *, zbits: int = 4) -> DeltaCompressed:
    """Compress ``x`` against the previous-context tensor ``prev``."""
    width = _width_of(x.dtype)
    flat, pad = _pad_flat(x)
    pflat, _ = _pad_flat(np.asarray(prev, dtype=np.asarray(x).dtype))
    assert flat.size == pflat.size, "temporal predictor shape mismatch"
    blk = fpdelta.encode(pflat.reshape(-1, GROUP), flat.reshape(-1, GROUP),
                         zbits=zbits, width=width)
    return DeltaCompressed(block=blk, shape=tuple(np.asarray(x).shape),
                           dtype=str(x.dtype), pad=pad)


def decode_delta(dc: DeltaCompressed, prev: np.ndarray) -> np.ndarray:
    pflat, _ = _pad_flat(np.asarray(prev))
    out = fpdelta.decode(dc.block, pflat.reshape(-1, GROUP)).reshape(-1)
    n = int(np.prod(dc.shape)) if dc.shape else 1
    return out[:n].reshape(dc.shape)
