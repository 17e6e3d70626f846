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

bfloat16 crosses as its bits: a numpy ``uint16`` array with
``dtype="bfloat16"`` (or a ``torch.bfloat16`` tensor, viewed so), and
decodes back to ``uint16`` bits; the streams are the ones the reference
writes from ``ml_dtypes`` arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bitstream as bs
from . import fpdelta

GROUP = 8

_WIDTHS = {"float64": 64, "float32": 32, "bfloat16": 16}


def dtype_name(dtype) -> str:
    """numpy's name of a numpy or torch dtype, or of a name."""
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _width_of(dtype) -> int:
    return _WIDTHS[dtype_name(dtype)]


def host_bits(x, dtype=None) -> tuple[np.ndarray, str]:
    """``x`` as a host numpy array and its dtype name; bfloat16 (a torch
    tensor, or an array numpy names "bfloat16") as ``uint16`` bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), dtype_name(x.dtype)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16), "bfloat16"
    return x, dtype or x.dtype.name


def _mean8(trunc: np.ndarray, name: str) -> np.ndarray:
    """Each row's float64 mean, rounded to the source dtype."""
    if name == "bfloat16":
        mean = bs.bf16_bits_to_f32(trunc).astype(np.float64).mean(axis=1)
        return bs.f32_to_bf16_bits(mean.astype(np.float32))
    return trunc.astype(np.float64).mean(axis=1).astype(trunc.dtype)


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
                   min_root: int = 512, dtype=None) -> PyramidCompressed:
    """Compress a tensor against its own 8-way mean pyramid.

    ``dtype="bfloat16"`` marks a ``uint16`` array as bfloat16 bits.
    """
    x, name = host_bits(x, dtype)
    width = _width_of(name)
    flat, pad = _pad_flat(x)
    # build mean pyramid in float64 reduced precision of source dtype:
    # fathers must be representable in the source dtype so the decoder can
    # rebuild them exactly -> cast each level back to the source dtype.
    levels_vals = [flat]
    while levels_vals[-1].size > max(min_root, GROUP):
        cur = levels_vals[-1]
        nxt_size = cur.size // GROUP
        trunc = cur[:nxt_size * GROUP].reshape(nxt_size, GROUP)
        nxt = _mean8(trunc, name)
        nxt, _ = _pad_flat(nxt)
        levels_vals.append(nxt)
    blocks = []
    for k in range(len(levels_vals) - 1):
        sons = levels_vals[k]
        fathers = levels_vals[k + 1][: sons.size // GROUP]
        blocks.append(fpdelta.encode(fathers, sons.reshape(-1, GROUP),
                                     zbits=zbits, width=width))
    return PyramidCompressed(levels=blocks, root=np.asarray(levels_vals[-1]).copy(),
                             shape=tuple(x.shape), dtype=name, pad=pad)


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


def encode_delta(x: np.ndarray, prev: np.ndarray, *, zbits: int = 4,
                 dtype=None) -> DeltaCompressed:
    """Compress ``x`` against the previous-context tensor ``prev``.

    ``dtype="bfloat16"`` marks ``uint16`` arrays as bfloat16 bits.
    """
    x, name = host_bits(x, dtype)
    prev, _ = host_bits(prev, name)
    width = _width_of(name)
    flat, pad = _pad_flat(x)
    pflat, _ = _pad_flat(np.asarray(prev, dtype=x.dtype))
    assert flat.size == pflat.size, "temporal predictor shape mismatch"
    blk = fpdelta.encode(pflat.reshape(-1, GROUP), flat.reshape(-1, GROUP),
                         zbits=zbits, width=width)
    return DeltaCompressed(block=blk, shape=tuple(x.shape), dtype=name,
                           pad=pad)


def decode_delta(dc: DeltaCompressed, prev: np.ndarray) -> np.ndarray:
    pflat, _ = _pad_flat(np.asarray(prev))
    out = fpdelta.decode(dc.block, pflat.reshape(-1, GROUP)).reshape(-1)
    n = int(np.prod(dc.shape)) if dc.shape else 1
    return out[:n].reshape(dc.shape)
