"""Binary serialization of the fpdelta compressed forms for HDep records.

Wire layout (little-endian) — a sequence of sections, each
``[u32 tag][u64 nbytes][payload]``; tags: 1=json header, 2=codes words,
3=payload words, 4=raw array. Self-describing together with the record's
``codec`` + ``meta`` fields.
"""
from __future__ import annotations

import io
import json
import struct

import numpy as np

from ..core import fpdelta, pyramid
from .database import _dtype_of, register_codec

_HDR = struct.Struct("<IQ")


def _put(buf: io.BytesIO, tag: int, payload: bytes) -> None:
    buf.write(_HDR.pack(tag, len(payload)))
    buf.write(payload)


def _walk(data: bytes):
    off = 0
    while off < len(data):
        tag, n = _HDR.unpack_from(data, off)
        off += _HDR.size
        yield tag, data[off:off + n]
        off += n


def _block_to_bytes(buf: io.BytesIO, blk: fpdelta.Compressed) -> None:
    _put(buf, 1, json.dumps({
        "n_groups": blk.n_groups, "group_size": blk.group_size,
        "zbits": blk.zbits, "width": blk.width}).encode())
    _put(buf, 2, np.ascontiguousarray(blk.codes, np.uint32).tobytes())
    _put(buf, 3, np.ascontiguousarray(blk.payload, np.uint32).tobytes())


def _blocks_from_bytes(data: bytes) -> list[fpdelta.Compressed]:
    out = []
    hdr = codes = None
    for tag, payload in _walk(data):
        if tag == 1:
            hdr = json.loads(payload)
        elif tag == 2:
            codes = np.frombuffer(payload, np.uint32).copy()
        elif tag == 3:
            out.append(fpdelta.Compressed(
                codes=codes, payload=np.frombuffer(payload, np.uint32).copy(),
                **hdr))
    return out


def encode_pyramid(pc: pyramid.PyramidCompressed) -> bytes:
    buf = io.BytesIO()
    _put(buf, 4, np.ascontiguousarray(pc.root).tobytes())
    for blk in pc.levels:
        _block_to_bytes(buf, blk)
    return buf.getvalue()


def decode_pyramid_bytes(data: bytes, rec_meta: dict, dtype, shape) -> np.ndarray:
    blocks = _blocks_from_bytes(data)
    root = None
    for tag, payload in _walk(data):
        if tag == 4:
            root = np.frombuffer(payload, dtype=dtype).copy()
            break
    pc = pyramid.PyramidCompressed(levels=blocks, root=root, shape=tuple(shape),
                                   dtype=str(dtype), pad=rec_meta.get("pad", 0))
    return pyramid.decode_pyramid(pc)


def encode_delta(dc: pyramid.DeltaCompressed) -> bytes:
    buf = io.BytesIO()
    _block_to_bytes(buf, dc.block)
    return buf.getvalue()


def decode_delta_bytes(data: bytes, prev: np.ndarray, rec_meta: dict,
                       dtype, shape) -> np.ndarray:
    blk = _blocks_from_bytes(data)[0]
    dc = pyramid.DeltaCompressed(block=blk, shape=tuple(shape),
                                 dtype=str(dtype), pad=rec_meta.get("pad", 0))
    return pyramid.decode_delta(dc, prev)


def encode_tree_field(tc: fpdelta.TreeCompressed) -> bytes:
    buf = io.BytesIO()
    _put(buf, 4, np.ascontiguousarray(tc.root_raw).tobytes())
    _put(buf, 5, json.dumps({"level_groups": tc.level_groups,
                             "field": tc.field}).encode())
    _block_to_bytes(buf, tc.stream)
    return buf.getvalue()


def decode_tree_field_bytes(data: bytes, tree, field: str, width: int) -> np.ndarray:
    blocks = _blocks_from_bytes(data)
    root = meta = None
    for tag, payload in _walk(data):
        if tag == 4:
            root = np.frombuffer(
                payload, np.float64 if width == 64 else np.float32).copy()
        elif tag == 5:
            meta = json.loads(payload)
    tc = fpdelta.TreeCompressed(root_raw=root, stream=blocks[0],
                                level_groups=meta["level_groups"],
                                field=field, width=width)
    return fpdelta.decode_tree_field(tree, tc)


# ------------------------------------------------- codec registry entries

def _decode_fpdelta_pyramid(db, rec, payload: bytes) -> np.ndarray:
    return decode_pyramid_bytes(payload, rec.meta, _dtype_of(rec.dtype),
                                rec.shape)


def _encode_fpdelta_pyramid(arr: np.ndarray, *, zbits: int = 4
                            ) -> tuple[bytes, dict]:
    pc = pyramid.encode_pyramid(np.ascontiguousarray(arr), zbits=zbits)
    return encode_pyramid(pc), {"pad": pc.pad}


def _decode_fpdelta_delta(db, rec, payload: bytes) -> np.ndarray:
    # temporal father-son: the predictor is the same record in an earlier
    # context, read back through the database (self-describing chain)
    pred_step = int(rec.meta["pred_step"])
    prev = db.read(pred_step, rec.domain, rec.name)
    return decode_delta_bytes(payload, prev, rec.meta, _dtype_of(rec.dtype),
                              rec.shape)


def _encode_fpdelta_delta(arr: np.ndarray, *, prev: np.ndarray,
                          zbits: int = 4) -> tuple[bytes, dict]:
    """Caller must merge ``{"pred_step": <step of prev>}`` into the meta."""
    dc = pyramid.encode_delta(np.ascontiguousarray(arr), prev, zbits=zbits)
    return encode_delta(dc), {"pad": dc.pad}


register_codec("fpdelta-pyramid", decode=_decode_fpdelta_pyramid,
               encode=_encode_fpdelta_pyramid)
# "pyramid" is the user-facing alias (checkpoint mode names, docs); both
# names decode identically so either may appear in a record
register_codec("pyramid", decode=_decode_fpdelta_pyramid,
               encode=_encode_fpdelta_pyramid)
register_codec("fpdelta-delta", decode=_decode_fpdelta_delta,
               encode=_encode_fpdelta_delta)
# fpdelta-tree payloads need the assembled AMR tree structure to decode:
# the amr_tree ObjectKind drives them; record-level decode is unavailable
register_codec("fpdelta-tree", decode=None, encode=None)
