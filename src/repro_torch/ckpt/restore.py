"""Verified HProt restore: per-record checksums + delta-chain integrity.

Restore is the one moment where protection data must be *proven* good:
a checkpoint that restores garbage is worse than no checkpoint. Two
layers (DESIGN.md §16):

  * **record integrity** — every payload read back on the restore path
    is length-checked against the manifest and CRC32-verified against
    the ``crc32`` the async manager stamped into the record meta at
    write time. Any mismatch (missing file, truncated append, bit rot)
    raises :class:`CorruptShardError` naming the record, instead of
    silently materializing wrong weights.
  * **chain integrity** — ``fpdelta-delta`` records replay their
    temporal predecessor chain through the same verified decode, so a
    corrupt link anywhere under a delta checkpoint surfaces even when
    the top record itself is pristine.

:func:`latest_complete_step` is the pre-restore filter: a context whose
manifest references missing/truncated files — or whose delta chain
crosses such a context — is skipped and the newest *complete* step
wins (kill-mid-save recovery: the half-landed step never had a
manifest, and a half-durable one is detected here).
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np

from ..hercule.codecs import decode_delta_bytes
from ..hercule.database import HerculeDB, Record, _dtype_of, get_codec


class CorruptShardError(RuntimeError):
    """A checkpoint shard failed integrity verification on restore."""


def verify_payload(db: HerculeDB, step: int, rec: Record) -> bytes:
    """Read one record's payload, proving length + CRC32 first."""
    try:
        payload = db.read_payload(rec)
    except FileNotFoundError as e:
        raise CorruptShardError(
            f"step {step}: data file {rec.file!r} referenced by "
            f"({rec.domain}, {rec.name!r}) is missing") from e
    if len(payload) != rec.nbytes:
        raise CorruptShardError(
            f"step {step}: record ({rec.domain}, {rec.name!r}) is "
            f"truncated: {len(payload)} of {rec.nbytes} bytes in "
            f"{rec.file!r}@{rec.offset}")
    crc = rec.meta.get("crc32")
    if crc is not None and (zlib.crc32(payload) & 0xFFFFFFFF) != int(crc):
        raise CorruptShardError(
            f"step {step}: record ({rec.domain}, {rec.name!r}) failed "
            f"its CRC32 check ({rec.file!r}@{rec.offset}, "
            f"{rec.nbytes} bytes)")
    return payload


def decode_verified(db: HerculeDB, step: int, rec: Record) -> np.ndarray:
    """Decode one record, verifying every link of its delta chain.

    ``fpdelta-delta`` predecessors are resolved record-by-record (same
    domain + name in ``meta["pred_step"]``'s context) and decoded
    through this same function, so the whole temporal chain down to the
    last full rebase is checksum-verified — a bit flip in any ancestor
    surfaces as :class:`CorruptShardError`, not as silently wrong
    weights.
    """
    payload = verify_payload(db, step, rec)
    if rec.codec == "fpdelta-delta":
        pred_step = int(rec.meta["pred_step"])
        try:
            pview = db.view(pred_step)
        except FileNotFoundError as e:
            raise CorruptShardError(
                f"step {step}: delta record ({rec.domain}, {rec.name!r}) "
                f"references missing predecessor context {pred_step}") from e
        try:
            pred = pview.record(rec.domain, rec.name)
        except KeyError as e:
            raise CorruptShardError(
                f"step {step}: predecessor context {pred_step} has no "
                f"record ({rec.domain}, {rec.name!r})") from e
        prev = decode_verified(db, pred_step, pred)
        return decode_delta_bytes(payload, prev, rec.meta,
                                  _dtype_of(rec.dtype), rec.shape)
    return get_codec(rec.codec).decode(db, rec, payload)


def verified_reader(db: HerculeDB, step: int):
    """Batched-record reader injectable into ``ObjectKind.read_region``."""
    def read(recs):
        return [decode_verified(db, step, r) for r in recs]
    return read


# ------------------------------------------------------- completeness scan

def _complete(db: HerculeDB, step: int, memo: dict) -> bool:
    got = memo.get(step)
    if got is not None:
        return got
    memo[step] = False   # cycle guard: a predecessor loop is corruption
    try:
        idx = db.load_index(step)
    except (FileNotFoundError, json.JSONDecodeError, KeyError, TypeError):
        return False
    sizes: dict[str, int] = {}
    for rec in idx["records"]:
        size = sizes.get(rec.file)
        if size is None:
            path = os.path.join(db.root, "data", rec.file)
            size = os.path.getsize(path) if os.path.exists(path) else -1
            sizes[rec.file] = size
        if rec.offset + rec.nbytes > size:
            return False
        if rec.codec == "fpdelta-delta" and \
                not _complete(db, int(rec.meta["pred_step"]), memo):
            return False
    memo[step] = True
    return True


def context_complete(db: HerculeDB, step: int) -> bool:
    """True when every referenced payload extent is on disk, and every
    delta predecessor context is itself complete (recursively)."""
    return _complete(db, step, {})


def latest_complete_step(db: HerculeDB) -> int | None:
    """Newest step whose manifest — and delta chain — is fully durable.

    Steps referencing missing or truncated data files (a crash between
    manifest commit and disk sync on a non-ordered filesystem, manual
    deletion, partial copy) are skipped; the completeness memo is shared
    across candidates so each chain is checked once.
    """
    memo: dict[int, bool] = {}
    for step in reversed(db.contexts()):
        if _complete(db, step, memo):
            return step
    return None
