"""Hercule database: contexts, domains, contributor groups, file rollover.

Layout (paper §2, "one file-for-multiple-processes"):

    <root>/db.json                  database manifest (kind, ncf, limits)
    <root>/data/g<G>_<F>.hrc        group G's F-th physical file; contexts
                                    append until max_file_bytes -> rollover
    <root>/ctx_<STEP>/MANIFEST.json per-context object index (atomic)

A simulation with N contributors and NCF=P creates ceil(N/P) files per
rollover generation — the paper's 16x file-count reduction at NCF=16.
Record index entries carry (file, offset, nbytes, dtype, shape, codec,
codec_meta), making every context self-describing: a reader needs nothing
but this directory.

Crash safety: data bytes are appended + flushed first, the context
manifest is written to a temp file, fsync'd, then atomically renamed.
A context without MANIFEST.json is invisible to readers.

Concurrency model: one writer owns a group file at a time (Hercule's
aggregation — the group leader writes for its contributors), so there is
no shared-file locking; different groups write in parallel threads
(`io_threads`), standing in for Lustre stripe_count = NCF (DESIGN.md §8).
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import json
import os
import re
import threading

import numpy as np

_DTYPES = {"bool": np.bool_}

_CTX_RE = re.compile(r"^ctx_(\d+)$")


def _dtype_of(name: str):
    if name == "bfloat16":
        # numpy has no bfloat16 of its own (the reference reads these
        # records through ml_dtypes): the port reads their 2-byte
        # payloads as uint16 bits, which core.pyramid and
        # hercule.checkpoint carry with the name "bfloat16"
        return np.dtype(np.uint16)
    return np.dtype(_DTYPES.get(name, name))


# ----------------------------------------------------------- codec registry

@dataclasses.dataclass(frozen=True)
class Codec:
    """One record codec: how payload bytes become an array and back.

    ``decode(db, rec, payload) -> np.ndarray`` must be able to rebuild the
    array from the record alone (codecs with cross-context predictors, like
    ``fpdelta-delta``, may read other contexts through ``db``).
    ``encode(arr, **opts) -> (payload, meta)`` is optional: codecs that
    need out-of-band structure to encode (e.g. ``fpdelta-tree`` needs the
    AMR tree) are write-side-only and are driven by their ObjectKind.
    """
    name: str
    decode: object
    encode: object = None


_CODECS: dict[str, Codec] = {}


def register_codec(name: str, *, decode, encode=None) -> Codec:
    """Register (or replace) a record codec under ``name``."""
    codec = Codec(name=name, decode=decode, encode=encode)
    _CODECS[name] = codec
    return codec


def codec_names() -> list[str]:
    """Names of all registered codecs (importing the standard set)."""
    from . import codecs  # noqa: F401  (registers fpdelta-*/pyramid)
    return sorted(_CODECS)


def get_codec(name: str) -> Codec:
    codec = _CODECS.get(name)
    if codec is None:
        # the fpdelta family registers on first import of .codecs; a bare
        # `from repro_torch.hercule.database import ...` may predate that
        from . import codecs  # noqa: F401
        codec = _CODECS.get(name)
    if codec is None:
        raise ValueError(
            f"unknown codec {name!r}; registered codecs: {sorted(_CODECS)}")
    return codec


def _decode_raw(db, rec, payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, dtype=_dtype_of(rec.dtype)) \
        .reshape(rec.shape).copy()


def _encode_raw(arr: np.ndarray) -> tuple[bytes, dict]:
    return np.ascontiguousarray(arr).tobytes(), {}


def _decode_boolrle(db, rec, payload: bytes) -> np.ndarray:
    from ..core import boolcodec
    return boolcodec.decode(payload, n=int(np.prod(rec.shape))) \
        .reshape(rec.shape)


def _encode_boolrle(arr: np.ndarray) -> tuple[bytes, dict]:
    from ..core import boolcodec
    return boolcodec.encode(np.ascontiguousarray(arr, dtype=bool)), {}


register_codec("raw", decode=_decode_raw, encode=_encode_raw)
register_codec("boolrle", decode=_decode_boolrle, encode=_encode_boolrle)


@dataclasses.dataclass
class Record:
    name: str
    domain: int
    file: str
    offset: int
    nbytes: int
    dtype: str
    shape: tuple
    codec: str = "raw"
    meta: dict = dataclasses.field(default_factory=dict)

    def to_json(self):
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        return d

    @staticmethod
    def from_json(d):
        d = dict(d)
        d["shape"] = tuple(d["shape"])
        return Record(**d)


class _GroupFiles:
    """Append-only physical files of one contributor group, with rollover."""

    def __init__(self, data_dir: str, group: int, max_file_bytes: int):
        self.data_dir = data_dir
        self.group = group
        self.max_file_bytes = max_file_bytes
        self.findex = -1
        self.fh = None
        self.offset = 0
        self.lock = threading.Lock()
        # resume after existing files
        while os.path.exists(self._path(self.findex + 1)):
            self.findex += 1
        if self.findex >= 0:
            self.offset = os.path.getsize(self._path(self.findex))

    def _path(self, fi: int) -> str:
        return os.path.join(self.data_dir, f"g{self.group:05d}_{fi:04d}.hrc")

    def _ensure_open(self):
        if self.fh is None or self.offset >= self.max_file_bytes:
            if self.fh is not None:
                self.fh.close()
                self.fh = None
            if self.findex < 0 or self.offset >= self.max_file_bytes:
                self.findex += 1
                self.offset = 0
            self.fh = open(self._path(self.findex), "ab")
            self.offset = self.fh.tell()

    def append(self, payload: bytes) -> tuple[str, int]:
        """Returns (file basename, offset)."""
        with self.lock:
            self._ensure_open()
            off = self.offset
            self.fh.write(payload)
            self.offset += len(payload)
            return os.path.basename(self._path(self.findex)), off

    def flush(self, sync: bool = True):
        """Flush buffered appends; ``sync=False`` stops at the page cache
        (enough for another process to fsync the file by path)."""
        with self.lock:
            if self.fh is not None:
                self.fh.flush()
                if sync:
                    os.fsync(self.fh.fileno())

    def close(self):
        with self.lock:
            if self.fh is not None:
                self.fh.close()
                self.fh = None


class HerculeDB:
    """One Hercule database (HProt or HDep flavor via ``kind``)."""

    def __init__(self, root: str, manifest: dict):
        self.root = root
        self.kind = manifest["kind"]
        self.ncf = int(manifest["ncf"])
        self.max_file_bytes = int(manifest["max_file_bytes"])
        self.io_threads = int(manifest.get("io_threads", 4))
        self._groups: dict[int, _GroupFiles] = {}
        self._glock = threading.Lock()
        self._views: collections.OrderedDict = collections.OrderedDict()
        self._view_cache_entries = 16
        self._vlock = threading.Lock()
        self._read_pool: cf.ThreadPoolExecutor | None = None
        os.makedirs(os.path.join(root, "data"), exist_ok=True)

    # ------------------------------------------------------------- setup
    @staticmethod
    def create(root: str, *, kind: str = "hprot", ncf: int = 8,
               max_file_bytes: int = 2 << 30, io_threads: int = 4,
               exist_ok: bool = True) -> "HerculeDB":
        assert kind in ("hprot", "hdep")
        os.makedirs(root, exist_ok=exist_ok)
        manifest = {"kind": kind, "ncf": ncf, "max_file_bytes": max_file_bytes,
                    "io_threads": io_threads, "format_version": 1}
        path = os.path.join(root, "db.json")
        if os.path.exists(path):
            # the database already exists: its on-disk manifest governs
            # (the files were laid out under *that* ncf/rollover) — a
            # handle built from the requested parameters would disagree
            # with every other opener about group->file mapping
            with open(path) as f:
                manifest = json.load(f)
        else:
            with open(path, "w") as f:
                json.dump(manifest, f, indent=1)
        return HerculeDB(root, manifest)

    @staticmethod
    def open(root: str) -> "HerculeDB":
        with open(os.path.join(root, "db.json")) as f:
            return HerculeDB(root, json.load(f))

    # ------------------------------------------------------------ groups
    def group_of(self, domain: int) -> int:
        return domain // self.ncf

    def _group_files(self, group: int) -> _GroupFiles:
        with self._glock:
            if group not in self._groups:
                self._groups[group] = _GroupFiles(
                    os.path.join(self.root, "data"), group, self.max_file_bytes)
            return self._groups[group]

    def n_files(self) -> int:
        return len([f for f in os.listdir(os.path.join(self.root, "data"))
                    if f.endswith(".hrc")])

    # ---------------------------------------------------------- contexts
    def begin_context(self, step: int) -> "ContextWriter":
        return ContextWriter(self, step)

    def contexts(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            m = _CTX_RE.match(d)
            # stray ctx_* directories with non-numeric suffixes (editor
            # droppings, aborted tooling) are not contexts: skip them
            if m and os.path.exists(
                    os.path.join(self.root, d, "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_context(self) -> int | None:
        cs = self.contexts()
        return cs[-1] if cs else None

    def _ctx_dir(self, step: int) -> str:
        return os.path.join(self.root, f"ctx_{step:08d}")

    def load_index(self, step: int) -> dict:
        with open(os.path.join(self._ctx_dir(step), "MANIFEST.json")) as f:
            raw = json.load(f)
        return {"step": raw["step"],
                "attrs": raw.get("attrs", {}),
                "records": [Record.from_json(r) for r in raw["records"]]}

    # ------------------------------------------------------------ reading
    def view(self, step: int):
        """Indexed :class:`~repro_torch.hercule.api.ContextView` of one context.

        The context manifest is parsed once and the view cached (contexts
        are immutable once finalized); every read entry point routes
        through here instead of re-parsing MANIFEST.json per read.
        """
        from .api import ContextView
        with self._vlock:
            v = self._views.get(step)
            if v is not None:
                self._views.move_to_end(step)
                return v
        v = ContextView(self, step)
        with self._vlock:
            v = self._views.setdefault(step, v)
            self._views.move_to_end(step)
            while len(self._views) > self._view_cache_entries:
                self._views.popitem(last=False)
        return v

    def _invalidate_view(self, step: int) -> None:
        with self._vlock:
            self._views.pop(step, None)

    def _reader_pool(self) -> cf.ThreadPoolExecutor:
        """Shared decode pool for batched reads (read-path ``io_threads``)."""
        with self._vlock:
            if self._read_pool is None:
                self._read_pool = cf.ThreadPoolExecutor(
                    max_workers=max(1, self.io_threads),
                    thread_name_prefix="hercule-read")
            return self._read_pool

    def flush_domain(self, domain: int, sync: bool = True) -> None:
        """Flush the group file holding ``domain``'s appended records.

        Lets each contributor flush its own group independently (and in
        parallel with other groups) instead of funneling every group's
        fsync through the single finalize call — the finalize flush then
        finds those pages already clean. ``sync=False`` publishes the
        bytes to the page cache only: a lane process hands durability to
        whoever commits the manifest (see :meth:`fsync_files`).
        """
        with self._glock:
            gf = self._groups.get(self.group_of(domain))
        if gf is not None:
            gf.flush(sync)

    def fsync_files(self, names) -> None:
        """fsync data files by basename — bytes another process appended.

        The multi-process lane runtime's finalize hook: each lane flushes
        its appends to the page cache (``flush_domain(sync=False)``) and
        the manifest committer makes exactly the referenced files durable
        before the atomic manifest rename.
        """
        for name in sorted(set(names)):
            fd = os.open(os.path.join(self.root, "data", name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)

    def commit_context(self, step: int, records, attrs: dict | None = None
                       ) -> None:
        """Commit a context manifest for records appended elsewhere.

        The HProt manifest commit protocol (DESIGN.md §16): durability
        strictly before visibility. Writer lanes appended the payloads
        and published them to the page cache (``flush_domain(sync=
        False)``); here exactly the data files the manifest references
        are fsynced, then the manifest is written to a temp file,
        fsynced and atomically renamed — a context either commits
        completely or stays invisible to every reader.
        """
        records = list(records)
        # publish any appends made through *this* handle (DomainWriter
        # in the committing process, e.g. a run-ledger flush) to the
        # page cache first — fsync_files syncs by path and would
        # otherwise durably commit a file whose tail still sits in a
        # user-space buffer
        with self._glock:
            groups = list(self._groups.values())
        for g in groups:
            g.flush(sync=False)
        self.fsync_files(r.file for r in records)
        ctx_dir = self._ctx_dir(step)
        os.makedirs(ctx_dir, exist_ok=True)
        manifest = {"step": int(step), "attrs": dict(attrs or {}),
                    "records": [r.to_json() for r in records]}
        path = os.path.join(ctx_dir, "MANIFEST.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._invalidate_view(step)

    def read_payload(self, rec: Record) -> bytes:
        with open(os.path.join(self.root, "data", rec.file), "rb") as f:
            f.seek(rec.offset)
            return f.read(rec.nbytes)

    def read(self, step: int, domain: int, name: str) -> np.ndarray:
        return self.view(step).read(domain, name)

    def records(self, step: int, name: str | None = None,
                domain: int | None = None) -> list[Record]:
        return self.view(step).select(names=name, domains=domain)

    def close(self):
        for g in self._groups.values():
            g.close()
        with self._vlock:
            pool, self._read_pool = self._read_pool, None
            self._views.clear()
        if pool is not None:
            pool.shutdown(wait=True)


class ContextWriter:
    """Writer for one context; thread-safe across domains/groups."""

    def __init__(self, db: HerculeDB, step: int):
        self.db = db
        self.step = step
        self.records: list[Record] = []
        self.attrs: dict = {}
        self._lock = threading.Lock()
        self._pool = cf.ThreadPoolExecutor(max_workers=db.io_threads,
                                           thread_name_prefix="hercule-io")
        self._futures: list[cf.Future] = []
        os.makedirs(db._ctx_dir(step), exist_ok=True)

    # ------------------------------------------------------------- write
    def write_bytes(self, domain: int, name: str, payload: bytes, *,
                    dtype: str = "uint8", shape: tuple | None = None,
                    codec: str = "raw", meta: dict | None = None) -> None:
        group = self.db.group_of(domain)
        gf = self.db._group_files(group)
        fname, off = gf.append(payload)
        rec = Record(name=name, domain=domain, file=fname, offset=off,
                     nbytes=len(payload), dtype=dtype,
                     shape=tuple(shape if shape is not None else (len(payload),)),
                     codec=codec, meta=meta or {})
        with self._lock:
            self.records.append(rec)

    def write_array(self, domain: int, name: str, arr: np.ndarray, *,
                    codec: str = "raw", meta: dict | None = None) -> None:
        arr = np.ascontiguousarray(arr)
        # hand the buffered writer the array's own buffer: no tobytes()
        # memcpy (which would hold the GIL for the whole copy), and the
        # actual write syscall runs GIL-released — parallel contributor
        # lanes overlap their appends
        try:
            payload = arr.data.cast("B")
        except (TypeError, ValueError, BufferError):
            # zero-in-shape views can't cast; extension dtypes
            # (bfloat16) can't export a buffer at all
            payload = arr.tobytes()
        self.write_bytes(domain, name, payload, dtype=str(arr.dtype),
                         shape=arr.shape, codec=codec, meta=meta)

    def submit(self, fn, *args) -> None:
        """Queue an I/O closure on the writer pool (parallel group writes)."""
        self._futures.append(self._pool.submit(fn, *args))

    # ---------------------------------------------------------- finalize
    def finalize(self, attrs: dict | None = None) -> None:
        for fut in self._futures:
            fut.result()  # surfaces writer exceptions
        self._pool.shutdown(wait=True)
        for g in self.db._groups.values():
            g.flush()
        manifest = {"step": self.step, "attrs": {**self.attrs, **(attrs or {})},
                    "records": [r.to_json() for r in self.records]}
        path = os.path.join(self.db._ctx_dir(self.step), "MANIFEST.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic commit
        self.db._invalidate_view(self.step)  # drop any stale cached view

    def abort(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class DomainWriter:
    """Record-collecting writer for one contributor's part of a context.

    The multi-process shape of :class:`ContextWriter`: a lane process
    appends its payloads to its own group files and keeps the
    :class:`Record` entries, but the context *manifest* is committed
    elsewhere (the engine collects every lane's records and finalizes
    once). Quacks like ``ContextWriter`` for the ObjectKind writers; no
    thread pool, no context directory, no finalize.
    """

    def __init__(self, db: HerculeDB, step: int):
        self.db = db
        self.step = step
        self.records: list[Record] = []

    def write_bytes(self, domain: int, name: str, payload: bytes, *,
                    dtype: str = "uint8", shape: tuple | None = None,
                    codec: str = "raw", meta: dict | None = None) -> None:
        gf = self.db._group_files(self.db.group_of(domain))
        fname, off = gf.append(payload)
        self.records.append(Record(
            name=name, domain=domain, file=fname, offset=off,
            nbytes=len(payload), dtype=dtype,
            shape=tuple(shape if shape is not None else (len(payload),)),
            codec=codec, meta=meta or {}))

    write_array = ContextWriter.write_array


# ---------------------------------------------------------------- codecs

def decode_record(db: HerculeDB, rec: Record) -> np.ndarray:
    """Decode a record payload according to its codec (self-describing).

    Dispatches through the codec registry — new codecs plug in via
    :func:`register_codec` instead of growing an if-chain here.
    """
    codec = get_codec(rec.codec)
    if codec.decode is None:
        raise ValueError(
            f"codec {rec.codec!r} is not record-decodable on its own; "
            f"it is assembled by its object kind (see repro_torch.hercule.api)")
    return codec.decode(db, rec, db.read_payload(rec))
