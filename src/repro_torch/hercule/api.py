"""Unified Hercule object API: typed kinds, indexed views, selectors.

The paper's formats stay useful because every object is *self-describing
and uniformly addressable*; this module is the single data-access layer
the writers, the in-transit reducers and the viewers all share:

  * **ObjectKind registry** — each object flavor (``amr_tree``,
    ``analysis``, ``reduced``, ``ckpt_shard``) declares its record naming
    schema, its write codecs and its assembly logic. Record-name dispatch
    happens here, once, instead of ``startswith(...)`` chains scattered
    through readers.
  * **ContextView** — an indexed handle over one finalized context. The
    manifest is parsed exactly once (views are cached on the database);
    point reads are hash lookups, batched reads fan out on the database's
    ``io_threads`` pool, and domain-merged reads gather one name across
    contributors.
  * **Selector** — one query object (step ranges, name globs, domain
    sets, kind filters) understood by every read flow: the catalog,
    analysis readers, elastic restore and the :func:`scan` iterator.

Name patterns: a ``names`` entry containing ``*`` or ``?`` is a glob
(``fnmatch`` semantics); anything else is an exact match — checkpoint
record names contain ``[``/``]`` from pytree key paths, which must never
be read as character classes.

The legacy ``hdep`` free functions (``read_domain_tree`` & co.) were
deprecation shims over this module until their two-PR countdown ended;
they are now removed — see DESIGN.md §11 for the migration table.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json

import numpy as np

from . import codecs
from .database import (HerculeDB, Record, _dtype_of, decode_record,
                       get_codec, register_codec)

__all__ = [
    "Selector", "as_selector", "ContextView", "ObjectKind", "KINDS",
    "register_kind", "kind_of", "scan", "RecordRef", "read_object",
    "write_object",
]


# ---------------------------------------------------------------- selector

def _has_glob(pattern: str) -> bool:
    return "*" in pattern or "?" in pattern


def _glob_match(name: str, pattern: str) -> bool:
    """fnmatch honoring only ``*``/``?`` — never ``[...]`` classes.

    Record names carry literal brackets from pytree key paths
    (``['params']['w']``); escaping ``[`` keeps a pattern like
    ``analysis/['dense']*`` matching those names literally.
    """
    return fnmatch.fnmatchcase(name, pattern.replace("[", "[[]"))


def _name_tuple(x) -> tuple[str, ...] | None:
    if x is None:
        return None
    if isinstance(x, str):
        return (x,)
    return tuple(str(n) for n in x)


@dataclasses.dataclass(frozen=True)
class Selector:
    """Uniform query over Hercule records.

    ``steps``: an int, a ``range``, or an iterable of ints (None = all).
    ``names``: glob pattern(s) or exact record name(s) (None = all).
    ``domains``: an int or iterable of ints (None = all).
    ``kinds``: ObjectKind name(s) from :data:`KINDS` (None = all).
    """
    steps: object = None
    names: object = None
    domains: object = None
    kinds: object = None

    def __post_init__(self):
        object.__setattr__(self, "names", _name_tuple(self.names))
        if self.domains is not None and not isinstance(self.domains, frozenset):
            doms = (self.domains,) if isinstance(self.domains, int) \
                else self.domains
            object.__setattr__(self, "domains",
                               frozenset(int(d) for d in doms))
        kinds = self.kinds
        if kinds is not None:
            kinds = (kinds,) if isinstance(kinds, str) else tuple(kinds)
            unknown = [k for k in kinds if k not in KINDS]
            if unknown:
                raise ValueError(f"unknown object kind(s) {unknown}; "
                                 f"registered: {sorted(KINDS)}")
            object.__setattr__(self, "kinds", frozenset(kinds))
        if isinstance(self.steps, (int, np.integer)):
            object.__setattr__(self, "steps", (int(self.steps),))
        elif self.steps is not None and not isinstance(self.steps, range):
            object.__setattr__(self, "steps",
                               frozenset(int(s) for s in self.steps))

    # ---------------------------------------------------------- predicates
    def match_step(self, step: int) -> bool:
        return self.steps is None or step in self.steps

    def match_name(self, name: str) -> bool:
        if self.names is None:
            return True
        return any(_glob_match(name, p) if _has_glob(p)
                   else name == p for p in self.names)

    def match(self, rec: Record) -> bool:
        if self.domains is not None and rec.domain not in self.domains:
            return False
        if not self.match_name(rec.name):
            return False
        if self.kinds is not None and kind_of(rec.name).name not in self.kinds:
            return False
        return True


def as_selector(selector=None, **kw) -> Selector:
    """Coerce ``(selector | keyword fields)`` into one Selector."""
    if selector is None:
        return Selector(**kw)
    if not isinstance(selector, Selector):
        raise TypeError(f"expected Selector, got {type(selector).__name__}")
    if kw:
        return dataclasses.replace(selector, **kw)
    return selector


# ------------------------------------------------------------ context view

class ContextView:
    """Indexed read handle over one finalized context.

    Obtained from :meth:`HerculeDB.view`; the manifest is parsed once and
    hash indexes over ``(domain, name)``, ``name`` and ``domain`` are
    built so repeated reads never re-parse or linearly scan the record
    list. Contexts are immutable once finalized, so views never go stale.
    """

    def __init__(self, db: HerculeDB, step: int):
        self.db = db
        self.step = int(step)
        idx = db.load_index(step)
        self.attrs: dict = idx["attrs"]
        self.records: list[Record] = idx["records"]
        self._by_key: dict[tuple[int, str], Record] = {}
        self._by_name: dict[str, list[Record]] = {}
        self._by_domain: dict[int, list[Record]] = {}
        for rec in self.records:
            self._by_key[(rec.domain, rec.name)] = rec
            self._by_name.setdefault(rec.name, []).append(rec)
            self._by_domain.setdefault(rec.domain, []).append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def __repr__(self) -> str:
        return (f"ContextView(step={self.step}, records={len(self.records)}, "
                f"domains={len(self._by_domain)})")

    # ------------------------------------------------------------- lookup
    def record(self, domain: int, name: str) -> Record:
        try:
            return self._by_key[(domain, name)]
        except KeyError:
            raise KeyError(
                f"({domain}, {name}) not in context {self.step}") from None

    def records_named(self, name: str) -> list[Record]:
        """All domains' records for one exact name (manifest order)."""
        return list(self._by_name.get(name, ()))

    def names(self) -> list[str]:
        return sorted(self._by_name)

    def domains(self, name: str | None = None) -> list[int]:
        if name is None:
            return sorted(self._by_domain)
        return sorted(r.domain for r in self._by_name.get(name, ()))

    def kinds(self) -> list[str]:
        """ObjectKind names present in this context."""
        return sorted({kind_of(n).name for n in self._by_name})

    def select(self, selector: Selector | None = None, **kw) -> list[Record]:
        sel = as_selector(selector, **kw)
        if sel.names is not None and sel.domains is None and \
                all(not _has_glob(p) for p in sel.names):
            recs = [r for p in sel.names for r in self._by_name.get(p, ())]
        elif sel.domains is not None and sel.names is None:
            recs = [r for d in sorted(sel.domains)
                    for r in self._by_domain.get(d, ())]
        else:
            recs = self.records
        return [r for r in recs if sel.match(r)]

    # ------------------------------------------------------------- reading
    def read_record(self, rec: Record) -> np.ndarray:
        return decode_record(self.db, rec)

    def read(self, domain: int, name: str) -> np.ndarray:
        """Point read: hash lookup + decode, no manifest re-parse."""
        return self.read_record(self.record(domain, name))

    #: below this aggregate payload size, pool dispatch costs more than the
    #: decode itself (tiny records are GIL-bound); read sequentially
    PARALLEL_MIN_BYTES = 1 << 20

    def read_records(self, recs: list[Record]) -> list[np.ndarray]:
        """Decode a batch, fanning out on the db's read pool when it pays."""
        if len(recs) <= 1 or self.db.io_threads <= 1 or \
                sum(r.nbytes for r in recs) < self.PARALLEL_MIN_BYTES:
            return [self.read_record(r) for r in recs]
        pool = self.db._reader_pool()
        return list(pool.map(self.read_record, recs))

    def read_many(self, items=None, /, selector: Selector | None = None,
                  **kw) -> dict[tuple[int, str], np.ndarray]:
        """Batched multi-record read.

        ``items`` is an iterable of ``(domain, name)`` pairs; alternatively
        pass a :class:`Selector` (or its keyword fields). Decodes run on
        the database's ``io_threads`` pool.
        """
        if items is not None:
            recs = [self.record(d, n) for d, n in items]
        else:
            recs = self.select(selector, **kw)
        arrays = self.read_records(recs)
        return {(r.domain, r.name): a for r, a in zip(recs, arrays)}

    def read_merged(self, name: str, domains=None
                    ) -> dict[int, np.ndarray]:
        """Domain-merged read: one name across contributors.

        Returns ``{domain: array}`` for every (selected) domain holding
        ``name``, decoded in parallel — the building block for merged
        multi-domain reductions.
        """
        recs = self.records_named(name)
        if domains is not None:
            want = {int(d) for d in domains}
            recs = [r for r in recs if r.domain in want]
        arrays = self.read_records(recs)
        return {r.domain: a for r, a in zip(recs, arrays)}


# ------------------------------------------------------------ object kinds

class ObjectKind:
    """One Hercule object flavor: naming schema + codecs + assembly."""

    #: registry key and default ``kind`` filter value
    name: str = ""
    #: record-name prefix owned by this kind ("" = fallback)
    prefix: str = ""

    def match(self, record_name: str) -> bool:
        return bool(self.prefix) and record_name.startswith(self.prefix)

    def parse(self, record_name: str) -> dict:
        """Split a record name into its schema components."""
        return {"name": record_name}

    def write(self, ctx, domain: int, payload, **opts) -> None:
        raise NotImplementedError(f"kind {self.name!r} has no writer")

    def assemble(self, view: ContextView, domain: int = 0, **opts):
        raise NotImplementedError(f"kind {self.name!r} has no assembler")


KINDS: dict[str, ObjectKind] = {}
_FALLBACK_KIND: list[ObjectKind] = []


def register_kind(kind: ObjectKind, *, fallback: bool = False) -> ObjectKind:
    """Register an ObjectKind; ``fallback=True`` marks the catch-all."""
    KINDS[kind.name] = kind
    if fallback:
        _FALLBACK_KIND[:] = [kind]
    return kind


def kind_of(record_name: str) -> ObjectKind:
    """Classify a record name (falls back to the catch-all kind)."""
    for kind in KINDS.values():
        if kind.match(record_name):
            return kind
    if _FALLBACK_KIND:
        return _FALLBACK_KIND[0]
    raise ValueError(f"no object kind matches record {record_name!r}")


def _write_maybe_compressed(ctx, domain: int, name: str, arr: np.ndarray,
                            compress: bool) -> None:
    """Write one tensor raw, or pyramid-compressed when that shrinks it."""
    arr = np.ascontiguousarray(arr)
    if compress and arr.dtype.kind == "f" and arr.size >= 64:
        payload, meta = get_codec("fpdelta-pyramid").encode(arr)
        if len(payload) < arr.nbytes:
            ctx.write_bytes(domain, name, payload, dtype=str(arr.dtype),
                            shape=arr.shape, codec="fpdelta-pyramid",
                            meta=meta)
            return
    ctx.write_array(domain, name, arr)


class AmrTreeKind(ObjectKind):
    """Self-describing per-domain AMR object (paper §2 HDep data model).

    Records: ``amr/refine``, ``amr/owner`` (boolrle), ``amr/level_offsets``,
    ``amr/coords0`` (raw), ``amr/field/<name>`` (fpdelta-tree or raw).
    """

    name = "amr_tree"
    prefix = "amr/"

    def parse(self, record_name: str) -> dict:
        rest = record_name[len(self.prefix):]
        if rest.startswith("field/"):
            return {"part": "field", "field": rest[len("field/"):]}
        return {"part": rest}

    def write(self, ctx, domain: int, tree, *, compress_fields: bool = True,
              zbits: int = 4) -> None:
        from ..core import fpdelta
        enc_bool = get_codec("boolrle").encode
        for part, bits in (("refine", tree.refine), ("owner", tree.owner)):
            payload, _ = enc_bool(bits)
            ctx.write_bytes(domain, f"amr/{part}", payload, dtype="bool",
                            shape=bits.shape, codec="boolrle")
        ctx.write_array(domain, "amr/level_offsets", tree.level_offsets)
        ctx.write_array(domain, "amr/coords0",
                        tree.coords[tree.level_slice(0)].astype(np.int64))
        for fname, v in tree.fields.items():
            if compress_fields:
                tc = fpdelta.encode_tree_field(tree, fname, zbits=zbits)
                ctx.write_bytes(domain, f"amr/field/{fname}",
                                codecs.encode_tree_field(tc),
                                dtype=str(v.dtype), shape=v.shape,
                                codec="fpdelta-tree", meta={"width": tc.width})
            else:
                ctx.write_array(domain, f"amr/field/{fname}", v)

    def assemble(self, view: ContextView, domain: int = 0, **opts):
        """Rebuild one domain's AMRTree from its self-describing object."""
        from ..core.amr import CHILD_OFFSETS, AMRTree
        refine = view.read(domain, "amr/refine").astype(bool)
        owner = view.read(domain, "amr/owner").astype(bool)
        offsets = view.read(domain, "amr/level_offsets").astype(np.int64)
        coords0 = view.read(domain, "amr/coords0").astype(np.int64)
        # reconstruct coords from the BFS structure (self-describing:
        # children coords follow from fathers')
        n = refine.shape[0]
        coords = np.zeros((n, 3), np.int64)
        coords[:coords0.shape[0]] = coords0
        tree = AMRTree(refine=refine, owner=owner, level_offsets=offsets,
                       coords=coords)
        cs = tree.child_start()
        for lvl in range(tree.n_levels - 1):
            sl = tree.level_slice(lvl)
            idx = np.flatnonzero(tree.refine[sl]) + sl.start
            for k in range(8):
                coords[cs[idx] + k] = 2 * coords[idx] + CHILD_OFFSETS[k]
        for rec in view.select(domains=domain, names="amr/field/*"):
            fname = self.parse(rec.name)["field"]
            payload = view.db.read_payload(rec)
            if rec.codec == "fpdelta-tree":
                tree.fields[fname] = codecs.decode_tree_field_bytes(
                    payload, tree, fname, int(rec.meta["width"]))
            else:
                tree.fields[fname] = np.frombuffer(
                    payload, dtype=rec.dtype).reshape(rec.shape).copy()
        return tree

    def domains_in(self, view: ContextView) -> list[int]:
        return view.domains("amr/refine")


class AnalysisKind(ObjectKind):
    """Named analysis tensors (``analysis/<name>``), pyramid-compressible."""

    name = "analysis"
    prefix = "analysis/"

    def parse(self, record_name: str) -> dict:
        return {"tensor": record_name[len(self.prefix):]}

    def write(self, ctx, domain: int, tensors: dict, *,
              compress: bool = True) -> None:
        for tname, arr in tensors.items():
            _write_maybe_compressed(ctx, domain, f"analysis/{tname}",
                                    np.asarray(arr), compress)

    def assemble(self, view: ContextView, domain: int = 0, **opts
                 ) -> dict[str, np.ndarray]:
        got = view.read_many(selector=Selector(
            names="analysis/*", domains=domain))
        return {self.parse(name)["tensor"]: arr
                for (_, name), arr in got.items()}


class ReducedKind(ObjectKind):
    """In-transit reduction outputs (``reduced/<reducer>/<name>``).

    One reduced object may span several Hercule domains: each contributor
    group of a multi-domain engine writes its part of the reduction as
    its own domain within the shared context, and reads merge them back
    (the paper's per-producer write + deferred-merge shape). Merge
    semantics are *per reducer* and registered by name on this kind —
    see :meth:`register_merge`; contexts written by the in-transit
    engine record each reducer's strategy in
    ``attrs["insitu"]["merge"]``, so merged reads are self-describing.
    """

    name = "reduced"
    prefix = "reduced/"

    #: merge-strategy registry: name -> fn({domain: {array: ndarray}})
    #: -> {array: ndarray}; the input dict is ordered by domain id
    MERGES: dict[str, object] = {}

    @classmethod
    def register_merge(cls, name: str, fn) -> None:
        """Register a named merge strategy for multi-domain reads."""
        cls.MERGES[name] = fn

    def parse(self, record_name: str) -> dict:
        reducer, _, array = record_name[len(self.prefix):].partition("/")
        return {"reducer": reducer, "array": array}

    def record_name(self, reducer: str, array: str) -> str:
        assert "/" not in array, f"reduced array name {array!r} contains '/'"
        return f"reduced/{reducer}/{array}"

    def write(self, ctx, domain: int, arrays: dict, *, reducer: str,
              compress: bool = False) -> None:
        for aname, arr in arrays.items():
            _write_maybe_compressed(ctx, domain,
                                    self.record_name(reducer, aname),
                                    arr, compress)

    def assemble(self, view: ContextView, domain: int | None = 0, *,
                 reducer: str, strategy: str | None = None, domains=None,
                 **opts) -> dict[str, np.ndarray]:
        """Assemble one reduced object.

        ``domain=None`` merges the object across every contributing
        domain (optionally restricted to ``domains``) using the merge
        strategy resolved from the explicit ``strategy`` argument or the
        context's ``attrs["insitu"]["merge"]``. A single contributing
        domain is returned as-is — the degenerate case is bit-for-bit
        the per-domain read, no strategy needed.
        """
        if domain is not None:
            prefix = f"reduced/{reducer}/"
            recs = [r for r in view.select(domains=domain)
                    if r.name.startswith(prefix)]
            if not recs:
                raise KeyError(
                    f"no reduced object {reducer!r} in context {view.step}")
            arrays = view.read_records(recs)
            return {r.name[len(prefix):]: a for r, a in zip(recs, arrays)}
        objs = self.read_parts(view, reducer, domains=domains)
        return self.merge(view, reducer, objs, strategy=strategy)

    def read_parts(self, view: ContextView, reducer: str, *, domains=None
                   ) -> dict[int, dict[str, np.ndarray]]:
        """Per-domain reduced objects: read_merged semantics, one batch.

        All of the reducer's records across domains decode in a single
        :meth:`ContextView.read_records` call (fanning out on the db's
        ``io_threads`` pool above ``PARALLEL_MIN_BYTES``) instead of one
        domain-merged gather per array name.
        """
        prefix = f"reduced/{reducer}/"
        recs = [r for n, rs in view._by_name.items()
                if n.startswith(prefix) for r in rs]
        if not recs:
            raise KeyError(
                f"no reduced object {reducer!r} in context {view.step}")
        if domains is not None:
            want = {int(d) for d in domains}
            recs = [r for r in recs if r.domain in want]
            if not recs:
                raise KeyError(
                    f"no reduced object {reducer!r} in context {view.step} "
                    f"for domains {sorted(want)}")
        arrays = view.read_records(recs)
        objs: dict[int, dict[str, np.ndarray]] = {}
        for rec, arr in zip(recs, arrays):
            objs.setdefault(rec.domain, {})[rec.name[len(prefix):]] = arr
        return {d: objs[d] for d in sorted(objs)}

    def merge(self, view: ContextView, reducer: str,
              objs: dict[int, dict[str, np.ndarray]], *,
              strategy: str | None = None) -> dict[str, np.ndarray]:
        """Merge per-domain objects into one (identity for one domain)."""
        if len(objs) == 1:
            return next(iter(objs.values()))
        if strategy is None:
            strategy = self.merge_strategy_of(view, reducer)
        if strategy is None:
            raise ValueError(
                f"reduced object {reducer!r} spans {len(objs)} domains but "
                f"declares no merge strategy; pass strategy=... or write "
                f"attrs['insitu']['merge'] (registered: {sorted(self.MERGES)})")
        fn = self.MERGES.get(strategy)
        if fn is None:
            raise ValueError(
                f"unknown merge strategy {strategy!r}; "
                f"registered: {sorted(self.MERGES)}")
        return fn(objs)

    def merge_strategy_of(self, view: ContextView, reducer: str
                          ) -> str | None:
        """Strategy recorded by the writer (engine attrs), if any."""
        merge = view.attrs.get("insitu", {}).get("merge", {})
        return merge.get(reducer)

    def reducers_in(self, view: ContextView) -> list[str]:
        return sorted({self.parse(n)["reducer"] for n in view._by_name
                       if self.match(n)})

    def domains_in(self, view: ContextView, reducer: str) -> list[int]:
        """Domains contributing to one reduced object."""
        prefix = f"reduced/{reducer}/"
        return sorted({r.domain for n, rs in view._by_name.items()
                       if n.startswith(prefix) for r in rs})


class CkptShardKind(ObjectKind):
    """HProt checkpoint shards: one record per owned device shard.

    Naming schema: the pytree key path of the leaf (``['params']['w']``);
    ``meta`` carries the global shape and this shard's index slices, so
    any target topology can reassemble exactly the regions it needs.
    This is the fallback kind: every record no other kind claims.
    """

    name = "ckpt_shard"
    prefix = ""

    def match(self, record_name: str) -> bool:
        return False  # fallback: claimed only via kind_of()

    def shards(self, view: ContextView, name: str) -> list[Record]:
        return view.select(Selector(names=name, kinds=self.name))

    def read_region(self, view: ContextView, name: str,
                    target_slices, *, reader=None) -> np.ndarray:
        """Elastic region read: decode only overlapping source shards.

        ``reader`` overrides the batched record decoder (``fn(records)
        -> [ndarray]``); the async manager injects a checksum-verifying
        decode here so integrity checking composes with the elastic
        intersection logic instead of duplicating it.
        """
        recs = self.shards(view, name)
        if not recs:
            raise KeyError(
                f"checkpoint context {view.step} missing tensor {name!r}")
        read = reader if reader is not None else view.read_records
        gshape = tuple(recs[0].meta["global_shape"])
        if not gshape:  # scalar: a single record, whole payload
            return read([recs[0]])[0].reshape(())
        out = np.empty([s.stop - s.start for s in target_slices],
                       _dtype_of(recs[0].dtype))
        hits = []
        for rec in recs:
            src = [slice(a, b) for a, b in rec.meta["slices"]]
            # shards from unsharded leaves record no slices: full extent
            src += [slice(0, dim) for dim in gshape[len(src):]]
            inter = []
            for ts, ss in zip(target_slices, src):
                lo, hi = max(ts.start, ss.start), min(ts.stop, ss.stop)
                if lo >= hi:
                    break
                inter.append((lo, hi))
            else:
                hits.append((rec, src, inter))
        for (rec, src, inter), data in zip(hits, read(
                [rec for rec, _, _ in hits])):
            dst = tuple(slice(lo - ts.start, hi - ts.start)
                        for (lo, hi), ts in zip(inter, target_slices))
            s_src = tuple(slice(lo - ss.start, hi - ss.start)
                          for (lo, hi), ss in zip(inter, src))
            out[dst] = data[s_src]
        return out


class HProtShardKind(CkptShardKind):
    """HProt protection shards written by the async checkpoint manager.

    Naming schema: ``ckpt/<pytree key path>`` — an explicit prefix (the
    sync manager's bare key paths stay on the fallback kind), so HProt
    records are claimable, selectable and scannable like any other
    typed object. Same meta contract as :class:`CkptShardKind` plus a
    per-record ``crc32`` of the stored payload and, for delta-encoded
    shards, the ``pred_step`` whose record is the temporal predictor
    (DESIGN.md §16).
    """

    name = "hprot_shard"
    prefix = "ckpt/"

    def match(self, record_name: str) -> bool:
        return record_name.startswith(self.prefix)

    def parse(self, record_name: str) -> dict:
        return {"tensor": record_name[len(self.prefix):]}

    def record_name(self, tensor: str) -> str:
        return f"{self.prefix}{tensor}"


class TelemetryKind(ObjectKind):
    """Run-ledger telemetry batches (``telemetry/<part>``).

    The observability flavor of the paper's purpose-specific-format
    lesson (DESIGN.md §19): each flush of :class:`repro.obs.ledger.
    RunLedger` writes one ledger context whose records are JSON parts —
    ``telemetry/meta``, ``telemetry/metrics``, ``telemetry/spans``,
    ``telemetry/events``, ``telemetry/attrib``, ``telemetry/health`` —
    and every writing process (trainer/engine, process lanes relayed
    over the results queue, catalog server) lands its parts as its *own
    Hercule domain*. ``assemble(domain=None)`` merges them back at read
    exactly like the reduced kind: spans and events concatenate across
    domains ordered by timestamp; metrics/attrib/health key by domain.
    """

    name = "telemetry"
    prefix = "telemetry/"

    #: parts whose per-domain payloads are event-shaped lists merged by
    #: timestamp; the rest stay keyed by contributing domain
    _CONCAT = {"spans": "ts", "events": "ts_us"}

    def parse(self, record_name: str) -> dict:
        return {"part": record_name[len(self.prefix):]}

    def record_name(self, part: str) -> str:
        return f"{self.prefix}{part}"

    def write(self, ctx, domain: int, parts: dict, **opts) -> None:
        """Write a dict of JSON-able parts as one domain's records."""
        for part, payload in parts.items():
            blob = json.dumps(payload).encode()
            ctx.write_bytes(domain, self.record_name(part), blob,
                            dtype="uint8", shape=(len(blob),),
                            codec="json")

    def _decode(self, view: ContextView, rec: Record):
        return json.loads(view.db.read_payload(rec).decode())

    def assemble(self, view: ContextView, domain: int | None = None,
                 **opts) -> dict:
        """Merge every domain's telemetry parts for one ledger context.

        Returns ``{part: ...}``: span/event parts are one time-ordered
        list across all (selected) domains; other parts map
        ``{domain: payload}``.
        """
        out: dict = {}
        for rec in view.select(names="telemetry/*", domains=domain):
            part = self.parse(rec.name)["part"]
            payload = self._decode(view, rec)
            if part in self._CONCAT:
                out.setdefault(part, []).extend(payload or [])
            else:
                out.setdefault(part, {})[rec.domain] = payload
        for part, ts_key in self._CONCAT.items():
            if part in out:
                out[part].sort(key=lambda e: e.get(ts_key, 0.0))
        return out


def _decode_json_record(db, rec, payload):
    # JSON records decode to a uint8 byte array at the record layer;
    # TelemetryKind.assemble parses the actual objects
    return np.frombuffer(payload, dtype=np.uint8)


register_codec("json", decode=_decode_json_record)


AMR_TREE = register_kind(AmrTreeKind())
ANALYSIS = register_kind(AnalysisKind())
REDUCED = register_kind(ReducedKind())
HPROT_SHARD = register_kind(HProtShardKind())
TELEMETRY = register_kind(TelemetryKind())
CKPT_SHARD = register_kind(CkptShardKind(), fallback=True)


# ----------------------------------------------- built-in merge strategies
#
# Each strategy implements the full merge semantics of one reducer family
# over per-domain objects produced from *disjoint* contributor partitions
# (each owned element contributed by exactly one domain):
#
#   sum       elementwise sum of every array (column-density projections)
#   max       elementwise maximum (depth/max image compositing)
#   hist      sum per-level counts, rows zero-padded; bin edges must agree
#   tile      NaN-background images tiled by extent (axis slices)
#   assemble  AMR-tree arrays merged by (level, coords), owned copies win
#             (level-of-detail cuts: concatenate + re-sort in Morton/BFS)
#   concat    row-concatenate arrays keyed by a "names" axis, re-sorted
#             (tensor-norm tables)
#   union     dict union of disjointly-named arrays (spectra)

def _each_name(objs):
    seen: dict[str, None] = {}
    for obj in objs.values():
        for n in obj:
            seen.setdefault(n)
    return list(seen)


def _merge_sum(objs):
    return {n: sum(o[n] for o in objs.values() if n in o)
            for n in _each_name(objs)}


def _merge_max(objs):
    out = {}
    for n in _each_name(objs):
        arrs = [o[n] for o in objs.values() if n in o]
        acc = arrs[0]
        for a in arrs[1:]:
            acc = np.fmax(acc, a)
        out[n] = acc
    return out


def _merge_hist(objs):
    parts = list(objs.values())
    edges = [p["edges"] for p in parts]
    if any(not np.array_equal(edges[0], e) for e in edges[1:]):
        raise ValueError(
            "histogram bin edges differ across domains (auto lo/hi bounds "
            "are per-partition); use fixed lo/hi bounds for multi-domain "
            "histogram reduction")
    hists = [p["hist"] for p in parts]
    rows = max(h.shape[0] for h in hists)
    acc = np.zeros((rows,) + hists[0].shape[1:], hists[0].dtype)
    for h in hists:
        acc[:h.shape[0]] += h
    return {"hist": acc, "edges": edges[0]}


def _merge_tile(objs):
    """Overlay NaN-background arrays: first non-NaN per element wins.

    Disjoint contributor partitions paint disjoint extents (shared
    pixels, e.g. demoted coarse nodes, carry identical restricted
    values), so overlay order does not matter.
    """
    out = {}
    for n in _each_name(objs):
        acc = None
        for o in objs.values():
            if n not in o:
                continue
            a = o[n]
            if acc is None:
                acc = np.array(a, copy=True)
            elif acc.dtype.kind == "f":
                hole = np.isnan(acc)
                acc[hole] = a[hole]
            elif not np.array_equal(acc, a):
                raise ValueError(
                    f"cannot tile non-float array {n!r} with conflicting "
                    "values across domains")
        out[n] = acc
    return out


def _merge_assemble(objs):
    from ..core.amr import AMRTree   # lazy: api is imported by core users
    from . import analysis
    trees = [AMRTree.from_arrays(o) for o in objs.values()]
    return dict(analysis.assemble(trees).to_arrays())


def _merge_concat(objs):
    parts = list(objs.values())
    if any("names" not in p for p in parts):
        raise ValueError(
            "'concat' merge needs a 'names' array in every domain part")
    names = np.concatenate([np.asarray(p["names"]) for p in parts])
    order = np.argsort(names, kind="stable")
    out = {"names": names[order]}
    for n in _each_name(objs):
        if n == "names":
            continue
        arrs = [p[n] for p in parts if n in p]
        identical = all(np.array_equal(arrs[0], a) for a in arrs[1:])
        aligned = len(arrs) == len(parts) and all(
            a.shape[:1] == np.asarray(p["names"]).shape[:1]
            for a, p in zip(arrs, parts))
        # a constant *string* side table (e.g. stat_names) can
        # coincidentally have as many rows as each part owns names —
        # identity wins there; numeric rows that merely happen to be
        # equal (zero-init layers) still concatenate with the names
        if aligned and (not identical or arrs[0].dtype.kind not in "US"):
            out[n] = np.concatenate(arrs)[order]
        elif identical:
            out[n] = arrs[0]
        else:
            raise ValueError(
                f"array {n!r} is neither row-aligned with 'names' nor "
                "identical across domains")
    return out


def _merge_union(objs):
    out: dict[str, np.ndarray] = {}
    for dom, obj in objs.items():
        for n, a in obj.items():
            if n in out and not np.array_equal(out[n], a):
                raise ValueError(
                    f"'union' merge found conflicting values for {n!r} "
                    f"(domain {dom})")
            out.setdefault(n, a)
    return out


for _name, _fn in (("sum", _merge_sum), ("max", _merge_max),
                   ("hist", _merge_hist), ("tile", _merge_tile),
                   ("assemble", _merge_assemble), ("concat", _merge_concat),
                   ("union", _merge_union)):
    ReducedKind.register_merge(_name, _fn)


# ------------------------------------------------------- object-level API

def write_object(ctx, kind: str, domain: int, payload, **opts) -> None:
    """Write one typed object into a context (dispatch by kind name)."""
    if kind not in KINDS:
        raise ValueError(f"unknown object kind {kind!r}; "
                         f"registered: {sorted(KINDS)}")
    KINDS[kind].write(ctx, domain, payload, **opts)


def read_object(db: HerculeDB, step: int, kind: str,
                domain: int | None = 0, **opts):
    """Assemble one typed object from a context's records.

    For the ``reduced`` kind, ``domain=None`` returns the object merged
    across every contributing domain (see
    :meth:`ReducedKind.assemble`); other kinds require a concrete domain.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown object kind {kind!r}; "
                         f"registered: {sorted(KINDS)}")
    return KINDS[kind].assemble(db.view(step), domain, **opts)


# ------------------------------------------------------------------- scan

@dataclasses.dataclass(frozen=True)
class RecordRef:
    """One matched record with enough context to read it."""
    view: ContextView
    record: Record

    @property
    def step(self) -> int:
        return self.view.step

    @property
    def kind(self) -> str:
        return kind_of(self.record.name).name

    def read(self) -> np.ndarray:
        return self.view.read_record(self.record)


def scan(db: HerculeDB, selector: Selector | None = None, **kw):
    """Iterate matching records across every context of a database.

    Yields :class:`RecordRef` in (step, manifest) order. Contexts whose
    step the selector rejects are skipped without opening their manifest.
    """
    sel = as_selector(selector, **kw)
    for step in db.contexts():
        if not sel.match_step(step):
            continue
        view = db.view(step)
        for rec in view.select(sel):
            yield RecordRef(view, rec)
