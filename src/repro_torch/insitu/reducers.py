"""Composable in-transit reduction operators (paper §4, in-situ flavor).

Each reducer turns a staged :class:`~repro.insitu.staging.Snapshot` into a
small dict of named arrays — the lightweight, purpose-specific objects the
paper argues should replace full-state dumps. Reducers declare upstream
dependencies by name, forming a DAG the engine executes once per staged
snapshot (e.g. an axis slice cut from a level-of-detail pyramid cut
instead of the full tree).

AMR reducers reproduce the exact post-hoc semantics of
:mod:`repro_torch.hercule.analysis` (same rasterization), so an
in-transit slice is bitwise-comparable to the post-hoc one. Tensor
reducers (norm summaries, spectra) are plain torch on whatever device
the staged tensors live.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.amr import AMRTree, subset_tree
from ..hercule import analysis
from .staging import Snapshot


def tree_of(arrays: dict[str, np.ndarray]) -> AMRTree:
    """Reconstruct an AMRTree from staged/reduced ``to_arrays`` output."""
    return AMRTree.from_arrays(arrays)


class Reducer:
    """Base reduction operator.

    ``name`` doubles as the reduced-object key in HDep (and in catalog
    cache keys), so it encodes the parameters and may not contain ``/``.
    ``deps`` names upstream reducers whose outputs are passed in
    ``upstream``. ``merge`` names the multi-domain merge strategy of this
    reducer's outputs (``hercule.api.ReducedKind.MERGES``); a reducer on
    a partitioned snapshot (``snap.n_domains > 1``) must contribute each
    owned element exactly once so per-domain outputs merge back to the
    single-domain answer.
    """

    name: str = "reducer"
    deps: tuple[str, ...] = ()
    kinds: tuple[str, ...] = ("amr",)   # snapshot kinds this reducer accepts
    merge: str | None = None            # multi-domain merge strategy
    #: ``reduce`` accepts device tensors directly (no host snapshot
    #: needed) — the device-reduce path (``insitu.device``) skips the
    #: full-snapshot fallback transfer for such reducers
    device_ready: bool = False

    def reduce(self, snap: Snapshot,
               upstream: dict[str, dict[str, np.ndarray]]
               ) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def _source_tree(self, snap: Snapshot, upstream) -> AMRTree:
        src = getattr(self, "source", None)
        if src:
            return tree_of(upstream[src])
        return tree_of(snap.arrays)


# ------------------------------------------------------------ AMR reducers

@dataclasses.dataclass
class SliceReducer(Reducer):
    """Axis-aligned slice raster — identical to ``analysis.slice_image``."""

    field: str = "density"
    axis: int = 2
    position: float = 0.5
    resolution: int = 256
    source: str | None = None      # optional upstream tree (e.g. a LOD cut)

    merge = "tile"

    def __post_init__(self):
        self.name = (f"slice-{self.field}-ax{self.axis}-"
                     f"p{self.position:g}-r{self.resolution}")
        if self.source:
            self.name += f"-of-{self.source}"
        self.deps = (self.source,) if self.source else ()

    def reduce(self, snap, upstream):
        tree = self._source_tree(snap, upstream)
        img = analysis.slice_image(tree, self.field, axis=self.axis,
                                   position=self.position,
                                   resolution=self.resolution,
                                   owned_only=snap.n_domains > 1)
        return {"image": img}


@dataclasses.dataclass
class ProjectionReducer(Reducer):
    """Column density: integrate a field along one axis over all leaves."""

    field: str = "density"
    axis: int = 2
    resolution: int = 256
    source: str | None = None

    merge = "sum"

    def __post_init__(self):
        self.name = (f"proj-{self.field}-ax{self.axis}-r{self.resolution}")
        if self.source:
            self.name += f"-of-{self.source}"
        self.deps = (self.source,) if self.source else ()

    def reduce(self, snap, upstream):
        tree = self._source_tree(snap, upstream)
        res = self.resolution
        img = np.zeros((res, res))
        levels = tree.levels()
        v = tree.fields[self.field]
        leaves = np.flatnonzero(~tree.refine)
        if snap.n_domains > 1:      # partitioned: integrate owned cells once
            leaves = leaves[tree.owner[leaves]]
        ax_u, ax_v = [a for a in range(3) if a != self.axis]
        for l in range(tree.n_levels):
            sel = leaves[levels[leaves] == l]
            if sel.size == 0:
                continue
            size = 1.0 / (1 << l)
            c = tree.coords[sel]
            u0 = np.floor(c[:, ax_u] * size * res).astype(int)
            v0 = np.floor(c[:, ax_v] * size * res).astype(int)
            contrib = v[sel] * size           # field * path length
            px = max(1, int(round(size * res)))
            if px == 1:
                np.add.at(img, (u0, v0), contrib)
            else:
                for i in range(sel.size):
                    img[u0[i]:u0[i] + px, v0[i]:v0[i] + px] += contrib[i]
        return {"image": img}


@dataclasses.dataclass
class LevelHistogramReducer(Reducer):
    """Per-refinement-level histogram of a leaf field."""

    field: str = "density"
    bins: int = 32
    lo: float | None = None
    hi: float | None = None
    max_levels: int = 16

    merge = "hist"

    def __post_init__(self):
        self.name = f"hist-{self.field}-b{self.bins}"
        if self.lo is not None or self.hi is not None:
            lo = "auto" if self.lo is None else format(self.lo, "g")
            hi = "auto" if self.hi is None else format(self.hi, "g")
            self.name += f"-lo{lo}-hi{hi}"
        if self.max_levels != 16:
            self.name += f"-L{self.max_levels}"

    def reduce(self, snap, upstream):
        tree = self._source_tree(snap, upstream)
        v = tree.fields[self.field]
        leaf = ~tree.refine
        if snap.n_domains > 1:      # partitioned: count owned leaves once
            leaf &= tree.owner
        lo = float(v[leaf].min()) if self.lo is None else self.lo
        hi = float(v[leaf].max()) if self.hi is None else self.hi
        if hi <= lo:
            hi = lo + 1.0
        edges = np.linspace(lo, hi, self.bins + 1)
        hist = np.zeros((min(tree.n_levels, self.max_levels), self.bins),
                        np.int64)
        levels = tree.levels()
        for l in range(hist.shape[0]):
            sel = leaf & (levels == l)
            if sel.any():
                hist[l], _ = np.histogram(v[sel], bins=edges)
        return {"hist": hist, "edges": edges}


@dataclasses.dataclass
class LODCutReducer(Reducer):
    """Level-of-detail pyramid cut: the tree truncated at ``max_level``.

    Nodes deeper than ``max_level`` are dropped and their ancestors
    demoted to leaves (which already carry the intensive restriction of
    their sons) — a coarse but complete tree any viewer can render.
    """

    max_level: int = 4

    merge = "assemble"

    def __post_init__(self):
        self.name = f"lod{self.max_level}"

    def reduce(self, snap, upstream):
        tree = self._source_tree(snap, upstream)
        if tree.n_levels <= self.max_level + 1:
            return dict(tree.to_arrays())
        levels = tree.levels()
        keep = levels <= self.max_level
        force_leaf = np.flatnonzero(keep & (levels == self.max_level)
                                    & tree.refine)
        cut = subset_tree(tree, keep, force_leaf=force_leaf)
        return dict(cut.to_arrays())


# --------------------------------------------------------- tensor reducers

def _as_tensor(x) -> torch.Tensor:
    """A staged array as a tensor where it lives (numpy on the CPU)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


@dataclasses.dataclass
class TensorNormReducer(Reducer):
    """Per-tensor summary statistics (l2, rms, absmax, mean) in float32."""

    STAT_NAMES = ("l2", "rms", "absmax", "mean")

    merge = "concat"
    device_ready = True

    def __post_init__(self):
        self.name = "tnorm"
        self.kinds = ("tensors",)

    @staticmethod
    def _stats(x) -> np.ndarray:
        x = _as_tensor(x).to(torch.float32)
        sq = x * x
        # sqrt(sum(x * x)), as XLA computes jnp.linalg.norm: the CPU's
        # torch.linalg.vector_norm drifts 3e-5 from it at 4M float32
        # values, while both sums here stay at float32 roundoff
        return torch.stack([torch.sqrt(torch.sum(sq)),
                            torch.sqrt(torch.mean(sq)),
                            torch.max(torch.abs(x)),
                            torch.mean(x)]).cpu().numpy()

    def reduce(self, snap, upstream):
        names = sorted(snap.arrays)
        mat = np.stack([self._stats(snap.arrays[n]) for n in names]) \
            if names else np.zeros((0, 4), np.float32)
        return {"stats": mat.astype(np.float32),
                "names": np.array(names, dtype="U"),
                "stat_names": np.array(self.STAT_NAMES, dtype="U")}


@dataclasses.dataclass
class SpectraReducer(Reducer):
    """Top-k singular values of each matrix-shaped tensor, in float32."""

    k: int = 8

    merge = "union"
    device_ready = True

    def __post_init__(self):
        self.name = f"spectra-k{self.k}"
        self.kinds = ("tensors",)

    def reduce(self, snap, upstream):
        out = {}
        for name in sorted(snap.arrays):
            arr = snap.arrays[name]
            if arr.ndim != 2 or min(arr.shape) < 2:
                continue
            x = _as_tensor(arr).to(torch.float32)
            # cuSOLVER's default (Jacobi) method gave the top singular
            # values of a 2048 x 2048 float32 matrix 2e-4 apart from the
            # host's LAPACK on an H100; gesvd (QR) agrees to roundoff
            s = torch.linalg.svdvals(x, driver="gesvd") if x.is_cuda \
                else torch.linalg.svdvals(x)
            out[name.replace("/", ".")] = s[:self.k].cpu().numpy().astype(
                np.float32)
        return out


# ----------------------------------------------------------------- the DAG

class ReducerDAG:
    """Topologically ordered reducer set, executed per staged snapshot."""

    def __init__(self, reducers: list[Reducer]):
        byname = {}
        for r in reducers:
            assert "/" not in r.name, f"reducer name {r.name!r} contains '/'"
            if r.name in byname:
                raise ValueError(f"duplicate reducer name {r.name!r}")
            byname[r.name] = r
        for r in reducers:
            for d in r.deps:
                if d not in byname:
                    raise ValueError(
                        f"reducer {r.name!r} depends on unknown {d!r}")
        # Kahn topo-sort
        order, ready = [], [r for r in reducers if not r.deps]
        placed = {r.name for r in ready}
        pending = [r for r in reducers if r.deps]
        while ready:
            order.extend(ready)
            nxt = [r for r in pending
                   if all(d in placed for d in r.deps)]
            pending = [r for r in pending if r not in nxt]
            placed |= {r.name for r in nxt}
            ready = nxt
        if pending:
            raise ValueError(
                f"reducer dependency cycle: {[r.name for r in pending]}")
        self.order = order

    def __iter__(self):
        return iter(self.order)

    def names(self) -> list[str]:
        return [r.name for r in self.order]

    def run(self, snap: Snapshot) -> dict[str, dict[str, np.ndarray]]:
        """Execute every reducer applicable to the snapshot's kind."""
        outputs: dict[str, dict[str, np.ndarray]] = {}
        for r in self.order:
            if snap.kind not in r.kinds:
                continue
            if any(d not in outputs for d in r.deps):
                continue   # upstream skipped (kind mismatch)
            out = r.reduce(snap, outputs)
            if out:
                outputs[r.name] = out
        return outputs
