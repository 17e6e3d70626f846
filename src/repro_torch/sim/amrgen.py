"""AMR octree generation from a refinement criterion (RAMSES-like).

Builds the *global* tree level by level: levels up to ``min_level`` are
fully refined (RAMSES ``levelmin`` uniform base grid); beyond that, a cell
refines when the field criterion triggers (density threshold with
per-level scaling — a stand-in for RAMSES' quasi-Lagrangian refinement).
Leaf fields are evaluated at cell centers; coarse cells get the intensive
restriction (mean of sons), which is the father–son codec's predictor.
"""
from __future__ import annotations

import numpy as np

from ..core.amr import AMRTree, CHILD_OFFSETS
from .fields import Field


def generate_tree(field: Field, *, min_level: int = 3, max_level: int = 8,
                  criterion_field: str = "density",
                  threshold: float = 1.2, level_factor: float = 1.35,
                  rng_jitter: float = 0.0, seed: int = 0) -> AMRTree:
    """Generate a global AMR tree driven by ``criterion_field``.

    A level-l cell refines iff l < min_level, or its center value exceeds
    ``threshold * level_factor**(l - min_level)`` (denser regions refine
    deeper — lognormal fields then give realistic depth distributions).
    """
    rng = np.random.default_rng(seed)
    level_coords = [np.zeros((1, 3), np.int64)]
    level_refine = []
    for l in range(max_level):
        coords = level_coords[l]
        n = coords.shape[0]
        if l < min_level:
            ref = np.ones(n, bool)
        else:
            centers = (coords + 0.5) / (1 << l)
            vals = field(criterion_field, centers)
            thr = threshold * level_factor ** (l - min_level)
            if rng_jitter:
                thr = thr * np.exp(rng_jitter * rng.standard_normal(n))
            ref = vals > thr
        level_refine.append(ref)
        kids = (2 * coords[ref][:, None, :] + CHILD_OFFSETS[None, :, :])
        level_coords.append(kids.reshape(-1, 3))
        if not ref.any():
            level_coords = level_coords[:l + 2]
            break
    level_refine.append(np.zeros(level_coords[-1].shape[0], bool))

    refine = np.concatenate(level_refine)
    coords = np.concatenate(level_coords)
    offsets = np.zeros(len(level_coords) + 1, np.int64)
    for i, c in enumerate(level_coords):
        offsets[i + 1] = offsets[i] + c.shape[0]
    tree = AMRTree(refine=refine.astype(bool),
                   owner=np.ones(refine.shape[0], bool),
                   level_offsets=offsets, coords=coords)
    fill_fields(tree, field)
    return tree


def fill_fields(tree: AMRTree, field: Field) -> None:
    """Evaluate fields at leaf centers, then restrict upward to coarse."""
    levels = tree.levels()
    centers = (tree.coords + 0.5) / (1 << levels.astype(np.int64))[:, None]
    leaves = ~tree.refine
    for name in field.names:
        v = np.zeros(tree.n_nodes)
        v[leaves] = field(name, centers[leaves])
        tree.fields[name] = v
    tree.restrict_fields_upward()
