"""Ghost-subtree pruning (paper §2.1): ``repro_torch.core.prune`` against
``repro.core.prune``, bit for bit.

The cases of ``tests/test_amr_prune.py``: the Orion tree (``min_level=3,
max_level=7``) over 8 Hilbert domains with ``local_tree(coarse_level=2)``,
and seeded random Orion trees over 4 domains with ``coarse_level=1``.
Each package builds its local trees from the same numpy arrays; the pruned
trees must agree in ``refine``, ``coords``, ``owner``, ``level_offsets``
and every field. A pruned port tree written as an ``amr_tree`` HDep object
is read back by both packages.
"""
import jax
import numpy as np
import pytest

from repro.core import decompose as decompose_ref
from repro.core import prune as prune_ref
from repro.core.amr import AMRTree as TreeRef
from repro.hercule import HerculeDB as DBRef
from repro.hercule import api as api_ref
from repro.sim import amrgen, fields
from repro_torch.core import decompose, prune
from repro_torch.core.amr import AMRTree
from repro_torch.hercule import HerculeDB
from repro_torch.hercule import api


@pytest.fixture(scope="module")
def orion_arrays():
    t = amrgen.generate_tree(fields.orion(seed=7), min_level=3, max_level=7,
                             threshold=1.0, level_factor=1.6)
    return t.to_arrays()


def pruned_pair(arrays, n_domains, domain, coarse_level):
    """The pruned local tree of ``domain``: (port's, reference's, the
    port's unpruned local tree)."""
    t_ref = TreeRef.from_arrays(arrays)
    t_pt = AMRTree.from_arrays(arrays)
    dom_ref = decompose_ref.assign_domains(t_ref, n_domains)
    dom_pt = decompose.assign_domains(t_pt, n_domains)
    np.testing.assert_array_equal(dom_pt, dom_ref)
    lt_ref = decompose_ref.local_tree(t_ref, dom_ref, domain,
                                      coarse_level=coarse_level)
    lt_pt = decompose.local_tree(t_pt, dom_pt, domain,
                                 coarse_level=coarse_level)
    return prune.prune(lt_pt), prune_ref.prune(lt_ref), lt_pt


def assert_same_tree(got, want):
    a, b = got.to_arrays(), want.to_arrays()
    assert sorted(a) == sorted(b)
    for k in ("refine", "coords", "owner", "level_offsets"):
        assert k in a, k
    for k, v in b.items():
        assert a[k].dtype == v.dtype and a[k].shape == v.shape, k
        assert a[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("domain", range(8))
def test_prune_orion_domains_bit_equal(orion_arrays, domain):
    got, want, local = pruned_pair(orion_arrays, 8, domain, 2)
    got.validate()
    assert_same_tree(got, want)
    frac = prune.removed_fraction(local, got)
    assert frac == prune_ref.removed_fraction(
        TreeRef.from_arrays(local.to_arrays()), want)
    assert 0.05 < frac < 0.7
    assert prune.prune(got).n_nodes == got.n_nodes          # idempotent


@pytest.mark.parametrize("seed", [0, 17, 4242, 9999])
def test_prune_random_trees_bit_equal(seed):
    t = amrgen.generate_tree(fields.orion(seed=seed % 100), min_level=2,
                             max_level=5, threshold=1.0, level_factor=1.5)
    got, want, local = pruned_pair(t.to_arrays(), 4, seed % 4, 1)
    got.validate()
    assert_same_tree(got, want)
    assert got.owner.sum() == local.owner.sum()


def test_pruned_port_tree_round_trips_as_hdep_object(tmp_path):
    t = amrgen.generate_tree(fields.sedov(), min_level=2, max_level=5,
                             threshold=1.2)
    pt, want, _ = pruned_pair(t.to_arrays(), 4, 1, 1)
    db = HerculeDB.create(str(tmp_path / "hd"), kind="hdep", ncf=2)
    ctx = db.begin_context(0)
    api.write_object(ctx, "amr_tree", 1, pt)
    ctx.finalize()
    db.close()
    back = api.read_object(HerculeDB.open(str(tmp_path / "hd")), 0,
                           "amr_tree", 1)
    back.validate()
    assert_same_tree(back, pt)
    with jax.enable_x64(True):
        db_ref = DBRef.open(str(tmp_path / "hd"))
        got_ref = api_ref.read_object(db_ref, 0, "amr_tree", 1)
        db_ref.close()
    got_ref.validate()
    assert_same_tree(got_ref, want)
