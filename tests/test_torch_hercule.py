"""HDep files from repro_torch.hercule are byte-identical to repro's.

One seeded Sedov tree (plus its host-reduced objects) is written by each
package into its own database; every group file and every manifest must
match byte for byte, and each package must read the other's contexts.
"""
import os

import jax
import numpy as np
import pytest

from repro.hercule import HerculeDB as DBRef
from repro.hercule import api as api_ref
from repro.insitu.reducers import LevelHistogramReducer as HistRef
from repro.insitu.reducers import ProjectionReducer as ProjRef
from repro.insitu.reducers import ReducerDAG as DagRef
from repro.insitu.reducers import SliceReducer as SliceRef
from repro.insitu.staging import Snapshot as SnapRef
from repro.sim import amrgen, fields
from repro_torch.hercule import HerculeDB as DBPt
from repro_torch.hercule import api as api_pt
from repro_torch.insitu import Catalog as CatalogPt
from repro_torch.insitu.reducers import LevelHistogramReducer as HistPt
from repro_torch.insitu.reducers import ProjectionReducer as ProjPt
from repro_torch.insitu.reducers import ReducerDAG as DagPt
from repro_torch.insitu.reducers import SliceReducer as SlicePt
from repro_torch.insitu.staging import Snapshot as SnapPt


def seeded_tree(seed: int):
    rng = np.random.default_rng(seed)
    tree = amrgen.generate_tree(fields.sedov(r_shock=0.2 + 0.1 * rng.random()),
                                min_level=2, max_level=5, threshold=1.1)
    tree.fields["density"] = rng.standard_normal(tree.n_nodes) * 4.0 + 1.0
    return tree


def reduced(dag_cls, snap_cls, reducers, tree):
    return dag_cls(reducers).run(snap_cls(step=0, kind="amr",
                                          arrays=tree.to_arrays()))


def write_db(db_cls, api, root, tree, outputs, *, ncf, compress):
    db = db_cls.create(root, kind="hdep", ncf=ncf)
    for step in (3, 4):
        ctx = db.begin_context(step)
        api.write_object(ctx, "amr_tree", 0, tree, compress_fields=compress)
        for d, (rname, arrays) in enumerate(outputs.items()):
            api.write_object(ctx, "reduced", d, arrays, reducer=rname,
                             compress=compress)
        ctx.finalize(attrs={"note": "parity", "step": step})
    db.close()


def files_of(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module", params=[(0, 1, True), (7, 4, False)],
                ids=["seed0-ncf1-compressed", "seed7-ncf4-raw"])
def written(request, tmp_path_factory):
    seed, ncf, compress = request.param
    tree = seeded_tree(seed)
    with jax.enable_x64(True):
        out_ref = reduced(DagRef, SnapRef, [
            SliceRef(resolution=32), ProjRef(resolution=32),
            HistRef(bins=16)], tree)
    out_pt = reduced(DagPt, SnapPt, [
        SlicePt(resolution=32), ProjPt(resolution=32), HistPt(bins=16)],
        tree)
    base = tmp_path_factory.mktemp(f"hx{seed}")
    roots = {"ref": str(base / "ref"), "pt": str(base / "pt")}
    with jax.enable_x64(True):
        write_db(DBRef, api_ref, roots["ref"], tree, out_ref, ncf=ncf,
                 compress=compress)
    write_db(DBPt, api_pt, roots["pt"], tree, out_pt, ncf=ncf,
             compress=compress)
    return tree, roots, out_ref


def test_files_byte_identical(written):
    _, roots, _ = written
    ref, pt = files_of(roots["ref"]), files_of(roots["pt"])
    assert sorted(ref) == sorted(pt)
    assert any(n.endswith("MANIFEST.json") for n in ref)
    for name in ref:
        assert ref[name] == pt[name], name


@pytest.mark.parametrize("reader", ["ref-reads-port", "port-reads-ref"])
def test_cross_read_tree(written, reader):
    tree, roots, _ = written
    if reader == "ref-reads-port":
        with jax.enable_x64(True):
            db = DBRef.open(roots["pt"])
            got = api_ref.read_object(db, 4, "amr_tree", 0)
    else:
        db = DBPt.open(roots["ref"])
        got = api_pt.read_object(db, 4, "amr_tree", 0)
    assert db.contexts() == [3, 4]
    assert db.load_index(4)["attrs"]["note"] == "parity"
    for k, v in tree.to_arrays().items():
        assert got.to_arrays()[k].tobytes() == v.tobytes(), k
    db.close()


@pytest.mark.parametrize("reader", ["ref-reads-port", "port-reads-ref"])
def test_cross_read_reduced(written, reader):
    _, roots, out_ref = written
    if reader == "ref-reads-port":
        from repro.insitu import Catalog
        with jax.enable_x64(True):
            cat = Catalog(roots["pt"])
            got = {r: cat.query(4, r, domain=d)
                   for d, r in enumerate(out_ref)}
    else:
        cat = CatalogPt(roots["ref"])
        got = {r: cat.query(4, r, domain=d) for d, r in enumerate(out_ref)}
    for rname, arrays in out_ref.items():
        for k, v in arrays.items():
            w = got[rname][k]
            assert w.dtype == v.dtype and w.tobytes() == v.tobytes(), \
                (rname, k)
    cat.close()
