"""The mesh path's float32 tables: ``MeshDAGRunner(dtype="float32")`` and
the float32 B3-B5 against the reference.

Same small Sedov tree as ``tests/test_torch_mesh.py`` (R = 32, 1,481
nodes), its density cast to float32. Contract:

  * the port's float32 partial rasters (``ops.raster_*_partial``, the
    plain twins on CPU tensors) are bit-equal to ``repro.kernels.ops``'
    at float32 with ``pallas_interpret`` and ``ref``: tiles of 512 and
    4,096 rows; slice positions 0.5 and on exact cell boundaries; a
    level-26 table whose float32 plane test rounds ``lo + 2^-26`` back to
    ``lo``; histogram edges that float32 cannot hold;
  * a one-shard float32 mesh is bit-equal to the reference's float32
    mesh runner (float32 images);
  * four shards on the CPU meet DESIGN.md's f32 policy against the
    float64 host reducers — slice rtol 1e-6, projection rtol 1e-4,
    histogram and edges exact against the host over the cast field — and
    the projection is bit-equal to the ascending fold of the reference's
    per-shard float32 partials;
  * a float32 run uploads exactly half the field bytes of a float64 run.

Tolerance: bitwise everywhere but the comparisons with the float64 host
reducers, which use DESIGN.md's bounds. Every JAX call runs under
``jax.enable_x64(True)``. The ``gpu`` case holds the float32 kernels
against their twins on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.insitu import reducers as red_ref
from repro.insitu.mesh_reduce import MeshDAGRunner as MeshRef
from repro.insitu.partition import leaf_shards as leaf_shards_ref
from repro.insitu.staging import Snapshot as SnapRef
from repro.kernels import ops as ops_ref
from repro.kernels import ref as jref
from repro_torch.insitu import reducers as red_pt
from repro_torch.insitu.mesh_reduce import MeshDAGRunner, MeshTable
from repro_torch.insitu.staging import Snapshot
from repro_torch.kernels import ops, raster, ref
from test_torch_mesh import (BOUNDARIES, PNAME, SNAME, R, assert_bits, dag,
                             host, node_tables, sedov_arrays)

CPU = torch.device("cpu")
HNAME = "hist-density-b16"


@pytest.fixture(scope="module")
def arrays():
    return sedov_arrays()


def f32_table(arrays):
    x = node_tables(arrays)
    return {**x, "values": x["values"].astype(np.float32)}


def level26_table():
    """Leaves at level 26 of 27 whose float32 plane test at position 0.3
    differs from the float64 one: ``c * 2^-26`` and ``lo + 2^-26`` round
    in float32 (c > 2^24), so some leaves the float64 plane holds are
    missed and the level-26 pair 20132659/20132660 paints nothing; plus
    coarse leaves that do paint."""
    rng = np.random.default_rng(26)
    c_axis = np.array([20132656, 20132657, 20132658, 20132659, 20132660,
                       20132661, 20132662], np.int64)
    fine = np.stack([rng.integers(0, 1 << 26, c_axis.size),
                     rng.integers(0, 1 << 26, c_axis.size), c_axis], 1)
    coarse = rng.integers(0, 4, size=(9, 3))
    coarse[:, 2] = 1                     # level 2, cells [0.25, 0.5)
    coords = np.concatenate([coarse, fine]).astype(np.int32)
    levels = np.concatenate([np.full(9, 2), np.full(c_axis.size, 26)]
                            ).astype(np.int32)
    values = rng.standard_normal(levels.size).astype(np.float32)
    return {"coords": coords, "levels": levels, "values": values,
            "ok": np.ones(levels.size, bool), "n_levels": 27}


def port_partial(x, kind, *, resolution=R, position=0.5, tile_n=None,
                 backend=None, device=CPU):
    t = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in x.items()
         if k != "n_levels"}
    kw = dict(axis=2, resolution=resolution, n_levels=x["n_levels"],
              backend=backend, tile_n=tile_n)
    if kind == "slice":
        return ops.raster_slice_partial(t["coords"], t["levels"],
                                        t["values"], t["ok"],
                                        position=position, **kw)
    return (ops.raster_projection_partial(t["coords"], t["levels"],
                                          t["values"], t["ok"], **kw),)


def reference_partial(x, kind, backend, *, resolution=R, position=0.5,
                      tile_n=None):
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in x.items() if k != "n_levels"}
        kw = dict(axis=2, resolution=resolution, n_levels=x["n_levels"],
                  backend=backend, tile_n=tile_n)
        if kind == "slice":
            out = ops_ref.raster_slice_partial(
                j["coords"], j["levels"], j["values"], j["ok"],
                position=position, **kw)
        else:
            out = (ops_ref.raster_projection_partial(
                j["coords"], j["levels"], j["values"], j["ok"], **kw),)
        return tuple(np.asarray(o) for o in out)


def hist_edges(values, bins=16):
    """Edges float32 cannot hold, slightly inside the values' range, so
    rows fall on and past both ends."""
    lo, hi = float(values.min()), float(values.max())
    return np.linspace(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo), bins + 1)


def run(mesh_cls, dag_mod, snap_cls, arrays, **kw):
    return mesh_cls(dag(dag_mod), **kw).run(
        snap_cls(step=0, kind="amr", arrays=arrays))


@pytest.fixture
def reference_runner(monkeypatch):
    import jax.experimental
    # the reference runner spells jax.enable_x64 the pre-0.9 way
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    return MeshRef


# ---------------------------------------------------- twins (partials)

@pytest.mark.parametrize("backend", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("tile_n", [512, 4096])
@pytest.mark.parametrize("position", BOUNDARIES)
def test_f32_slice_partial_bit_equal_to_reference(arrays, position, tile_n,
                                                  backend):
    x = f32_table(arrays)
    got = port_partial(x, "slice", position=position, tile_n=tile_n)
    want = reference_partial(x, "slice", backend, position=position,
                             tile_n=tile_n)
    assert got[0].dtype == torch.float32
    for g, w, what in zip(got, want, ("image", "depth")):
        assert_bits(g.numpy(), w, f"f32 slice {what} at {position}")


@pytest.mark.parametrize("backend", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("tile_n", [512, 4096])
def test_f32_projection_partial_bit_equal_to_reference(arrays, tile_n,
                                                       backend):
    x = f32_table(arrays)
    (got,) = port_partial(x, "projection", tile_n=tile_n)
    (want,) = reference_partial(x, "projection", backend, tile_n=tile_n)
    assert got.dtype == torch.float32
    assert_bits(got.numpy(), want, f"f32 projection tile_n={tile_n}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("backend", ["pallas_interpret", "ref"])
def test_level26_plane_test_in_the_values_dtype(backend, dtype):
    """The float32 plane test rounds as the reference's: at level 26 of
    27 the leaf pair 20132659/20132660 paints nothing at position 0.3 in
    float32 (``lo + 2^-26`` rounds back to ``lo``); float64 stays exact."""
    x = level26_table()
    x["values"] = x["values"].astype(dtype)
    got = port_partial(x, "slice", resolution=4, position=0.3)
    want = reference_partial(x, "slice", backend, resolution=4,
                             position=0.3)
    for g, w, what in zip(got, want, ("image", "depth")):
        assert_bits(g.numpy(), w, f"level-26 {what}")
    if dtype == np.float32:
        assert int(got[1].max()) == 2          # no level-26 leaf painted
    else:
        assert int(got[1].max()) == 26


def test_level26_pair_paints_nothing_as_the_reference_twin():
    """The case as first found: two level-26 leaves, R = 4, float32."""
    c_axis = np.array([20132659, 20132660], np.int32)
    args = (np.zeros((2, 2), np.int32), c_axis, np.full(2, 26, np.int32),
            np.ones(2, np.float32), np.ones(2, bool))
    kw = dict(position=0.3, resolution=4, n_levels=27)
    img, depth = ref.slice_raster_depth_ref(
        *(torch.from_numpy(a) for a in args), **kw)
    with jax.enable_x64(True):
        want = jref.slice_raster_depth_ref(*(jnp.asarray(a) for a in args),
                                           **kw)
    assert_bits(img.numpy(), np.asarray(want[0]), "image")
    assert_bits(depth.numpy(), np.asarray(want[1]), "depth")
    assert bool(torch.isnan(img).all()) and int(depth.max()) == -1


@pytest.mark.parametrize("backend", ["pallas_interpret", "ref"])
@pytest.mark.parametrize("edge_kind", ["unrepresentable", "cast_bounds"])
def test_f32_level_hist_partial_bit_equal_to_reference(arrays, edge_kind,
                                                       backend):
    """Float32 values binned against float64 edges, compared in float64
    as the reference's promotion does — also for values equal to the
    float32 rounding of an edge that float32 cannot hold."""
    x = f32_table(arrays)
    v = x["values"]
    if edge_kind == "unrepresentable":
        edges = hist_edges(v)
        assert (edges.astype(np.float32) != edges).any()
        v = v.copy()
        v[:4] = edges[[0, -1, 0, -1]].astype(np.float32)   # on an edge
        x = {**x, "values": v}
    else:
        edges = np.linspace(float(v.min()), float(v.max()), 17)
    got = ops.raster_level_hist_partial(
        torch.from_numpy(v), torch.from_numpy(x["levels"]),
        torch.from_numpy(x["ok"]), torch.from_numpy(edges),
        n_levels=x["n_levels"])
    with jax.enable_x64(True):
        want = ops_ref.raster_level_hist_partial(
            jnp.asarray(v), jnp.asarray(x["levels"]), jnp.asarray(x["ok"]),
            jnp.asarray(edges), n_levels=x["n_levels"], backend=backend)
    assert_bits(got.numpy(), np.asarray(want), f"f32 hist {edge_kind}")
    assert int(got.sum()) > 0


def test_f32_twins_keep_float32_and_count_nothing(arrays):
    """On CPU tensors the float32 wrappers run their twins: float32
    outputs (default seeds in the values' dtype), no launch counted."""
    x = f32_table(arrays)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    c2 = ops.plane_coords(t["coords"], 2)
    geo = dict(resolution=R, n_levels=x["n_levels"])
    before = dict(raster.LAUNCHES)
    img, depth = raster.slice_raster_carry(
        c2, t["coords"][:, 2], t["levels"], t["values"], t["ok"],
        position=0.5, **geo)
    proj = raster.projection_raster_carry(c2, t["levels"], t["values"],
                                          t["ok"], **geo)
    hist = raster.level_hist(t["values"], t["levels"], t["ok"],
                             torch.linspace(-8.0, 8.0, 17,
                                            dtype=torch.float64),
                             n_levels=x["n_levels"])
    assert img.dtype == proj.dtype == torch.float32
    assert depth.dtype == hist.dtype == torch.int32
    assert raster.LAUNCHES == before


@pytest.mark.parametrize("x", [0.5, 0.3, 0.1, 1 / 3, 0.123456789,
                               1 + 2.0 ** -24, 1 + 3 * 2.0 ** -24,
                               1 - 2.0 ** -25, 2.0 ** -140])
def test_round_f32_is_numpy_float32(x):
    """B4-f32's position is rounded once on the host, to nearest even, as
    numpy's (and torch's, the twin's) float64 -> float32 cast."""
    got = raster.round_f32(x)
    assert got == float(np.float32(x))
    assert got == torch.tensor(x, dtype=torch.float32).item()


# ------------------------------------------------------------- runner

@pytest.mark.parametrize("backend", [None, "ref"])
def test_f32_single_shard_bit_equal_to_reference_runner(
        arrays, reference_runner, backend):
    want = run(reference_runner, red_ref, SnapRef, arrays, devices=1,
               backend="ref", dtype="float32")
    got = run(MeshDAGRunner, red_pt, Snapshot, arrays, devices=[CPU],
              backend=backend, dtype="float32")
    assert sorted(got) == sorted(want)
    for name, o in want.items():
        for k, v in o.items():
            assert_bits(got[name][k], v, f"{name}/{k}")
    assert got[SNAME]["image"].dtype == got[PNAME]["image"].dtype == \
        np.float32


def shard_partials_fold(arrays):
    """The reference's float32 projection partial of each Hilbert shard's
    leaves (BFS order), folded in ascending shard order in float32."""
    x = f32_table(arrays)
    leaves = np.flatnonzero(~np.asarray(arrays["refine"]))
    shard = leaf_shards_ref(arrays, 4)
    acc = None
    for g in range(4):
        rows = leaves[shard == g]
        part = {k: (v[rows] if k != "n_levels" else v) for k, v in x.items()}
        (p,) = reference_partial(part, "projection", "ref")
        acc = p if acc is None else acc + p
    return acc


@pytest.mark.parametrize("tile_n", [16384, 512])
def test_f32_four_shards_meet_the_f32_policy(arrays, tile_n):
    got = run(MeshDAGRunner, red_pt, Snapshot, arrays, devices=[CPU] * 4,
              dtype="float32", tile_n=tile_n)
    want = host(arrays)
    s, p = got[SNAME]["image"], got[PNAME]["image"]
    assert s.dtype == p.dtype == np.float32
    np.testing.assert_allclose(s.astype(np.float64), want[SNAME]["image"],
                               rtol=1e-6)
    np.testing.assert_allclose(p.astype(np.float64), want[PNAME]["image"],
                               rtol=1e-4)
    assert_bits(p, shard_partials_fold(arrays), "projection vs shard fold")
    cast = {**arrays, "field:density": arrays["field:density"]
            .astype(np.float32).astype(np.float64)}
    cast_host = host(cast)
    for k in ("hist", "edges"):
        assert_bits(np.asarray(got[HNAME][k]), cast_host[HNAME][k],
                    f"hist/{k} vs host over the cast field")


def test_f32_auto_edges_bound_the_cast_values(arrays):
    """``field_bounds`` of a float32 table are the cast values' min/max,
    so the auto edges are the host's over the cast field."""
    mt = MeshTable(arrays, 1, [CPU] * 2, dtype="float32")
    v32 = arrays["field:density"].astype(np.float32)
    leaves = ~np.asarray(arrays["refine"])
    assert mt.field_bounds("density") == (float(v32[leaves].min()),
                                          float(v32[leaves].max()))
    assert mt.field_bounds("density") != \
        MeshTable(arrays, 1, [CPU] * 2).field_bounds("density")
    assert all(t.dtype == torch.float32 for t in mt.field("density"))


@pytest.mark.parametrize("n_shards", [1, 4])
def test_f32_uploads_half_the_field_bytes(arrays, n_shards):
    def stats(dtype):
        runner = MeshDAGRunner(dag(red_pt), devices=[CPU] * n_shards,
                               dtype=dtype)
        runner.run(Snapshot(step=0, kind="amr", arrays=arrays))
        return runner.stats
    s64, s32 = stats(None), stats("float32")
    rows = MeshTable(arrays, 1, [CPU] * n_shards).rows_padded
    field64 = n_shards * rows * 8
    assert s64.bytes_tables_to_device - s32.bytes_tables_to_device == \
        field64 // 2
    assert stats("float64").bytes_tables_to_device == \
        s64.bytes_tables_to_device
    # the two images cross at half the bytes too
    assert s64.as_dict()["bytes_to_host"] - \
        s32.as_dict()["bytes_to_host"] == 2 * R * R * 4


# --------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_n", [512, 4096])
def test_cuda_f32_kernels_bit_equal_to_twins(cuda_device, arrays, tile_n):
    """B4-f32 and B5-f32 chained over tiles at every boundary position,
    the level-26 table, and B3-f32 on unrepresentable edges: bitwise
    against the float32 twins on the card, float32 launches only."""
    x = f32_table(arrays)
    raster.reset_launches()
    cases = [(x, R, pos) for pos in (0.5, *BOUNDARIES)] + \
        [(level26_table(), 4, 0.3)]
    for tbl, res, pos in cases:
        kw = dict(resolution=res, tile_n=tile_n, device=cuda_device)
        for kind in ("slice", "projection"):
            got = port_partial(tbl, kind, position=pos, backend="cuda", **kw)
            want = port_partial(tbl, kind, position=pos, backend="ref", **kw)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    edges = torch.from_numpy(hist_edges(x["values"])).to(cuda_device)
    t = [torch.from_numpy(x[k]).to(cuda_device)
         for k in ("values", "levels", "ok")]
    got = ops.raster_level_hist_partial(*t, edges, n_levels=x["n_levels"],
                                        backend="cuda")
    want = ops.raster_level_hist_partial(*t, edges, n_levels=x["n_levels"],
                                         backend="ref")
    assert torch.equal(got, want)
    assert raster.LAUNCHES["level_hist_f32"] == 1
    assert raster.LAUNCHES["slice_raster_carry_f32"] > 0
    assert raster.LAUNCHES["projection_raster_carry_f32"] > 0
    assert raster.LAUNCHES["slice_raster_carry"] == \
        raster.LAUNCHES["projection_raster_carry"] == \
        raster.LAUNCHES["level_hist"] == 0
