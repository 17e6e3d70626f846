"""The sharded mesh path (``repro_torch.insitu.mesh_reduce``) and its
carry kernels B4/B5 against the reference.

Small size throughout: a Sedov tree (``min_level=2, max_level=5``,
1,481 nodes) at R = 32 = 2**max_level, where slice painting is
collision-free. Contract, as ``tests/test_mesh_reduce.py`` states it:

  * the carry twins (``kernels/ref``, what a CPU tensor runs) chained
    over BFS tiles are bit-equal — image and depth — to the reference's
    Pallas carry kernels in interpret mode at the same ``tile_n``, and
    to the untiled raster;
  * a one-shard mesh is bit-equal to the reference's one-device mesh
    runner and to the host reducers;
  * S shards on the CPU (``[cpu] * S``): slice, histogram and LOD cut
    bit-equal to the host reducers, the projection bit-equal to the
    ascending fold of the per-shard host reductions (``md_fold``) and
    within rtol 1e-12 of the host image.

Every JAX call runs under ``jax.enable_x64(True)``. The ``gpu`` case
holds the CUDA carry kernels against their twins on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.insitu import Catalog as CatalogRef
from repro.insitu import InTransitEngine as EngineRef
from repro.insitu import partition_snapshot
from repro.insitu import reducers as red_ref
from repro.insitu.mesh_reduce import MeshDAGRunner as MeshRef
from repro.insitu.partition import leaf_shards as leaf_shards_ref
from repro.insitu.staging import Snapshot as SnapRef
from repro.kernels import ops as ops_ref
from repro.kernels import raster_kernel
from repro.sim import amrgen, fields
from repro_torch.insitu import Catalog, InTransitEngine
from repro_torch.insitu import reducers as red_pt
from repro_torch.insitu.mesh_reduce import (MESH_TILE, MeshDAGRunner,
                                            mesh_devices, mesh_impl_for)
from repro_torch.insitu.staging import Snapshot
from repro_torch.kernels import ops, raster, ref
from repro_torch.launch import insitu as cli
from test_torch_raster import TABLE_GEOMETRY, projection_table, reference_ok

R = 32
CPU = torch.device("cpu")
SNAME = f"slice-density-ax2-p0.5-r{R}"
PNAME = f"proj-density-ax2-r{R}"


def sedov_arrays(seed: int = 0) -> dict:
    """A Sedov structure (6 levels) with random sign-mixed densities."""
    rng = np.random.default_rng(seed)
    tree = amrgen.generate_tree(fields.sedov(r_shock=0.2), min_level=2,
                                max_level=5, threshold=1.15,
                                level_factor=1.05)
    tree.fields["density"] = rng.standard_normal(tree.n_nodes) * 4.0 + 1.0
    return tree.to_arrays()


@pytest.fixture(scope="module")
def arrays():
    return sedov_arrays()


def dag(mod, lod: int = 3):
    return mod.ReducerDAG([
        mod.SliceReducer(field="density", axis=2, position=0.5,
                         resolution=R),
        mod.ProjectionReducer(field="density", axis=2, resolution=R),
        mod.LevelHistogramReducer(field="density", bins=16),
        mod.LODCutReducer(max_level=lod),
        mod.SliceReducer(field="density", axis=2, position=0.5,
                         resolution=R, source=f"lod{lod}"),
    ])


def host(arrays, *, domain=0, n_domains=1):
    """The reference host reducers' outputs for :func:`dag`."""
    d = dag(red_ref)
    snap = SnapRef(step=0, kind="amr", arrays=arrays, domain=domain,
                   n_domains=n_domains)
    out = {}
    for r in d.order:
        o = r.reduce(snap, out)
        if o:
            out[r.name] = o
    return out


def md_fold(arrays, n_shards: int):
    """Read-side reference: per-Hilbert-domain host projections folded in
    ascending domain order (``hercule.api._merge_sum``)."""
    refine = np.asarray(arrays["refine"])
    leaves = np.flatnonzero(~refine)
    shard = leaf_shards_ref(arrays, n_shards)
    proj = red_ref.ProjectionReducer(field="density", axis=2, resolution=R)
    acc = None
    for g in range(n_shards):
        owner = np.zeros(refine.shape[0], bool)
        owner[leaves[shard == g]] = True
        part = proj.reduce(SnapRef(step=0, kind="amr",
                                   arrays={**arrays, "owner": owner},
                                   n_domains=2), {})["image"]
        acc = part if acc is None else acc + part
    return acc


def assert_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def node_tables(arrays):
    """Flat node arrays (numpy) as the partial entry points take them."""
    levels = (np.searchsorted(arrays["level_offsets"],
                              np.arange(arrays["refine"].shape[0]),
                              side="right") - 1).astype(np.int32)
    return {"coords": arrays["coords"], "levels": levels,
            "values": arrays["field:density"], "ok": ~arrays["refine"],
            "n_levels": arrays["level_offsets"].shape[0] - 1}


def port_partial(x, kind, tile_n, backend=None):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    kw = dict(axis=2, resolution=R, n_levels=x["n_levels"],
              backend=backend, tile_n=tile_n)
    if kind == "slice":
        img, depth = ops.raster_slice_partial(
            t["coords"], t["levels"], t["values"], t["ok"], position=0.5,
            **kw)
        return img.numpy(), depth.numpy()
    return (ops.raster_projection_partial(
        t["coords"], t["levels"], t["values"], t["ok"], **kw).numpy(),)


def reference_partial(x, kind, tile_n, position=0.5):
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in x.items() if k != "n_levels"}
        kw = dict(axis=2, resolution=R, n_levels=x["n_levels"],
                  backend="pallas_interpret", tile_n=tile_n)
        if kind == "slice":
            out = ops_ref.raster_slice_partial(
                j["coords"], j["levels"], j["values"], j["ok"],
                position=position, **kw)
        else:
            out = (ops_ref.raster_projection_partial(
                j["coords"], j["levels"], j["values"], j["ok"], **kw),)
        return tuple(np.asarray(o) for o in out)


# ------------------------------------------------------ carry kernels

@pytest.mark.parametrize("tile_n", [512, 4096])
@pytest.mark.parametrize("kind", ["slice", "projection"])
def test_carry_twins_bit_equal_to_reference_kernels(arrays, kind, tile_n):
    """B4/B5 semantics: the port's chained twins against the reference's
    Pallas carry kernels (interpret mode), image and depth."""
    x = node_tables(arrays)
    got = port_partial(x, kind, tile_n)
    want = reference_partial(x, kind, tile_n)
    assert len(got) == len(want)
    for g, w, what in zip(got, want, ("image", "depth")):
        assert_bits(g, w, f"{kind} {what} tile_n={tile_n}")


@pytest.mark.parametrize("tile_n", [512, 1024])
@pytest.mark.parametrize("kind", ["slice", "projection"])
def test_tiled_equals_whole(arrays, kind, tile_n):
    """Chaining BFS tiles is bit-identical to one call over the table,
    and the partial's image to the one-shot raster (B1/B2)."""
    x = node_tables(arrays)
    assert x["values"].shape[0] > tile_n            # several tiles
    tiled = port_partial(x, kind, tile_n)
    whole = port_partial(x, kind, None)
    for a, b in zip(tiled, whole):
        assert_bits(a, b, f"{kind} tiled vs whole")
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    if kind == "slice":
        one = ops.raster_slice(t["coords"], t["levels"], t["values"],
                               t["ok"], axis=2, position=0.5, resolution=R,
                               n_levels=x["n_levels"])
    else:
        one = ops.raster_projection(t["coords"], t["levels"], t["values"],
                                    t["ok"], axis=2, resolution=R,
                                    n_levels=x["n_levels"])
    assert_bits(tiled[0], one.numpy(), f"{kind} tiled vs one-shot")


def test_projection_twin_is_exact_for_any_seed(arrays):
    """The seeded projection twin adds per pixel, so a seed that varies
    inside a coarse cell keeps its bits under every add sequence."""
    x = node_tables(arrays)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    c2 = ops.plane_coords(t["coords"], 2)
    seed = torch.from_numpy(np.random.default_rng(3).standard_normal((R, R)))
    got = ref.projection_raster_ref(c2, t["levels"], t["values"], t["ok"],
                                    resolution=R, n_levels=x["n_levels"],
                                    init=seed)
    # the same adds one pixel at a time, in row (BFS) order
    u0, v0, px = raster.leaf_table(c2, t["levels"], resolution=R)
    want = seed.clone()
    for row in np.flatnonzero(x["ok"]):
        lv = int(x["levels"][row])
        rect = want[u0[row]:u0[row] + px[row], v0[row]:v0[row] + px[row]]
        rect += t["values"][row] * (2.0 ** -lv)
    assert_bits(got.numpy(), want.numpy(), "seeded projection")


def chained_projection(x: dict, *, resolution: int, tile_n: int,
                       backend=None, device=CPU) -> torch.Tensor:
    """``ops.raster_projection_partial`` over ``x`` (a
    :func:`projection_table`), chained over ``tile_n``-row tiles."""
    t = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in x.items()
         if k != "n_levels"}
    return ops.raster_projection_partial(
        t["coords"], t["levels"], t["values"], t["ok"], axis=2,
        resolution=resolution, n_levels=x["n_levels"], backend=backend,
        tile_n=tile_n)


@pytest.mark.parametrize("tile_n", [512, 1024])
@pytest.mark.parametrize("resolution,n_levels", TABLE_GEOMETRY)
def test_projection_carry_twin_on_adversarial_tables(resolution, n_levels,
                                                     tile_n):
    """B5's semantics on tables the CSR must get right, chained over BFS
    tiles: deep columns, sub-pixel levels, n_levels > k + 1, rows of
    out-of-range level, an all-invalid tile (2,100 ok=False rows) and
    the last tile's padding rows — bit-equal to the reference's Pallas
    carry kernel (interpret mode) and to the untiled twin."""
    x = projection_table(5, resolution=resolution, n_levels=n_levels,
                         invalid_run=2100)
    n = x["values"].shape[0]
    assert n % tile_n and n > 2 * tile_n        # padded, several tiles
    got = chained_projection(x, resolution=resolution, tile_n=tile_n)
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in x.items() if k != "n_levels"}
        want = ops_ref.raster_projection_partial(
            j["coords"], j["levels"], j["values"],
            jnp.asarray(reference_ok(x)), axis=2, resolution=resolution,
            n_levels=n_levels, backend="pallas_interpret", tile_n=tile_n)
    assert_bits(got.numpy(), np.asarray(want),
                f"chained projection R={resolution} tile_n={tile_n}")
    whole = chained_projection(x, resolution=resolution, tile_n=None)
    assert_bits(got.numpy(), whole.numpy(), "chained vs whole")


def test_carry_wrappers_on_cpu_run_the_twin_and_count_nothing(arrays):
    x = node_tables(arrays)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    c2 = ops.plane_coords(t["coords"], 2)
    geo = dict(resolution=R, n_levels=x["n_levels"])
    before = dict(raster.LAUNCHES)
    img, depth = raster.slice_raster_carry(c2, t["coords"][:, 2],
                                           t["levels"], t["values"], t["ok"],
                                           position=0.5, **geo)
    want = ref.slice_raster_depth_ref(c2, t["coords"][:, 2], t["levels"],
                                      t["values"], t["ok"], position=0.5,
                                      **geo)
    assert torch.equal(img.view(torch.int64), want[0].view(torch.int64))
    assert torch.equal(depth, want[1]) and depth.dtype == torch.int32
    p = raster.projection_raster_carry(c2, t["levels"], t["values"],
                                       t["ok"], init=img.nan_to_num(), **geo)
    assert torch.equal(p, ref.projection_raster_ref(
        c2, t["levels"], t["values"], t["ok"], init=img.nan_to_num(), **geo))
    assert raster.LAUNCHES == before


def test_tile_n_must_be_a_block_multiple(arrays):
    x = node_tables(arrays)
    with pytest.raises(ValueError, match="not a multiple of block_n=512"):
        port_partial(x, "projection", 1000)


#: slice positions on exact cell boundaries: the domain's low face, a
#: level-2 and a level-1 face, and the low face of the finest level's last
#: cell (max_level = 5)
BOUNDARIES = [0.0, 0.25, 0.5, 1 - 2.0 ** -5]


def with_bad_levels(x):
    """``x`` with every 97th valid leaf given a level outside [0,
    n_levels): rows the level-range test must drop."""
    levels = x["levels"].copy()
    rows = np.flatnonzero(x["ok"])[::97]
    levels[rows] = np.resize([x["n_levels"], x["n_levels"] + 3, -1],
                             rows.size)
    return {**x, "levels": levels}


def fused_good(c_axis, levels, ok, *, position, n_levels):
    """``slice_carry_paint_kernel``'s row test, as the CUDA source writes
    it: ok, 0 <= lvl < n_levels, size = ldexp(1, -lvl), lo = c * size,
    lo <= position < lo + size."""
    lvl = levels.astype(np.int64)
    size = np.ldexp(1.0, -lvl)
    lo = c_axis.astype(np.float64) * size
    return (ok & (lvl >= 0) & (lvl < n_levels) & (lo <= position)
            & (position < lo + size))


def reference_carry_chain(table, values, *, tile_n):
    """The reference's Pallas ``slice_raster_carry`` (interpret mode)
    chained over ``tile_n``-row tiles of a given leaf table."""
    n = values.shape[0]
    with jax.enable_x64(True):
        img = jnp.full((R, R), jnp.nan, jnp.float64)
        depth = jnp.full((R, R), -1, jnp.int32)
        for a in range(0, n, tile_n):
            cols = [jnp.asarray(c[a:a + tile_n]) for c in (*table, values)]
            u0, v0, px, lvl, good, val = (
                ops_ref._pad_leaf(c, 1 if i == 2 else 0, ops.BLOCK_N)
                for i, c in enumerate(cols))
            img, depth = raster_kernel.slice_raster_carry(
                u0, v0, px, lvl, val, good, img, depth, resolution=R,
                block_n=ops.BLOCK_N, interpret=True)
        return np.asarray(img), np.asarray(depth)


@pytest.mark.parametrize("bad_levels", [False, True])
@pytest.mark.parametrize("position", BOUNDARIES)
def test_slice_carry_predicate_at_cell_boundaries(arrays, position,
                                                  bad_levels):
    """What B4's fused paint kernel computes per leaf — ``_slice_table``'s
    geometry, level range and float64 plane test — at positions on exact
    cell boundaries and with rows of out-of-range level: the port's
    chained twin equals the reference's interpret-mode carry kernel fed
    the port's table, and (levels in range) the reference's own partial."""
    x = node_tables(arrays)
    if bad_levels:
        x = with_bad_levels(x)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    c2 = ops.plane_coords(t["coords"], 2)
    c_axis = t["coords"][:, 2].to(torch.int32)
    u0, v0, px, lvl, good = raster._slice_table(
        c2, c_axis, t["levels"], t["ok"], position=position, resolution=R,
        n_levels=x["n_levels"])
    want_good = fused_good(x["coords"][:, 2], x["levels"], x["ok"],
                           position=position, n_levels=x["n_levels"])
    np.testing.assert_array_equal(good.numpy().astype(bool), want_good)
    assert 0 < want_good.sum() < x["ok"].sum()
    got = ops.raster_slice_partial(t["coords"], t["levels"], t["values"],
                                   t["ok"], axis=2, position=position,
                                   resolution=R, n_levels=x["n_levels"],
                                   tile_n=512)
    want = reference_carry_chain([c.numpy() for c in (u0, v0, px, lvl,
                                                      good)],
                                 x["values"], tile_n=512)
    for g, w, what in zip(got, want, ("image", "depth")):
        assert_bits(g.numpy(), w, f"{what} at {position}")
    if not bad_levels:
        for g, w, what in zip(got, reference_partial(x, "slice", 512,
                                                     position=position),
                              ("image", "depth")):
            assert_bits(g.numpy(), w, f"reference {what} at {position}")


def reference_slice(table, values):
    """The reference's Pallas ``slice_raster`` (interpret mode) over a
    given whole leaf table."""
    with jax.enable_x64(True):
        u0, v0, px, lvl, good, val = (
            ops_ref._pad_leaf(jnp.asarray(c), 1 if i == 2 else 0,
                              ops.BLOCK_N)
            for i, c in enumerate((*table, values)))
        return np.asarray(raster_kernel.slice_raster(
            u0, v0, px, lvl, val, good, resolution=R, block_n=ops.BLOCK_N,
            interpret=True))


@pytest.mark.parametrize("bad_levels", [False, True])
@pytest.mark.parametrize("position", BOUNDARIES)
def test_slice_predicate_at_cell_boundaries(arrays, position, bad_levels):
    """What B1's one C call computes per row — the paint kernel it shares
    with B4: ``_slice_table``'s geometry, level range and float64 plane
    test — at positions on exact cell boundaries and with rows of
    out-of-range level: the port's slice (the twin, on the CPU) equals
    the reference's interpret-mode ``slice_raster`` fed the port's
    table, and (levels in range) the reference's own slice."""
    x = node_tables(arrays)
    if bad_levels:
        x = with_bad_levels(x)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    table = raster._slice_table(
        ops.plane_coords(t["coords"], 2), t["coords"][:, 2].to(torch.int32),
        t["levels"], t["ok"], position=position, resolution=R,
        n_levels=x["n_levels"])
    want_good = fused_good(x["coords"][:, 2], x["levels"], x["ok"],
                           position=position, n_levels=x["n_levels"])
    np.testing.assert_array_equal(table[4].numpy().astype(bool), want_good)
    got = ops.raster_slice(t["coords"], t["levels"], t["values"], t["ok"],
                           axis=2, position=position, resolution=R,
                           n_levels=x["n_levels"]).numpy()
    assert_bits(got, reference_slice([c.numpy() for c in table],
                                     x["values"]), f"slice at {position}")
    if not bad_levels:
        with jax.enable_x64(True):
            j = {k: jnp.asarray(v) for k, v in x.items() if k != "n_levels"}
            want = ops_ref.raster_slice(
                j["coords"], j["levels"], j["values"], j["ok"], axis=2,
                position=position, resolution=R, n_levels=x["n_levels"],
                backend="pallas_interpret")
        assert_bits(got, np.asarray(want), f"reference slice at {position}")


# ------------------------------------------------------------- runner

def port_run(arrays, devices, *, tile_n=MESH_TILE, backend=None, **snap):
    runner = MeshDAGRunner(dag(red_pt), devices=devices, backend=backend,
                           tile_n=tile_n)
    out = runner.run(Snapshot(step=0, kind="amr", arrays=arrays, **snap))
    return out, runner.stats.as_dict()


@pytest.mark.parametrize("backend", [None, "ref"])
def test_single_shard_matches_reference_mesh_runner(arrays, monkeypatch,
                                                    backend):
    """One shard means no fold: every output is bit-equal to the
    reference's one-device mesh runner and to the host reducers."""
    import jax.experimental
    # the reference runner spells jax.enable_x64 the pre-0.9 way
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    want = MeshRef(dag(red_ref), devices=1, backend="ref").run(
        SnapRef(step=0, kind="amr", arrays=arrays))
    got, st = port_run(arrays, [CPU], backend=backend)
    assert sorted(got) == sorted(want)
    for name, o in want.items():
        for k, v in o.items():
            assert_bits(got[name][k], v, f"{name}/{k}")
    hst = host(arrays)
    for name, o in hst.items():
        for k, v in o.items():
            assert_bits(got[name][k], v, f"host {name}/{k}")
    assert st["fallback_snapshots"] == 0
    assert st["peak_leaf_frac"] == 1.0 and st["mesh_devices"] == 1
    assert st["bytes_tables_to_device"] > 0


@pytest.mark.parametrize("tile_n", [MESH_TILE, 512])
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_shards_meet_the_mesh_contract(arrays, n_shards, tile_n):
    got, st = port_run(arrays, [CPU] * n_shards, tile_n=tile_n)
    want = host(arrays)
    assert sorted(got) == sorted(want)
    for name, o in want.items():
        for k, v in o.items():
            if name == PNAME:
                assert_bits(got[name][k], md_fold(arrays, n_shards),
                            f"S={n_shards} projection vs md_fold")
                np.testing.assert_allclose(got[name][k], v, rtol=1e-12)
            else:
                assert_bits(got[name][k], v, f"S={n_shards} {name}/{k}")
    assert st["fallback_snapshots"] == 0
    assert st["mesh_devices"] == n_shards
    assert st["fallback_runs"] == {f"{SNAME}-of-lod3": 1}
    if n_shards == 4:        # residency: no device holds more than ~1/S
        assert st["peak_leaf_frac"] <= 0.6, st["peak_leaf_frac"]
        assert st["peak_device_table_bytes"] * n_shards <= \
            st["bytes_tables_to_device"] * 1.01
        assert st["peak_device_partial_bytes"] > 0


def test_owner_masked_partitions_compose_with_the_mesh(arrays):
    parts = partition_snapshot(arrays, "amr", 2)
    want = host(arrays)
    slice_img = proj_img = None
    for d, part in enumerate(parts):
        out, _ = port_run(part, [CPU] * 4, domain=d, n_domains=2)
        ref_part = host(part, domain=d, n_domains=2)
        assert_bits(out[SNAME]["image"], ref_part[SNAME]["image"],
                    f"part {d} slice")
        np.testing.assert_allclose(out[PNAME]["image"],
                                   ref_part[PNAME]["image"], rtol=1e-12)
        s, p = out[SNAME]["image"], out[PNAME]["image"]
        slice_img = s if slice_img is None else np.where(
            np.isnan(slice_img), s, slice_img)
        proj_img = p if proj_img is None else proj_img + p
    assert_bits(slice_img, want[SNAME]["image"], "overlaid slice")
    np.testing.assert_allclose(proj_img, want[PNAME]["image"], rtol=1e-12)


def test_mesh_impl_registry_fallback_configs():
    assert mesh_impl_for(red_pt.SliceReducer(resolution=64)) is not None
    assert mesh_impl_for(red_pt.SliceReducer(resolution=100)) is None
    assert mesh_impl_for(
        red_pt.SliceReducer(resolution=64, source="lod2")) is None
    assert mesh_impl_for(red_pt.ProjectionReducer(resolution=48)) is None
    assert mesh_impl_for(red_pt.LODCutReducer(max_level=2)) is not None
    assert mesh_impl_for(red_pt.LevelHistogramReducer()) is not None


def test_nonpow2_resolution_falls_back_without_device_bytes(arrays):
    d = red_pt.ReducerDAG([red_pt.SliceReducer(field="density",
                                               resolution=48)])
    runner = MeshDAGRunner(d, devices=[CPU] * 2)
    assert runner.impls[d.order[0].name] is None
    out = runner.run(Snapshot(step=0, kind="amr", arrays=arrays))
    want = red_ref.SliceReducer(field="density", resolution=48).reduce(
        SnapRef(step=0, kind="amr", arrays=arrays), {})
    assert_bits(out[d.order[0].name]["image"], want["image"], "host slice")
    assert runner.stats.bytes_fallback_to_host == 0
    assert runner.stats.fallback_snapshots == 1


@pytest.mark.parametrize("case", ["oversized", "none_without_gpu", "f32",
                                  "empty"])
def test_mesh_runner_config_errors(case):
    d = dag(red_pt)
    if case == "oversized":
        with pytest.raises(ValueError, match="as a sequence"):
            MeshDAGRunner(d, devices=torch.cuda.device_count() + 1)
    elif case == "none_without_gpu":
        if torch.cuda.is_available():
            assert len(mesh_devices(None)) == torch.cuda.device_count()
        else:
            with pytest.raises(ValueError, match="0 CUDA device"):
                MeshDAGRunner(d)
    elif case == "f32":
        # float32 tables run (tests/test_torch_mesh_f32.py); any dtype
        # but float32 and float64 is refused
        assert MeshDAGRunner(d, devices=[CPU], dtype="float32").dtype == \
            "float32"
        for dtype in ("float16", "int32", "f32"):
            with pytest.raises(ValueError, match="float64 or float32"):
                MeshDAGRunner(d, devices=[CPU], dtype=dtype)
    else:
        with pytest.raises(ValueError, match="at least one"):
            MeshDAGRunner(d, devices=[])


# ------------------------------------------------------------- engine

def test_engine_validates_mesh_config(tmp_path):
    mk = lambda: [red_pt.SliceReducer(resolution=32)]  # noqa: E731
    with pytest.raises(ValueError, match="device_reduce mode"):
        InTransitEngine(str(tmp_path / "a"), mk(), device_reduce="tpu")
    with pytest.raises(ValueError, match="mesh_devices"):
        InTransitEngine(str(tmp_path / "b"), mk(), mesh_devices=2)
    with pytest.raises(ValueError, match="thread"):
        InTransitEngine(str(tmp_path / "c"), mk(), device_reduce="mesh",
                        mesh_devices=[CPU], backend="process")
    with pytest.raises(ValueError, match="sequence of devices"):
        InTransitEngine(str(tmp_path / "d"), mk(), device_reduce="mesh",
                        device="cpu")


@pytest.mark.parametrize("n_shards", [1, 4])
def test_engine_mesh_catalog_matches_reference_host(tmp_path, arrays,
                                                    n_shards):
    """device_reduce='mesh' writes the reference host engine's catalog:
    bitwise, the projection within 1e-12 (bitwise at one shard)."""
    with jax.enable_x64(True):
        eng = EngineRef(str(tmp_path / "ref"), list(dag(red_ref)),
                        policy="block").start()
        assert eng.submit(0, arrays)
        eng.close()
    eng = InTransitEngine(str(tmp_path / "pt"), list(dag(red_pt)),
                          policy="block", device_reduce="mesh",
                          mesh_devices=[CPU] * n_shards).start()
    assert eng.submit(0, arrays)
    eng.close()
    ds = eng.device_stats
    assert ds["mesh_devices"] == n_shards and ds["fallback_snapshots"] == 0
    assert all(a.stats.bytes_staged > 0 for a in eng.stages)
    cr, cp = CatalogRef(str(tmp_path / "ref")), Catalog(str(tmp_path / "pt"))
    try:
        assert cr.reducers(0) == cp.reducers(0)
        for r in cr.reducers(0):
            with jax.enable_x64(True):
                a = cr.query(0, r)
            b = cp.query(0, r)
            for k in a:
                if r == PNAME and n_shards > 1:
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-12)
                else:
                    assert_bits(b[k], a[k], f"{r}/{k}")
    finally:
        cr.close()
        cp.close()


def test_cli_device_mesh_on_cpu(tmp_path, capsys):
    rc = cli.main(["--out", str(tmp_path / "cli"), "--steps", "2",
                   "--max-level", "4", "--resolution", "32", "--queries",
                   "2", "--policy", "block", "--device-mesh", "4",
                   "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "device_reduce=mesh" in out and "mesh reduce[4d]:" in out
    assert "contexts: [2]" in out


def test_cli_device_mesh_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="CUDA device"):
        cli.main(["--out", str(tmp_path / "x"), "--steps", "1",
                  "--device-mesh", "2"])


# --------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("bad_levels", [False, True])
@pytest.mark.parametrize("position", BOUNDARIES)
@pytest.mark.parametrize("tile_n", [512, 1024])
def test_cuda_carry_kernels_bit_equal_to_twins(cuda_device, arrays, tile_n,
                                               position, bad_levels):
    x = node_tables(arrays)
    if bad_levels:
        x = with_bad_levels(x)
    t = {k: torch.from_numpy(np.asarray(v)).to(cuda_device)
         for k, v in x.items() if k != "n_levels"}
    kw = dict(axis=2, resolution=R, n_levels=x["n_levels"], tile_n=tile_n)
    before = dict(raster.LAUNCHES)
    for backend in ("cuda", "ref"):
        img, depth = ops.raster_slice_partial(
            t["coords"], t["levels"], t["values"], t["ok"],
            position=position, backend=backend, **kw)
        proj = ops.raster_projection_partial(
            t["coords"], t["levels"], t["values"], t["ok"], backend=backend,
            **kw)
        torch.cuda.synchronize()
        if backend == "cuda":
            got = (img.view(torch.int64), depth, proj.view(torch.int64))
        else:
            want = (img.view(torch.int64), depth, proj.view(torch.int64))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # one call over the table on the card, whatever tile_n (the twins'
    # chain is what it is held to)
    assert raster.LAUNCHES["slice_raster_carry"] - \
        before["slice_raster_carry"] == 1
    assert raster.LAUNCHES["projection_raster_carry"] - \
        before["projection_raster_carry"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("tile_n", [512, 1024])
@pytest.mark.parametrize("resolution,n_levels", TABLE_GEOMETRY)
def test_cuda_projection_carry_bit_equal_to_twin_on_adversarial_tables(
        cuda_device, resolution, n_levels, tile_n):
    x = projection_table(5, resolution=resolution, n_levels=n_levels,
                         invalid_run=2100)
    before = raster.LAUNCHES["projection_raster_carry"]
    got = chained_projection(x, resolution=resolution, tile_n=tile_n,
                             backend="cuda", device=cuda_device)
    want = chained_projection(x, resolution=resolution, tile_n=tile_n,
                              backend="ref", device=cuda_device)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert raster.LAUNCHES["projection_raster_carry"] - before == 1


@pytest.mark.gpu
@pytest.mark.parametrize("bad_levels", [False, True])
@pytest.mark.parametrize("position", BOUNDARIES)
def test_cuda_slice_bit_equal_to_twin_at_cell_boundaries(
        cuda_device, arrays, position, bad_levels):
    """B1 through ``ops.raster_slice`` (the device path's call: the
    strided slice-axis column of int32 coords) against its twin at the
    boundary positions, with and without rows of out-of-range level,
    twice on one stream: one launch a call."""
    x = node_tables(arrays)
    if bad_levels:
        x = with_bad_levels(x)
    t = {k: torch.from_numpy(np.asarray(v)).to(cuda_device)
         for k, v in x.items() if k != "n_levels"}
    coords = t["coords"].to(torch.int32)
    kw = dict(axis=2, position=position, resolution=R,
              n_levels=x["n_levels"])
    before = raster.LAUNCHES["slice_raster"]
    got = [ops.raster_slice(coords, t["levels"], t["values"], t["ok"], **kw)
           for _ in range(2)]
    want = ops.raster_slice(coords, t["levels"], t["values"], t["ok"],
                            backend="ref", **kw)
    torch.cuda.synchronize()
    assert raster.LAUNCHES["slice_raster"] - before == 2
    for g in got:
        assert torch.equal(g.view(torch.int64), want.view(torch.int64))
