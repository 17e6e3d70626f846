"""Raster kernels B1-B3: plain torch twins against repro.kernels.ops.

For seeds 0 and 7, R 16 (sub-pixel collisions) and 64, and owner-masked
3-part partitions, ``repro_torch.kernels.ops`` (the plain twins on CPU
tensors) must be bit-equal to ``repro.kernels.ops`` with ``ref`` and
``pallas_interpret`` (under x64) and to the host numpy reducers of both
packages. The ``gpu`` cases hold each CUDA kernel against its twin on
the card and skip where there is none.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.insitu import partition_snapshot
from repro.insitu.reducers import LevelHistogramReducer as HistRef
from repro.insitu.reducers import ProjectionReducer as ProjRef
from repro.insitu.reducers import ReducerDAG as DagRef
from repro.insitu.reducers import SliceReducer as SliceRef
from repro.insitu.staging import Snapshot as SnapRef
from repro.kernels import ops as ops_ref
from repro.kernels import raster_kernel
from repro.sim import amrgen, fields
from repro_torch.insitu.device import DeviceTree, device_impl_for, to_device
from repro_torch.insitu.reducers import (LevelHistogramReducer,
                                         LODCutReducer, ProjectionReducer,
                                         ReducerDAG, SliceReducer)
from repro_torch.insitu.staging import Snapshot
from repro_torch.kernels import cudalib, ops, raster, ref

SEEDS = (0, 7)
RESOLUTIONS = (16, 64)
KINDS = ("slice", "projection", "hist")


def random_tree(seed: int):
    """A Sedov AMR structure carrying random (sign-mixed) field values."""
    rng = np.random.default_rng(seed)
    tree = amrgen.generate_tree(fields.sedov(r_shock=0.2 + 0.1 * rng.random()),
                                min_level=2, max_level=5, threshold=1.2)
    tree.fields["density"] = rng.standard_normal(tree.n_nodes) * 4.0 + 1.0
    return tree


def node_inputs(arrays: dict, n_domains: int = 1):
    """Unpadded flat node arrays (numpy) as the device path sees them."""
    levels = (np.searchsorted(arrays["level_offsets"],
                              np.arange(arrays["refine"].shape[0]),
                              side="right") - 1).astype(np.int32)
    ok = ~arrays["refine"]
    if n_domains > 1:
        ok = ok & arrays["owner"]
    return {"coords": arrays["coords"], "levels": levels,
            "values": arrays["field:density"], "ok": ok,
            "n_levels": arrays["level_offsets"].shape[0] - 1}


def host_reference(arrays, kind, resolution, edges_lo_hi, domain=0,
                   n_domains=1):
    """The reference host reducer's output for one reducer kind."""
    lo, hi = edges_lo_hi
    r = {"slice": SliceRef(resolution=resolution),
         "projection": ProjRef(resolution=resolution),
         "hist": HistRef(bins=32, lo=lo, hi=hi)}[kind]
    out = DagRef([r]).run(SnapRef(step=0, kind="amr", arrays=arrays,
                                  domain=domain, n_domains=n_domains))
    return out[r.name]


def port_host(arrays, kind, resolution, edges_lo_hi, domain=0, n_domains=1):
    lo, hi = edges_lo_hi
    r = {"slice": SliceReducer(resolution=resolution),
         "projection": ProjectionReducer(resolution=resolution),
         "hist": LevelHistogramReducer(bins=32, lo=lo, hi=hi)}[kind]
    out = ReducerDAG([r]).run(Snapshot(step=0, kind="amr", arrays=arrays,
                                       domain=domain, n_domains=n_domains))
    return out[r.name]


def run_port(x, kind, resolution, edges):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    if kind == "slice":
        return ops.raster_slice(t["coords"], t["levels"], t["values"],
                                t["ok"], axis=2, position=0.5,
                                resolution=resolution,
                                n_levels=x["n_levels"]).numpy()
    if kind == "projection":
        return ops.raster_projection(t["coords"], t["levels"], t["values"],
                                     t["ok"], axis=2, resolution=resolution,
                                     n_levels=x["n_levels"]).numpy()
    return ops.raster_level_hist(t["values"], t["levels"], t["ok"],
                                 torch.from_numpy(edges),
                                 n_levels=min(x["n_levels"], 16)).numpy()


def run_jax(x, kind, resolution, edges, backend):
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in x.items() if k != "n_levels"}
        if kind == "slice":
            out = ops_ref.raster_slice(
                j["coords"], j["levels"], j["values"], j["ok"], axis=2,
                position=0.5, resolution=resolution, n_levels=x["n_levels"],
                backend=backend)
        elif kind == "projection":
            out = ops_ref.raster_projection(
                j["coords"], j["levels"], j["values"], j["ok"], axis=2,
                resolution=resolution, n_levels=x["n_levels"],
                backend=backend)
        else:
            out = ops_ref.raster_level_hist(
                j["values"], j["levels"], j["ok"], jnp.asarray(edges),
                n_levels=min(x["n_levels"], 16), backend=backend)
        return np.asarray(out)


def assert_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def check_all(arrays, kind, resolution, lo_hi, domain=0, n_domains=1):
    x = node_inputs(arrays, n_domains)
    want = host_reference(arrays, kind, resolution, lo_hi, domain, n_domains)
    key = "hist" if kind == "hist" else "image"
    edges = want["edges"] if kind == "hist" else None
    got = run_port(x, kind, resolution, edges)
    assert_bits(want[key], got, f"{kind} vs reference host reducer")
    mine = port_host(arrays, kind, resolution, lo_hi, domain, n_domains)
    assert_bits(want[key], mine[key], f"{kind}: port host reducer")
    for backend in ("ref", "pallas_interpret"):
        assert_bits(run_jax(x, kind, resolution, edges, backend), got,
                    f"{kind} vs repro.kernels.ops[{backend}]")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("resolution", RESOLUTIONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_twins_bit_equal_single_domain(seed, resolution, kind):
    check_all(random_tree(seed).to_arrays(), kind, resolution, (None, None))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("part", [0, 1, 2])
def test_twins_bit_equal_owner_masked(part, kind):
    parts = partition_snapshot(random_tree(3).to_arrays(), "amr", 3)
    check_all(parts[part], kind, 32, (-8.0, 8.0), domain=part, n_domains=3)


#: (resolution, n_levels) of the projection tables: sub-pixel levels
#: above k = log2 R, and n_levels > k + 1
TABLE_GEOMETRY = [(16, 8), (64, 8)]


def projection_table(seed: int, *, resolution: int, n_levels: int,
                     invalid_run: int = 0) -> dict:
    """A level-major leaf table (numpy) the projection's (level, cell) CSR
    must get right: random leaves on every level, each level's rows
    shuffled; a deep column (every leaf of one (x, y) along the axis) at
    level 3 and at the finest level, where it and its sub-pixel
    neighbours share one pixel; ~15 % rows not ok; every 11th ok row
    given a level outside [0, n_levels); and ``invalid_run`` rows with
    ok False after level 3 (an all-invalid tile when chained)."""
    rng = np.random.default_rng(seed)
    coords, levels = [], []
    for lvl in range(n_levels):
        side = 1 << lvl
        c = rng.integers(0, side, size=(int(rng.integers(8, 48)), 3))
        if lvl in (3, n_levels - 1):
            x, y = rng.integers(0, side, size=2)
            z = np.arange(side)
            cols = [np.stack([np.full(side, min(x + dx, side - 1)),
                              np.full(side, y), z], 1) for dx in (0, 1)]
            c = np.concatenate([c, *cols])
        c = c[rng.permutation(c.shape[0])]
        coords.append(c)
        levels.append(np.full(c.shape[0], lvl))
        if lvl == 3 and invalid_run:
            coords.append(rng.integers(0, side, size=(invalid_run, 3)))
            levels.append(np.full(invalid_run, -7))
    coords = np.concatenate(coords).astype(np.int32)
    levels = np.concatenate(levels).astype(np.int32)
    ok = (rng.random(levels.shape[0]) < 0.85) & (levels != -7)
    levels[levels == -7] = 3
    bad = np.flatnonzero(ok)[::11]
    levels[bad] = np.resize([n_levels, n_levels + 3, -1], bad.size)
    values = rng.standard_normal(levels.shape[0]) * 4.0 + 1.0
    return {"coords": coords, "levels": levels, "values": values, "ok": ok,
            "n_levels": n_levels}


def reference_ok(x: dict) -> np.ndarray:
    """The rows the projection keeps: ok and of a level in [0, n_levels).
    The reference's Pallas kernel has no level range, so it is fed this
    mask (its geometry is meaningless for the dropped rows)."""
    return x["ok"] & (x["levels"] >= 0) & (x["levels"] < x["n_levels"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("resolution,n_levels", TABLE_GEOMETRY)
def test_projection_twin_on_adversarial_tables(seed, resolution, n_levels):
    """B2's semantics on tables the CSR must get right (see
    :func:`projection_table`): the port's twin bit-equal to the
    reference's Pallas projection kernel in interpret mode."""
    x = projection_table(seed, resolution=resolution, n_levels=n_levels)
    got = run_port(x, "projection", resolution, None)
    want = run_jax({**x, "ok": reference_ok(x)}, "projection", resolution,
                   None, "pallas_interpret")
    assert_bits(want, got, f"projection R={resolution} L={n_levels}")
    assert np.count_nonzero(got) > 0


@pytest.mark.parametrize("seed", SEEDS)
def test_leaf_table_and_plane_hit_match_reference(seed):
    x = node_inputs(random_tree(seed).to_arrays())
    c2 = x["coords"][:, :2].astype(np.int32)
    for res in RESOLUTIONS:
        with jax.enable_x64(True):
            want = raster_kernel.leaf_table(jnp.asarray(c2),
                                            jnp.asarray(x["levels"]),
                                            resolution=res)
            hit = raster_kernel.plane_hit(jnp.asarray(x["coords"][:, 2]),
                                          jnp.asarray(x["levels"]), 0.5,
                                          jnp.float64)
        got = raster.leaf_table(torch.from_numpy(c2),
                                torch.from_numpy(x["levels"]),
                                resolution=res)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        mine = raster.plane_hit(torch.from_numpy(x["coords"][:, 2]),
                                torch.from_numpy(x["levels"]), 0.5,
                                x["n_levels"])
        np.testing.assert_array_equal(np.asarray(hit), mine.numpy())


def test_wrappers_on_cpu_run_the_twin_and_count_nothing():
    x = node_inputs(random_tree(7).to_arrays())
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    c2 = t["coords"][:, :2].to(torch.int32)
    before = dict(raster.LAUNCHES)
    a = raster.projection_raster(c2, t["levels"], t["values"], t["ok"],
                                 resolution=16, n_levels=x["n_levels"])
    b = ref.projection_raster_ref(c2, t["levels"], t["values"], t["ok"],
                                  resolution=16, n_levels=x["n_levels"])
    assert torch.equal(a, b)
    assert raster.LAUNCHES == before


def test_backend_selection_errors():
    x = node_inputs(random_tree(0).to_arrays())
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    kw = dict(axis=2, resolution=16, n_levels=x["n_levels"])
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.raster_projection(t["coords"], t["levels"], t["values"],
                              t["ok"], backend="cuda", **kw)
    with pytest.raises(ValueError, match="backend"):
        ops.raster_projection(t["coords"], t["levels"], t["values"],
                              t["ok"], backend="pallas", **kw)
    with pytest.raises(ValueError, match="power-of-two"):
        ops.raster_projection(t["coords"], t["levels"], t["values"],
                              t["ok"], axis=2, resolution=48,
                              n_levels=x["n_levels"])
    with pytest.raises(ValueError, match="one CUDA device or all on the"):
        cudalib.on_cuda(t["values"], torch.empty(0, device="meta"))


def test_scan_chunk_matches_the_kernel_source():
    """The wrapper pads B2/B5's count scratch to the kernel's scan chunk."""
    src = (cudalib.CSRC / "raster.cu").read_text()
    assert f"constexpr int kScanChunk = {raster.SCAN_CHUNK};" in src
    assert raster.SCAN_CHUNK % 1024 == 0    # whole int4 loads per thread


def test_projection_scratch_sizes_and_reuse(monkeypatch):
    """B2/B5's scratch: counts and offsets cover every pyramid cell plus
    the end cell in whole scan chunks, counts start zero, rows grow with
    N and are kept otherwise; a pyramid past int32 cell indices raises."""
    monkeypatch.setattr(raster, "current_stream", lambda dev: 0)
    monkeypatch.setattr(raster, "_PROJ_SCRATCH", {})
    cpu = torch.device("cpu")
    total = ref.level_bases(10, 9)[-1]
    _, (zeros, offsets, rows) = raster._projection_scratch(cpu, 512, 10, 100)
    cells = offsets.numel()
    assert cells % raster.SCAN_CHUNK == 0
    assert total + 1 <= cells < total + 1 + raster.SCAN_CHUNK
    assert zeros.numel() == cells + cells // raster.SCAN_CHUNK
    assert not zeros.any() and zeros.dtype == torch.int32
    # five int32 words a row: the ordered contribution (float64 at most),
    # the key, the placed row and the ordered row
    assert raster.ROW_WORDS == 5
    assert offsets.dtype == torch.int64 and rows.numel() == 500
    assert raster._projection_scratch(cpu, 512, 10, 50)[1][2] is rows
    assert raster._projection_scratch(cpu, 512, 10, 1000)[1][2].numel() \
        == 5000
    assert len(raster._PROJ_SCRATCH) == 1
    with pytest.raises(ValueError, match="int32 cell index"):
        raster._projection_scratch(cpu, 2 ** 15, 20, 1)


@pytest.mark.parametrize("where", ["env", "checkout", "installed"])
def test_build_dir(where, tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if where == "env":
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
        assert cudalib.build_dir() == tmp_path / "b"
    elif where == "checkout":
        assert cudalib.build_dir() == \
            cudalib.CHECKOUT / "build" / "repro_torch"
        assert (cudalib.CHECKOUT / "src" / "repro_torch").is_dir()
    else:
        monkeypatch.setattr(cudalib, "CHECKOUT", tmp_path / "lib")
        assert cudalib.build_dir() == tmp_path / "cache" / "repro_torch"


@pytest.mark.parametrize("backend", [None, "auto", "ref"])
def test_ops_backends_on_cpu_agree_and_launch_nothing(backend):
    x = node_inputs(random_tree(0).to_arrays())
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()
         if k != "n_levels"}
    kw = dict(axis=2, resolution=16, n_levels=x["n_levels"])
    before = dict(raster.LAUNCHES)
    got = ops.raster_slice(t["coords"], t["levels"], t["values"], t["ok"],
                           position=0.5, backend=backend, **kw)
    want = ref.slice_raster_ref(ops.plane_coords(t["coords"], 2),
                                t["coords"][:, 2], t["levels"].to(torch.int32),
                                t["values"], t["ok"], position=0.5,
                                resolution=16, n_levels=x["n_levels"])
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert raster.LAUNCHES == before


def test_device_impl_registry_fallback_configs():
    """Unsupported configs resolve to None -> host fallback."""
    assert device_impl_for(SliceReducer(resolution=64)) is not None
    assert device_impl_for(SliceReducer(resolution=100)) is None
    assert device_impl_for(
        SliceReducer(resolution=64, source="lod2")) is None
    assert device_impl_for(LODCutReducer(max_level=2)) is not None
    assert device_impl_for(ProjectionReducer(resolution=48)) is None
    assert device_impl_for(LevelHistogramReducer()) is not None


# ------------------------------------------- B1/B4's one-thread-per-row paint

def coarse_table(seed: int, *, resolution: int = 512,
                 n_levels: int = 11) -> dict:
    """A level-major leaf table (numpy) whose slice at 0.5 paints coarse
    leaves: levels 0-3 (rectangles of 512² down to 64² pixels at R =
    512) among finer and sub-pixel ones, overlapping on every level;
    half the rows of a level lie on the plane's cell (c = 2^(l-1)), ~10 %
    are not ok and every 13th ok row has a level outside [0,
    n_levels)."""
    rng = np.random.default_rng(seed)
    coords, levels = [], []
    for lvl in range(n_levels):
        side = 1 << lvl
        n = int(rng.integers(4, 12 if lvl < 4 else 40))
        c = rng.integers(0, side, size=(n, 3))
        on_plane = rng.random(n) < 0.5
        c[on_plane, 2] = side >> 1
        coords.append(c)
        levels.append(np.full(n, lvl))
    coords = np.concatenate(coords).astype(np.int32)
    levels = np.concatenate(levels).astype(np.int32)
    ok = rng.random(levels.shape[0]) < 0.9
    bad = np.flatnonzero(ok)[::13]
    levels[bad] = np.resize([n_levels, n_levels + 3, -1], bad.size)
    values = rng.standard_normal(levels.shape[0]) * 4.0 + 1.0
    return {"coords": coords, "levels": levels, "values": values, "ok": ok,
            "n_levels": n_levels}


def paint_mirror(x: dict, *, resolution: int, position: float = 0.5):
    """``slice_paint_kernel`` + ``slice_resolve_kernel`` in numpy, one
    step per row: a hit row whose rectangle has at most
    ``raster.SLICE_OWN_AREA`` pixels ``atomicMax``-es its key ``(level +
    1) << 32 | row`` over its pixels; a coarse row (level below
    ``raster.slice_coarse_levels``) into its cell (c0, c1) of its
    level's grid, at ``(4^l - 1) / 3 + c0 · 2^l + c1``, and marks the
    level keyed. The resolve takes each pixel's max over its own key and
    its ancestors' cells on the keyed levels, then clears both. Returns
    the image, the scratch left after the resolve (pixels, cells) and
    how many rows each branch keyed."""
    r = resolution
    k = r.bit_length() - 1
    t = {key: torch.from_numpy(np.asarray(v)) for key, v in x.items()
         if key != "n_levels"}
    c2 = ops.plane_coords(t["coords"], 2)
    u0, v0, px, lvl, good = (a.numpy().astype(np.int64) for a in
                             raster._slice_table(
        c2, t["coords"][:, 2].to(torch.int32), t["levels"], t["ok"],
        position=position, resolution=r, n_levels=x["n_levels"]))
    c2 = c2.numpy().astype(np.int64)
    coarse_levels = raster.slice_coarse_levels(r)
    pixel = np.zeros((r, r), np.uint64)
    cells = np.zeros(raster.slice_coarse_cells(r), np.uint64)
    counts = {"own": 0, "coarse": 0}
    keyed = set()
    for row in np.flatnonzero(good):
        key = np.uint64(((lvl[row] + 1) << 32) | row)
        l = lvl[row]
        if l < coarse_levels:
            side = 1 << l
            if ((c2[row] >= 0) & (c2[row] < side)).all():
                at = (4 ** l - 1) // 3 + c2[row, 0] * side + c2[row, 1]
                cells[at] = max(cells[at], key)
                keyed.add(l)
            counts["coarse"] += 1
            continue
        assert px[row] ** 2 <= raster.SLICE_OWN_AREA
        blk = pixel[u0[row]:u0[row] + px[row], v0[row]:v0[row] + px[row]]
        np.maximum(blk, key, out=blk)
        counts["own"] += 1
    keys = pixel.copy()
    i, j = np.indices((r, r))
    for l in sorted(keyed):
        grid = cells[(4 ** l - 1) // 3:(4 ** (l + 1) - 1) // 3]
        keys = np.maximum(keys, grid[((i >> (k - l)) << l) + (j >> (k - l))])
    win = keys != 0
    img = np.full((r, r), np.nan)
    img[win] = np.asarray(x["values"])[(keys[win] & np.uint64(0xFFFFFFFF))
                                       .astype(np.int64)]
    pixel[:] = 0                       # the resolve clears what it read,
    cells[:] = 0                       # its last block the cells
    return img, (pixel, cells), counts


@pytest.mark.parametrize("table", ["sedov0", "sedov7", "coarse0", "coarse1"])
def test_paint_mirror_gives_the_slice_twin(table):
    """The paint kernel's split — rectangles of at most
    ``SLICE_OWN_AREA`` pixels painted per pixel by their row's thread,
    coarse ones keyed into their level's cell and taken up per pixel by
    the resolve — gives ``slice_raster_ref``'s image bit for bit on
    Sedov trees (R = 16, 64) and on coarse-leaf tables (R = 512,
    rectangles up to the whole image), and leaves the scratch all
    zero."""
    if table.startswith("sedov"):
        x = node_inputs(random_tree(int(table[-1])).to_arrays())
        geometries = RESOLUTIONS
    else:
        x = coarse_table(int(table[-1]))
        geometries = (512,)
    keyed = {"own": 0, "coarse": 0}
    for r in geometries:
        img, scratch, counts = paint_mirror(x, resolution=r)
        want = run_port(x, "slice", r, None)
        assert_bits(want, img, f"{table} R={r}")
        assert not any(a.any() for a in scratch)
        keyed = {k: keyed[k] + counts[k] for k in keyed}
    assert keyed["own"] > 0 and keyed["coarse"] > 0, keyed


@pytest.mark.parametrize("seed", SEEDS)
def test_slice_twin_on_coarse_tables_matches_reference(seed):
    """The slice twin on a coarse-leaf table (at R = 64, where every
    level up to 6 is a rectangle) equals the reference's ``ref`` and
    interpret-mode Pallas slice."""
    x = coarse_table(seed, resolution=64, n_levels=8)
    got = run_port(x, "slice", 64, None)
    ok = reference_ok(x)       # the reference's geometry needs the range
    for backend in ("ref", "pallas_interpret"):
        assert_bits(run_jax({**x, "ok": ok}, "slice", 64, None, backend),
                    got, f"coarse slice vs repro.kernels.ops[{backend}]")
    assert np.isfinite(got).any()


def test_slice_own_area_matches_the_kernel_source():
    src = (cudalib.CSRC / "raster.cu").read_text()
    assert f"constexpr int kSliceOwnArea = {raster.SLICE_OWN_AREA};" in src


@pytest.mark.parametrize("resolution,levels,cells", [
    (1, 0, 0), (4, 0, 0), (8, 1, 1), (16, 2, 5), (64, 4, 85),
    (512, 7, 5461)])
def test_slice_coarse_levels_and_scratch(resolution, levels, cells,
                                         monkeypatch):
    """The coarse levels are those with px > 4 (px² above SLICE_OWN_AREA),
    and the key scratch holds R² pixel keys, their cells and one
    counter, made zero once per (device, stream, R) and then kept."""
    assert raster.slice_coarse_levels(resolution) == levels
    assert raster.slice_coarse_cells(resolution) == cells
    monkeypatch.setattr(raster, "_SLICE_KEYS", {})
    monkeypatch.setattr(raster, "current_stream", lambda dev: 77)
    key, keys = raster._slice_keys(0, torch.device("cpu"), resolution)
    assert key == (0, 77, resolution)
    assert keys.shape == (resolution ** 2 + cells + 1,)
    assert keys.dtype == torch.int64 and not keys.any()
    assert raster._slice_keys(0, torch.device("cpu"), resolution)[1] is keys


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("resolution", RESOLUTIONS)
@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_kernels_bit_equal_to_twins(cuda_device, seed, resolution):
    dt = DeviceTree(to_device(random_tree(seed).to_arrays(), cuda_device), 1)
    c2 = dt.coords[:, :2].contiguous()
    geo = dict(resolution=resolution, n_levels=dt.n_levels)
    v = dt.field("density")
    edges = torch.linspace(-8.0, 8.0, 33, dtype=torch.float64,
                           device=cuda_device)
    pairs = [
        (lambda f: f(c2, dt.coords[:, 2], dt.levels, v, dt.ok,
                     position=0.5, **geo),
         raster.slice_raster, ref.slice_raster_ref),
        (lambda f: f(c2, dt.levels, v, dt.ok, **geo),
         raster.projection_raster, ref.projection_raster_ref),
        (lambda f: f(v, dt.levels, dt.ok, edges, n_levels=dt.n_levels),
         raster.level_hist, ref.level_hist_ref),
    ]
    for call, kern, twin in pairs:
        a, b = call(kern), call(twin)
        torch.cuda.synchronize()
        if a.dtype == torch.float64:
            a, b = a.view(torch.int64), b.view(torch.int64)
        assert torch.equal(a, b), kern.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("resolution,n_levels", TABLE_GEOMETRY)
def test_cuda_projection_bit_equal_to_twin_on_adversarial_tables(
        cuda_device, seed, resolution, n_levels):
    x = projection_table(seed, resolution=resolution, n_levels=n_levels)
    t = {k: torch.from_numpy(np.asarray(v)).to(cuda_device)
         for k, v in x.items() if k != "n_levels"}
    c2 = ops.plane_coords(t["coords"], 2)
    before = raster.LAUNCHES["projection_raster"]
    args = (c2, t["levels"], t["values"], t["ok"])
    geo = dict(resolution=resolution, n_levels=n_levels)
    got = raster.projection_raster(*args, **geo)
    again = raster.projection_raster(*args, **geo)   # scratch reused
    want = ref.projection_raster_ref(*args, **geo)
    torch.cuda.synchronize()
    assert raster.LAUNCHES["projection_raster"] - before == 2
    for g in (got, again):
        assert torch.equal(g.view(torch.int64), want.view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_slice_bit_equal_to_twin_on_coarse_tables(cuda_device, seed):
    """B1 and B4 (whose paint B1 shares) on coarse-leaf tables at R =
    512 and 64 against their twins, bitwise; B1 twice on one stream's
    kept scratch, which its resolve leaves all zero."""
    for r, n_levels in ((512, 11), (64, 8)):
        x = coarse_table(seed, resolution=r, n_levels=n_levels)
        t = {k: torch.from_numpy(np.asarray(v)).to(cuda_device)
             for k, v in x.items() if k != "n_levels"}
        args = (ops.plane_coords(t["coords"], 2),
                t["coords"][:, 2].to(torch.int32), t["levels"], t["values"],
                t["ok"])
        geo = dict(position=0.5, resolution=r, n_levels=n_levels)
        before = dict(raster.LAUNCHES)
        got = [raster.slice_raster(*args, **geo) for _ in range(2)]
        carry = raster.slice_raster_carry(*args, **geo)
        want = ref.slice_raster_ref(*args, **geo)
        want_carry = ref.slice_raster_depth_ref(*args, **geo)
        torch.cuda.synchronize()
        assert raster.LAUNCHES["slice_raster"] - \
            before["slice_raster"] == 2
        for g in got:
            assert torch.equal(g.view(torch.int64), want.view(torch.int64))
        assert torch.equal(carry[0].view(torch.int64),
                           want_carry[0].view(torch.int64))
        assert torch.equal(carry[1], want_carry[1])
        keys = raster._SLICE_KEYS[(0, cudalib.current_stream(0), r)]
        assert not bool(keys.any())
