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
from repro_torch.kernels import ops, raster, ref

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
        raster._on_cuda(t["values"], torch.empty(0, device="meta"))


@pytest.mark.parametrize("where", ["env", "checkout", "installed"])
def test_build_dir(where, tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if where == "env":
        monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "b"))
        assert raster.build_dir() == tmp_path / "b"
    elif where == "checkout":
        assert raster.build_dir() == raster.CHECKOUT / "build" / "repro_torch"
        assert (raster.CHECKOUT / "src" / "repro_torch").is_dir()
    else:
        monkeypatch.setattr(raster, "CHECKOUT", tmp_path / "lib")
        assert raster.build_dir() == tmp_path / "cache" / "repro_torch"


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
