"""B3 (the per-level histogram) with its edges on the host.

The port's device and mesh histogram reducers hand B3 their edges as a
CPU tensor: on the card up to 257 edges cross by value as a kernel
parameter, so no reducer uploads them (an upload synchronizes the
stream). Contract, on the CPU (the plain twins):

  * the device reducer (fixed and auto bounds) and the mesh reducer
    (float64 and float32 tables, S = 1 and 4 shards) pass CPU edges and
    stay bit-equal to ``repro.kernels.ops`` (``ref`` and
    ``pallas_interpret``, under x64) over the same edges and to the host
    reducers of both packages (the float32 tables: over the cast field);
  * ``raster.level_hist`` takes CPU edges beside CPU values and refuses
    edges on any other device; the edge routing (by value up to
    ``HIST_PARAM_EDGES``, which is the kernel source's ``kParamEdges``);
  * a numpy mirror of the kernel's bin (a guess from the uniform spacing,
    walked to the largest edge <= v) is ``searchsorted(side="right") - 1``
    on uniform, duplicate, geometric and float32-rounded cases, and takes
    at most one step on ``np.linspace`` edges.

Tolerance: bitwise throughout (integer counts). The ``gpu`` cases hold
B3 and B3-f32 against their twins on the card with both edge routes, two
calls on one stream each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.insitu.reducers import LevelHistogramReducer as HistRef
from repro.insitu.reducers import ReducerDAG as DagRef
from repro.insitu.staging import Snapshot as SnapRef
from repro.kernels import ops as ops_ref
from repro_torch.insitu.device import DeviceTree, device_impl_for, to_device
from repro_torch.insitu.mesh_reduce import MeshTable, mesh_impl_for
from repro_torch.insitu.reducers import LevelHistogramReducer, ReducerDAG
from repro_torch.insitu.staging import Snapshot
from repro_torch.kernels import cudalib, ops, raster, ref
from test_torch_mesh import sedov_arrays
from test_torch_raster import node_inputs, random_tree

CPU = torch.device("cpu")


@pytest.fixture
def edge_devices(monkeypatch):
    """The device of the edges each B3 wrapper call is given."""
    seen = []
    wrapper = raster.level_hist

    def spy(values, levels, ok, edges, *, n_levels):
        seen.append(edges.device)
        return wrapper(values, levels, ok, edges, n_levels=n_levels)

    monkeypatch.setattr(raster, "level_hist", spy)
    return seen


def reference_hist(values, levels, ok, edges, n_levels, backend):
    """``repro.kernels.ops``' per-level histogram, int64 numpy."""
    with jax.enable_x64(True):
        out = ops_ref.raster_level_hist_partial(
            jnp.asarray(values), jnp.asarray(levels), jnp.asarray(ok),
            jnp.asarray(edges), n_levels=n_levels, backend=backend)
    return np.asarray(out).astype(np.int64)


def host_hist(arrays, reducer_kw):
    """Both packages' host reducers: (hist, edges) of each, numpy."""
    outs = []
    for dag, hist, snap in ((DagRef, HistRef, SnapRef),
                            (ReducerDAG, LevelHistogramReducer, Snapshot)):
        r = hist(**reducer_kw)
        o = dag([r]).run(snap(step=0, kind="amr", arrays=arrays))[r.name]
        outs.append((np.asarray(o["hist"]), np.asarray(o["edges"])))
    return outs


def assert_same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert got.tobytes() == want.astype(got.dtype).tobytes(), what


# ---------------------------------------------------------- reducers

@pytest.mark.parametrize("backend", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("bounds", ["fixed", "auto"])
@pytest.mark.parametrize("seed", [0, 7])
def test_device_reducer_passes_host_edges(edge_devices, seed, bounds,
                                          backend):
    arrays = random_tree(seed).to_arrays()
    kw = dict(field="density", bins=16)
    if bounds == "fixed":
        kw.update(lo=-3.0, hi=5.0)
    r = LevelHistogramReducer(**kw)
    dt = DeviceTree(to_device(arrays, CPU), 1)
    got = device_impl_for(r)(dt)
    assert edge_devices == [CPU]
    for hist, edges in host_hist(arrays, kw):
        assert_same(got["edges"], edges, "edges vs host reducer")
        assert_same(got["hist"], hist, "hist vs host reducer")
    x = node_inputs(arrays)
    n_hist = min(x["n_levels"], r.max_levels)
    want = reference_hist(x["values"], x["levels"], x["ok"], got["edges"],
                          n_hist, backend)
    assert_same(got["hist"], want, f"hist vs repro.kernels.ops[{backend}]")
    assert int(got["hist"].sum()) > 0


@pytest.mark.parametrize("backend", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_mesh_reducer_passes_host_edges(edge_devices, dtype, n_shards,
                                        backend):
    arrays = sedov_arrays()
    r = LevelHistogramReducer(field="density", bins=16)
    mt = MeshTable(arrays, 1, [CPU] * n_shards, dtype=dtype)
    got = mesh_impl_for(r)(mt)
    assert edge_devices == [CPU] * n_shards
    cast = arrays
    if dtype:      # the host over the cast field (DESIGN.md's f32 policy)
        cast = {**arrays, "field:density": arrays["field:density"]
                .astype(np.float32).astype(np.float64)}
    for hist, edges in host_hist(cast, dict(field="density", bins=16)):
        assert_same(got["edges"], edges, "edges vs host reducer")
        assert_same(got["hist"].numpy(), hist, "hist vs host reducer")
    x = node_inputs(arrays)
    values = x["values"].astype(np.float32) if dtype else x["values"]
    n_hist = min(x["n_levels"], r.max_levels)
    want = reference_hist(values, x["levels"], x["ok"], got["edges"],
                          n_hist, backend)
    assert_same(got["hist"].numpy(), want,
                f"hist vs repro.kernels.ops[{backend}] at {dtype}")


# ----------------------------------------------------------- wrapper

def small_table(seed=3, n=101, n_levels=3):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(-1.0, 2.0, n)),
            torch.from_numpy(rng.integers(-1, n_levels + 1, n)
                             .astype(np.int32)),
            torch.from_numpy(rng.random(n) < 0.8), n_levels)


def test_level_hist_on_cpu_takes_cpu_edges_and_refuses_others():
    values, levels, ok, n_levels = small_table()
    edges = torch.linspace(0.0, 1.0, 9, dtype=torch.float64)
    before = dict(raster.LAUNCHES)
    got = raster.level_hist(values, levels, ok, edges, n_levels=n_levels)
    assert raster.LAUNCHES == before
    assert torch.equal(got, ref.level_hist_ref(values, levels, ok, edges,
                                               n_levels=n_levels))
    assert got.dtype == torch.int32 and got.shape == (n_levels, 8)
    with pytest.raises(ValueError, match="one CUDA device or all on the"):
        raster.level_hist(values, levels, ok, edges.to("meta"),
                          n_levels=n_levels)


class _EdgesOn:
    """Stands for an edges tensor on CUDA device ``index``: all the edge
    routing reads before it refuses one."""

    def __init__(self, index):
        self.device = torch.device("cuda", index)

    def get_device(self):
        return self.device.index


def test_edge_routes():
    """CPU float64 edges up to HIST_PARAM_EDGES go by value; more are
    copied to the values' device; other dtypes and strides are made
    contiguous float64; edges on another device raise."""
    e = torch.linspace(0.0, 1.0, raster.HIST_PARAM_EDGES,
                       dtype=torch.float64)
    edg, on_host = raster._hist_edges(0, e, CPU)
    assert on_host == 1 and edg is e
    wide = torch.linspace(0.0, 1.0, raster.HIST_PARAM_EDGES + 1,
                          dtype=torch.float64)
    assert raster._hist_edges(0, wide, CPU)[1] == 0
    edg, on_host = raster._hist_edges(0, e.float()[::2], CPU)
    assert on_host == 1 and edg.dtype == torch.float64
    assert edg.is_contiguous()
    for where in (_EdgesOn(1), torch.empty(3, device="meta")):
        with pytest.raises(ValueError, match="on the CPU or on the values'"):
            raster._hist_edges(0, where, torch.device("cuda", 0))


def test_param_edges_match_the_kernel_source():
    src = (cudalib.CSRC / "raster.cu").read_text()
    assert f"constexpr int kParamEdges = {raster.HIST_PARAM_EDGES};" in src
    # the by-value edges stay under the 4 KB kernel parameter limit
    assert raster.HIST_PARAM_EDGES * 8 < 4096


def test_ops_twin_route_takes_cpu_edges():
    values, levels, ok, n_levels = small_table(seed=5)
    edges = torch.linspace(-0.5, 1.5, 17, dtype=torch.float64)
    want = ref.level_hist_ref(values, levels, ok, edges, n_levels=n_levels)
    for backend in (None, "ref"):
        got = ops.raster_level_hist_partial(values, levels, ok, edges,
                                            n_levels=n_levels,
                                            backend=backend)
        assert torch.equal(got, want)
        whole = ops.raster_level_hist(values, levels, ok, edges,
                                      n_levels=n_levels, backend=backend)
        assert torch.equal(whole, want.to(torch.int64))


# ------------------------------------------------- the kernel's bin walk

def walk_bins(values, edges):
    """numpy mirror of ``hist_cell`` in csrc/raster.cu (level and ok
    aside): each value's bin or -1, and the most walk steps taken."""
    bins = edges.size - 1
    lo, hi = edges[0], edges[-1]
    scale = bins / (hi - lo)
    out, most = np.full(values.size, -1), 0
    for i, v in enumerate(values.astype(np.float64)):
        if not (v >= lo and v <= hi):
            continue
        g, steps = bins - 1, 0
        if v != hi:
            t = (v - lo) * scale
            g = (int(t) if t < bins - 1 else bins - 1) if t >= 1.0 else 0
            while g > 0 and v < edges[g]:
                g, steps = g - 1, steps + 1
            while g < bins - 1 and v >= edges[g + 1]:
                g, steps = g + 1, steps + 1
        out[i], most = g, max(most, steps)
    return out, most


def searchsorted_bins(values, edges):
    """``np.histogram``'s bin of each value, -1 where it drops it."""
    v = values.astype(np.float64)
    b = np.searchsorted(edges, v, side="right") - 1
    b = np.where(v == edges[-1], edges.size - 2, b)
    return np.where((v >= edges[0]) & (v <= edges[-1]), b, -1)


def bin_case(name):
    rng = np.random.default_rng(11)
    lin = np.linspace(-4.0, 4.0, 65)
    if name == "linspace":
        edges = lin
    elif name == "duplicates":
        edges = np.sort(np.concatenate([rng.uniform(-3, 3, 30), [-1.0] * 4,
                                        [0.5] * 5, [3.0] * 3]))
    elif name == "geometric":
        edges = np.geomspace(1e-3, 1e3, 41)
    else:                                  # edges float32 cannot hold
        edges = np.linspace(0.1, 0.7, 65)
    f = edges.astype(np.float32)
    near = np.concatenate([edges, f, np.nextafter(f, np.float32(np.inf)),
                           np.nextafter(f, np.float32(-np.inf))])
    span = edges[-1] - edges[0]
    values = np.concatenate([
        near, rng.uniform(edges[0] - 0.1 * span, edges[-1] + 0.1 * span,
                          3000), [np.nan, np.inf, -np.inf]])
    if name == "float32 values":
        values = values.astype(np.float32)
    return values, edges


@pytest.mark.parametrize("name", ["linspace", "duplicates", "geometric",
                                  "float32 values"])
def test_bin_walk_mirror_is_searchsorted(name):
    values, edges = bin_case(name)
    got, most = walk_bins(values, edges)
    np.testing.assert_array_equal(got, searchsorted_bins(values, edges))
    if name in ("linspace", "float32 values"):
        assert most <= 1          # np.linspace edges: the guess or a neighbour


# --------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_level_hist_edge_routes_and_kept_output(cuda_device, dtype):
    """B3 / B3-f32 with CPU edges (by value, and past HIST_PARAM_EDGES
    copied) and with edges on the card, twice each on one stream: bitwise
    the twin, one launch a call, the next call's output left zeroed."""
    rng = np.random.default_rng(18)
    n, n_levels = 40_003, 6
    values = torch.from_numpy(rng.standard_normal(n)).to(cuda_device, dtype)
    levels = torch.from_numpy(rng.integers(-1, n_levels + 1, n)
                              .astype(np.int32)).to(cuda_device)
    ok = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    name = "level_hist" if dtype == torch.float64 else "level_hist_f32"
    stream = cudalib.current_stream(0)
    for n_edges in (65, raster.HIST_PARAM_EDGES + 40):
        e_cpu = torch.linspace(-2.5, 2.5, n_edges, dtype=torch.float64)
        want = ref.level_hist_ref(values, levels, ok, e_cpu.to(cuda_device),
                                  n_levels=n_levels)
        for edges in (e_cpu, e_cpu.to(cuda_device)):
            before = raster.LAUNCHES[name]
            got = [raster.level_hist(values, levels, ok, edges,
                                     n_levels=n_levels) for _ in range(2)]
            torch.cuda.synchronize()
            assert raster.LAUNCHES[name] - before == 2
            for g in got:
                assert torch.equal(g, want)
            kept = raster._HIST_NEXT[(0, stream, n_levels, n_edges - 1)]
            assert not bool(kept.any())


@pytest.mark.gpu
def test_cuda_reducers_pass_host_edges(cuda_device, edge_devices):
    """On the card both reducers hand B3 CPU edges and match the host."""
    arrays = sedov_arrays()
    r = LevelHistogramReducer(field="density", bins=16)
    dev = device_impl_for(r)(DeviceTree(to_device(arrays, cuda_device), 1))
    mesh = mesh_impl_for(r)(MeshTable(arrays, 1, [cuda_device] * 4))
    assert edge_devices == [CPU] * 5
    (hist, edges), _ = host_hist(arrays, dict(field="density", bins=16))
    for got in (dev, mesh):
        assert_same(got["edges"], edges, "edges vs host reducer")
        assert_same(got["hist"].cpu().numpy(), hist, "hist vs host reducer")
