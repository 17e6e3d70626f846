"""The port's in-transit engine against the reference host engine.

``repro_torch``'s ``InTransitEngine(device_reduce=True, device="cpu")``
runs the device path (device staging, DeviceTree, the kernels' plain
twins, the device LOD cut) on CPU tensors; its catalog must be
bit-equal to the catalog of ``repro``'s host engine on the same seeded
steps. Also: zero full-snapshot fallbacks on the CLI's default DAG,
exact transfer accounting, device staging copy semantics, tensor
reducers against the reference, and no silent CPU fallback.
"""
import jax
import numpy as np
import pytest
import torch

from repro.insitu import Catalog as CatalogRef
from repro.insitu import InTransitEngine as EngineRef
from repro.insitu import reducers as red_ref
from repro.insitu.staging import Snapshot as SnapRef
from repro.sim import amrgen, fields
from repro_torch.insitu import Catalog, InTransitEngine
from repro_torch.insitu import reducers as red_pt
from repro_torch.insitu.device import DeviceStagingArea
from repro_torch.insitu.staging import Snapshot
from repro_torch.launch import insitu as cli


def random_tree(seed: int, max_level: int = 5):
    rng = np.random.default_rng(seed)
    tree = amrgen.generate_tree(fields.sedov(r_shock=0.2 + 0.1 * rng.random()),
                                min_level=2, max_level=max_level,
                                threshold=1.1)
    tree.fields["density"] = rng.standard_normal(tree.n_nodes) * 4.0 + 1.0
    return tree


def dag(mod, res: int, *, auto_hist: bool):
    hist = mod.LevelHistogramReducer(field="density", bins=16) if auto_hist \
        else mod.LevelHistogramReducer(field="density", bins=16, lo=-8.0,
                                       hi=8.0)
    return [mod.SliceReducer(field="density", resolution=res),
            mod.ProjectionReducer(field="density", resolution=res),
            hist, mod.LODCutReducer(max_level=3),
            mod.SliceReducer(field="density", resolution=res,
                             source="lod3")]


def assert_catalogs_equal(root_ref: str, root_pt: str, steps, domains):
    cr, cp = CatalogRef(root_ref), Catalog(root_pt)
    try:
        assert cr.steps() == cp.steps() == list(steps)
        for s in steps:
            assert cr.reducers(s) == cp.reducers(s)
            for r in cr.reducers(s):
                for d in [None] + list(range(domains) if domains > 1
                                       else []):
                    with jax.enable_x64(True):
                        a = cr.query(s, r, domain=d)
                    b = cp.query(s, r, domain=d)
                    assert set(a) == set(b), (s, r)
                    for k in a:
                        assert a[k].dtype == b[k].dtype, (s, r, k)
                        assert a[k].tobytes() == b[k].tobytes(), (s, r, d, k)
    finally:
        cr.close()
        cp.close()


@pytest.mark.parametrize("domains,res,auto_hist",
                         [(1, 16, True), (1, 64, True), (2, 32, False)])
def test_device_engine_catalog_equals_reference_host(tmp_path, domains, res,
                                                     auto_hist):
    trees = {s: random_tree(s) for s in (1, 2, 3)}
    with jax.enable_x64(True):
        eng = EngineRef(str(tmp_path / "ref"),
                        dag(red_ref, res, auto_hist=auto_hist),
                        domains=domains, policy="block").start()
        for s, tree in trees.items():
            assert eng.submit(s, tree)
        eng.close()
    eng = InTransitEngine(str(tmp_path / "pt"),
                          dag(red_pt, res, auto_hist=auto_hist),
                          domains=domains, policy="block",
                          device_reduce=True, device="cpu").start()
    for s, tree in trees.items():       # the snapshot crosses as arrays
        assert eng.submit(s, tree.to_arrays())
    eng.close()
    ds = eng.device_stats
    assert ds["fallback_snapshots"] == 0
    assert ds["snapshots"] == 3 * domains
    assert_catalogs_equal(str(tmp_path / "ref"), str(tmp_path / "pt"),
                          trees, domains)


def test_default_cli_dag_never_falls_back(tmp_path):
    eng = InTransitEngine(str(tmp_path / "db"), cli.default_reducers(64, 4),
                          policy="block", device_reduce=True,
                          device="cpu").start()
    for s in (1, 2):
        tree = amrgen.generate_tree(fields.sedov(r_shock=0.1 + 0.1 * s),
                                    min_level=3, max_level=6,
                                    threshold=1.15, level_factor=1.05)
        assert eng.submit(s, tree.to_arrays())
    eng.close()
    ds = eng.device_stats
    assert ds["fallback_snapshots"] == 0
    assert ds["bytes_fallback_to_host"] == 0
    # only the LOD-sourced slice runs on host, from the LOD's output
    assert ds["fallback_runs"] == {"slice-density-ax2-p0.5-r64-of-lod4": 2}
    assert ds["device_objects"] == 8


def test_transfer_accounting_is_the_reduced_objects(tmp_path):
    """Bytes to host = the reduced tensors; meta = level_offsets pulls
    (LOD) + 16-byte auto-bounds pulls; no fallback bytes."""
    trees = {s: random_tree(s, max_level=6) for s in (1, 2)}
    root = str(tmp_path / "db")
    eng = InTransitEngine(root, dag(red_pt, 32, auto_hist=True),
                          policy="block", device_reduce=True,
                          device="cpu").start()
    for s, tree in trees.items():
        assert eng.submit(s, tree.to_arrays())
    eng.close()
    ds = eng.device_stats
    cat = Catalog(root)
    reduced = meta = 0
    for s, tree in trees.items():
        for r in cat.reducers(s):
            if r.endswith("-of-lod3"):
                continue             # runs on host from the LOD output
            for k, v in cat.query(s, r).items():
                # edges are host-made; the cut's offsets are sized on host
                if k not in ("edges", "level_offsets"):
                    reduced += v.nbytes
        meta += tree.level_offsets.nbytes + 16
    cat.close()
    assert ds["bytes_reduced_to_host"] == reduced
    assert ds["bytes_meta_to_host"] == meta
    assert ds["bytes_to_host"] == reduced + meta


def test_device_reduce_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InTransitEngine(str(tmp_path / "db"),
                        [red_pt.SliceReducer(resolution=32)],
                        device_reduce=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceStagingArea(capacity=2, device="cuda")


def test_engine_rejects_unported_modes(tmp_path):
    with pytest.raises(ValueError, match="device_reduce mode"):
        InTransitEngine(str(tmp_path / "a"), [red_pt.SliceReducer()],
                        device_reduce="tpu")
    with pytest.raises(ValueError, match="thread"):
        InTransitEngine(str(tmp_path / "b"), [red_pt.SliceReducer()],
                        device_reduce=True, device="cpu", backend="process")


# ----------------------------------------------------------- staging

def test_device_staging_copies_host_and_tensor_pushes():
    st = DeviceStagingArea(capacity=2, device="cpu")
    a = np.arange(8.0)
    t = torch.arange(4.0, dtype=torch.float64)
    assert st.push(1, {"a": a, "t": t})
    a[:] = -1.0
    t[:] = -1.0
    snap = st.pop(timeout=1.0)
    assert isinstance(snap.arrays["a"], torch.Tensor)
    assert snap.arrays["a"].dtype == torch.float64    # no downcast
    np.testing.assert_array_equal(snap.arrays["a"].numpy(), np.arange(8.0))
    np.testing.assert_array_equal(snap.arrays["t"].numpy(), np.arange(4.0))
    assert st.stats.buffer_allocs == 1 and st.stats.buffer_reuses == 1
    st.release(snap)
    st.close()


def test_device_staging_drop_oldest_parity():
    st = DeviceStagingArea(capacity=2, policy="drop-oldest", device="cpu")
    for s in range(1, 6):
        assert st.push(s, {"a": np.full(4, float(s))})
    assert len(st) == 2
    assert st.stats.evicted == 3
    snaps = [st.pop(timeout=1.0), st.pop(timeout=1.0)]
    assert [s.step for s in snaps] == [4, 5]
    for s in snaps:
        st.release(s)
    st.close()


# ------------------------------------------------------ tensor reducers

@pytest.mark.parametrize("on_device", [False, True])
def test_tensor_reducers_match_reference(on_device):
    """float32 statistics and singular values: the reductions sum in a
    different order than XLA's, so agreement is to float32 roundoff
    (rtol 1e-5, atol 1e-6), names and shapes exactly."""
    rng = np.random.default_rng(5)
    arrays = {"w/a": rng.standard_normal((12, 7)).astype(np.float32),
              "w/b": rng.standard_normal((5, 5)),
              "bias": rng.standard_normal(9).astype(np.float32)}
    snap_pt_arrays = {k: torch.from_numpy(v) for k, v in arrays.items()} \
        if on_device else arrays
    for name in ("TensorNormReducer", "SpectraReducer"):
        r_ref, r_pt = getattr(red_ref, name)(), getattr(red_pt, name)()
        want = r_ref.reduce(SnapRef(step=0, kind="tensors",
                                    arrays=arrays), {})
        got = r_pt.reduce(Snapshot(step=0, kind="tensors",
                                   arrays=snap_pt_arrays), {})
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype, (name, k)
            if want[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------- CLI

def test_cli_device_reduce_on_cpu(tmp_path, capsys):
    rc = cli.main(["--out", str(tmp_path / "cli"), "--steps", "2",
                   "--max-level", "4", "--resolution", "32", "--queries",
                   "2", "--policy", "block", "--device-reduce", "--device",
                   "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "device reduce:" in out and "contexts: [2]" in out


def test_cli_default_out_is_a_fresh_temp_dir(tmp_path, monkeypatch, capsys):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--steps", "2", "--max-level", "4", "--resolution", "32",
            "--queries", "1", "--policy", "block", "--device-reduce",
            "--device", "cpu"]
    assert cli.main(argv) == 0 and cli.main(argv) == 0
    runs = sorted(tmp_path.glob("hx_insitu_*"))
    assert len(runs) == 2 and all(any(r.iterdir()) for r in runs)
    out = capsys.readouterr().out
    assert all(str(r) in out for r in runs)


@pytest.mark.parametrize("flag", [["--device-mesh", "2", "--device-reduce"],
                                  ["--device", "cpu"]])
def test_cli_refuses_unported_flags(tmp_path, flag):
    with pytest.raises(SystemExit) as ei:
        cli.main(["--out", str(tmp_path / "x"), *flag])
    assert ei.value.code == 2
