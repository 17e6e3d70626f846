"""The port's GPipe (``repro_torch.launch.pipeline``) against its own
sequential forward (bitwise) and the reference's ``gpipe_forward``
(within 1e-5, in a subprocess with 8 forced host devices, as
``tests/test_pipeline.py`` runs it)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.launch import pipeline

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
L, D = 8, 16          # 8 layers -> 4 stages x 2 layers
N_MICRO, MB, N_STAGES = 6, 4, 4

_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_test_mesh
from repro.launch import pipeline

mesh = make_test_mesh((4, 2), ("pod", "data"))
z = np.load(sys.argv[1])
params = {"w": jnp.asarray(z["w"]), "b": jnp.asarray(z["b"])}

def stage_fn(p, x):
    for i in range(p["w"].shape[0]):
        x = jnp.tanh(x @ p["w"][i] + p["b"][i])
    return x

stages = pipeline.stack_stages(params, 4)
with mesh:
    got = pipeline.gpipe_forward(stage_fn, stages, jnp.asarray(z["x"]),
                                 mesh=mesh)
np.save(sys.argv[2], np.asarray(got))
"""


def case():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    return w, b, x


def stage_fn(p, x):     # p has leading dim L/S
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def port_forwards():
    w, b, x = case()
    stages = pipeline.stack_stages({"w": torch.from_numpy(w),
                                    "b": torch.from_numpy(b)}, N_STAGES)
    xt = torch.from_numpy(x)
    got = pipeline.gpipe_forward(stage_fn, stages, xt,
                                 devices=[torch.device("cpu")] * N_STAGES)
    want = pipeline.sequential_forward(stage_fn, stages, xt, N_STAGES)
    return got, want


def test_gpipe_bitwise_sequential_forward():
    got, want = port_forwards()
    assert got.shape == (N_MICRO, MB, D)
    assert torch.equal(got, want)


def test_gpipe_matches_the_reference(tmp_path):
    w, b, x = case()
    np.savez(tmp_path / "in.npz", w=w, b=b, x=x)
    out = subprocess.run(
        [sys.executable, "-c", _REF, str(tmp_path / "in.npz"),
         str(tmp_path / "ref.npy")],
        env={**os.environ, "PYTHONPATH": SRC}, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = np.load(tmp_path / "ref.npy")
    got, _ = port_forwards()
    assert float(np.max(np.abs(got.numpy() - ref))) < 1e-5


def test_gpipe_takes_a_mesh_pod_dim():
    """A ``DeviceMesh`` gives its 'pod' dim's devices (a fake group of 8
    ranks, a (4, 2) ("pod", "data") cpu mesh: four cpu stages)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    w, b, x = case()
    stages = pipeline.stack_stages({"w": torch.from_numpy(w),
                                    "b": torch.from_numpy(b)}, N_STAGES)
    xt = torch.from_numpy(x)
    with dryrun.fake_group(8):
        mesh = make_test_mesh((4, 2), ("pod", "data"), "cpu")
        assert pipeline.stage_devices(mesh) == [torch.device("cpu")] * 4
        got = pipeline.gpipe_forward(stage_fn, stages, xt, devices=mesh)
    want = pipeline.sequential_forward(stage_fn, stages, xt, N_STAGES)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_micro,n_stages", [(6, 4), (8, 4), (1, 3),
                                              (3, 1)])
def test_schedule_fill_compute_drain(n_micro, n_stages):
    ticks = pipeline.schedule(n_micro, n_stages)
    assert len(ticks) == n_micro + n_stages - 1
    for t, work in enumerate(ticks):
        assert work == [(s, t - s) for s in range(n_stages)
                        if 0 <= t - s < n_micro]
    # every stage sees every microbatch once, in order
    for s in range(n_stages):
        assert [m for tick in ticks for st, m in tick if st == s] == \
            list(range(n_micro))


def test_bubble_fraction():
    assert abs(pipeline.bubble_fraction(6, 4) - 3 / 9) < 1e-12
    assert abs(pipeline.bubble_fraction(8, 4) - 3 / 11) < 1e-12
    assert pipeline.bubble_fraction(5, 1) == 0.0


def test_stack_stages_views():
    x = torch.arange(8 * 3).reshape(8, 3)
    st = pipeline.stack_stages({"a": {"w": x}}, 4)["a"]["w"]
    assert st.shape == (4, 2, 3)
    assert torch.equal(st[1], x[2:4])
    with pytest.raises(AssertionError):
        pipeline.stack_stages({"w": x}, 3)


@pytest.mark.gpu
def test_gpipe_on_one_card_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, b, x = case()
    dev = torch.device("cuda", 0)
    stages = pipeline.stack_stages({"w": torch.from_numpy(w).to(dev),
                                    "b": torch.from_numpy(b).to(dev)},
                                   N_STAGES)
    xt = torch.from_numpy(x).to(dev)
    got = pipeline.gpipe_forward(stage_fn, stages, xt,
                                 devices=[dev] * N_STAGES)
    want = pipeline.sequential_forward(stage_fn, stages, xt, N_STAGES)
    assert torch.equal(got, want)
