"""A real train state through HProt, both ways between the packages.

The reference's ``step.init_state`` of a smoke arch, saved by its
``CheckpointManager``, restores through the port's into
``LM.load_param_tree`` and gives the reference's logits; the port's own
state (``step.init_state`` from a ``torch.Generator``), saved by the
port, restores in the reference and gives the port's logits. The two
packages write the same record tables and the same data files for the
same state; every restored leaf has its saved bytes.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_cases import (CPU, inputs, leaves, port_forward, ref_forward,
                      rel_err, with_dtype)
from repro.configs import get_smoke_config as ref_smoke
from repro.hercule.checkpoint import CheckpointManager as RefManager
from repro.hercule.database import HerculeDB
from repro.models.transformer import LM as RefLM
from repro.train import step as ref_step
from repro_torch.configs import get_smoke_config
from repro_torch.hercule.checkpoint import CheckpointManager, state_to_numpy
from repro_torch.models.transformer import LM, params_from_numpy
from repro_torch.train import optim, step

ARCHS = ["granite_moe_1b_a400m", "mamba2_1_3b"]
TOL = 5e-4          # test_torch_models.TOL at float32


def port_template(cfg):
    """The train state's layout as whole CPU tensors."""
    params = LM(cfg, device=CPU).param_tree()
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict)
                       else torch.empty(v.shape, dtype=torch.float32)
                       for k, v in t.items()}
    return {"params": zeros(params), "mu": zeros(params),
            "nu": zeros(params), "step": torch.empty((), dtype=torch.int32)}


def records(root, step_):
    db = HerculeDB.open(root)
    try:
        view = db.view(step_)
        return sorted((r.name, r.domain, r.dtype, list(r.shape), r.codec,
                       r.nbytes, r.file, r.offset) for r in view.records)
    finally:
        db.close()


def files(root):
    d = os.path.join(root, "data")
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def assert_same_state(got: dict, want: dict):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = np.asarray(got[name])
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_state_restores_in_port(arch, tmp_path):
    ref_cfg = with_dtype(ref_smoke(arch), "float32")
    cfg = with_dtype(get_smoke_config(arch), "float32")
    state = ref_step.init_state(RefLM(ref_cfg), jax.random.PRNGKey(7))
    state = jax.tree.map(np.asarray, state)
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    m = RefManager(ref_root, async_write=False)
    m.save(3, jax.tree.map(jnp.asarray, state))
    m.close()
    # the port writes the same tables and files for the same state
    p = CheckpointManager(port_root, async_write=False)
    p.save(3, {"params": params_from_numpy(state["params"], CPU),
               "mu": params_from_numpy(state["mu"], CPU),
               "nu": params_from_numpy(state["nu"], CPU),
               "step": torch.tensor(0, dtype=torch.int32)})
    p.close()
    assert records(port_root, 3) == records(ref_root, 3)
    assert files(port_root) == files(ref_root)

    got, _ = CheckpointManager(ref_root, async_write=False).restore(
        port_template(cfg))
    assert_same_state(state_to_numpy(got), state)
    lm = LM(cfg, device=CPU)
    lm.load_param_tree(got["params"])
    tokens, extras = inputs(cfg, 2, 16, seed=9)
    want, _ = ref_forward(ref_cfg, state["params"], tokens, extras)
    with torch.no_grad():
        logits, _ = lm(torch.from_numpy(tokens),
                       {k: torch.from_numpy(v) for k, v in extras.items()})
    assert rel_err(logits.numpy(), want) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_port_state_restores_in_reference(arch, tmp_path):
    cfg = with_dtype(get_smoke_config(arch), "float32")
    ref_cfg = with_dtype(ref_smoke(arch), "float32")
    lm = LM(cfg, device=CPU)
    state = step.init_state(lm, torch.Generator().manual_seed(7))
    # one step, so the moments and the step counter are not all zero
    tokens, extras = inputs(cfg, 2, 16, seed=10)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens),
             **{k: torch.from_numpy(v) for k, v in extras.items()}}
    state, _ = step.make_train_step(lm, optim.OptConfig(warmup_steps=1))(
        state, batch)
    root = str(tmp_path / "port")
    m = CheckpointManager(root, async_write=False)
    m.save(1, state)
    m.close()
    want = state_to_numpy(state)

    template = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype),
        want)
    got, _ = RefManager(root, async_write=False).restore(template)
    got = jax.tree.map(np.asarray, got)
    assert_same_state(got, want)
    assert int(got["step"]) == 1
    ref_logits, _ = ref_forward(ref_cfg, got["params"], tokens, extras)
    logits, _ = port_forward(cfg, want["params"], tokens, extras)
    assert rel_err(logits, ref_logits) <= TOL
