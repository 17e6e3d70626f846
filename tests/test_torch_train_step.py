"""The port's train step (``repro_torch.train``) against the reference's.

The same numpy inputs and parameters (drawn from the reference's own
ParamSpecs, crossed with ``params_from_numpy``) go through
``jax.value_and_grad`` of the reference's ``loss_fn`` and through the
port's autograd, at float32 compute. ``adamw_step`` and ``wsd_schedule``
run on identical numpy grads and states in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_cases import (CPU, batch_np, compiled, leaves, spec_params, to_jax,
                      to_torch, with_dtype)
from repro.configs import ARCHS, get_smoke_config as ref_smoke
from repro.models.transformer import LM as RefLM
from repro.train import optim as ref_optim
from repro.train import step as ref_step
from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import LM, params_from_numpy
from repro_torch.train import optim, step


def f32(cfg):
    return with_dtype(cfg, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Loss and every grad leaf at float32 compute. Tolerances: the loss
    within rtol 1e-5; each leaf within 5e-3 of its own largest |grad|
    plus 1e-4 of the largest over the tree. Float32 sums fall in another
    order, through the random inits' large activations: the reference's
    own grads move by up to 1.4e-3 of that scale between its compiled
    and its op-by-op run (recurrentgemma), and by up to 9e-4 under
    one-ulp noise on its parameters (whisper); the second term covers
    leaves whose grads are tiny beside the rest."""
    cfg = f32(get_smoke_config(arch))
    ref = RefLM(f32(ref_smoke(arch)))
    params = spec_params(ref.cfg, 4)
    batch = batch_np(cfg, 2, 16, seed=5)
    args = (to_jax(params), to_jax(batch))
    (_, ref_m), ref_g = compiled(jax.value_and_grad(
        ref.loss_fn, has_aux=True), *args)(*args)

    lm = LM(cfg, device=CPU)
    metrics, grads = step.loss_and_grads(lm, params_from_numpy(params, CPU),
                                 to_torch(batch))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(ref_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(ref_m["aux"]),
                               rtol=1e-5, atol=1e-7)
    want = dict(leaves(jax.tree.map(np.asarray, ref_g)))
    got = dict(leaves(grads))
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape and g.dtype == np.float32, name
        err = np.abs(g - w).max()
        assert err <= 5e-3 * np.abs(w).max() + 1e-4 * top, (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_moves_params(arch):
    """One step of ``make_train_step`` on the smoke config: finite loss,
    an int32 step of 1, every float parameter leaf moved in place."""
    cfg = get_smoke_config(arch)
    lm = LM(cfg, device=CPU)
    state = step.init_state(lm, torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in lm.named_parameters()}
    ts = step.make_train_step(lm, optim.OptConfig(warmup_steps=1))
    state, metrics = ts(state, to_torch(batch_np(cfg, 2, 16)))
    assert torch.isfinite(metrics["loss"])
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    assert state["params"]["embed"]["tok"] is lm.embed.tok
    moved = [k for k, v in lm.named_parameters()
             if bool((v != before[k]).any())]
    assert moved == list(before), sorted(set(before) - set(moved))


def opt_states(seed: int):
    """Identical numpy params, grads and moments for both packages."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (7, 5), "b": (5,)}, "emb": (11, 3),
              "blocks": {"mlp": {"wi": (2, 3, 4)}}}

    def draw(scale, positive=False):
        def one(shape):
            x = rng.standard_normal(shape).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return jax.tree.map(one, shapes, is_leaf=lambda x: isinstance(x, tuple))
    return draw(1.0), draw(0.5), draw(0.1), draw(0.01, positive=True)


@pytest.mark.parametrize("n_step", [0, 1, 7, 150, 10_500, 12_200])
def test_adamw_step_matches_reference(n_step):
    """``adamw_step`` on identical grads and state, tightly (rtol 1e-6):
    the same float32 ops in the same order, through warmup, stable and
    decay, with clipping (the grads' norm is above clip_norm)."""
    params, grads, mu, nu = opt_states(n_step)
    cfg = optim.OptConfig()
    step_np = np.int32(n_step)
    r_params, r_opt, r_m = ref_optim.adamw_step(
        to_jax(params), to_jax(grads),
        {"mu": to_jax(mu), "nu": to_jax(nu), "step": jnp.int32(step_np)},
        ref_optim.OptConfig())
    t = lambda tree: jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree)
    p_params, p_opt, p_m = optim.adamw_step(
        t(params), t(grads),
        {"mu": t(mu), "nu": t(nu), "step": torch.tensor(n_step,
                                                        dtype=torch.int32)},
        cfg)
    assert p_opt["step"].dtype == torch.int32
    assert int(p_opt["step"]) == int(r_opt["step"]) == n_step + 1
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(p_m[k]), float(r_m[k]), rtol=1e-6)
    assert float(p_m["grad_norm"]) > cfg.clip_norm
    for got, want in ((p_params, r_params), (p_opt["mu"], r_opt["mu"]),
                      (p_opt["nu"], r_opt["nu"])):
        for (name, g), (_, w) in zip(leaves(got), leaves(
                jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-9,
                                       err_msg=name)


def test_wsd_schedule_matches_reference():
    """The schedule over warmup, stable, decay and past it (rtol 1e-6)."""
    cfg = optim.OptConfig(warmup_steps=10, stable_steps=20, decay_steps=30)
    ref_cfg = ref_optim.OptConfig(warmup_steps=10, stable_steps=20,
                                  decay_steps=30)
    for s in (0, 1, 5, 10, 11, 30, 31, 45, 60, 61, 1000):
        got = float(optim.wsd_schedule(torch.tensor(s, dtype=torch.int32),
                                       cfg))
        want = float(ref_optim.wsd_schedule(jnp.int32(s), ref_cfg))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(s))


def test_microbatches_match_one_batch():
    """``num_microbatches=2`` against one batch in the port, and against
    the reference's two-microbatch step: its first step's moments are
    (1 - b1)·g·scale and (1 - b2)·(g·scale)², so they carry the averaged
    grads. Tolerances as the grads' (float32, another sum order). The
    labels mask nothing, so the two microbatches' mean losses average to
    the batch's."""
    arch = "nemotron_4_340b"          # the smoke config with 2 microbatches
    cfg = f32(get_smoke_config(arch))
    assert cfg.num_microbatches == 2
    ref = RefLM(f32(ref_smoke(arch)))
    params = spec_params(ref.cfg, 6)
    batch = batch_np(cfg, 4, 16, seed=7)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    opt_cfg = optim.OptConfig(warmup_steps=1)

    def port_step(c):
        lm = LM(c, device=CPU)
        lm.load_param_tree(params_from_numpy(params, CPU))
        state = {"params": lm.param_tree(),
                 **optim.init_opt_state(lm.param_tree())}
        return step.make_train_step(lm, opt_cfg)(state, to_torch(batch))
    two, m_two = port_step(cfg)
    one, m_one = port_step(dataclasses.replace(cfg, num_microbatches=1))
    assert float(m_two["aux"]) == 0.0
    np.testing.assert_allclose(float(m_two["loss"]), float(m_one["loss"]),
                               rtol=1e-5)
    ref_state = {"params": to_jax(params),
                 **ref_optim.init_opt_state(to_jax(params))}
    args = (ref_state, to_jax(batch))
    r_state, r_m = compiled(ref_step.make_train_step(
        ref, ref_optim.OptConfig(warmup_steps=1)), *args)(*args)
    np.testing.assert_allclose(float(m_two["loss"]), float(r_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m_two["grad_norm"]),
                               float(r_m["grad_norm"]), rtol=1e-4)
    r_mu = dict(leaves(jax.tree.map(np.asarray, r_state["mu"])))
    top = max(np.abs(w).max() for w in r_mu.values())
    for other in (two, one):
        for name, g in leaves(other["mu"]):
            w = r_mu[name]
            err = np.abs(g.numpy() - w).max()
            assert err <= 5e-3 * np.abs(w).max() + 1e-4 * top, (name, err)
