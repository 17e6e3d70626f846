"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the reference's, on the reference's own ``lm.init`` parameters
crossed as numpy (``params_from_numpy``).

Per arch the forward logits and aux are held to the reference's at
float32 and at bf16 compute, on ``device="cpu"``; the configs and the
parameter tree (names, shapes, dtypes) equal the reference's. The
``gpu`` case runs the ten smoke configs on the card against the CPU.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from lm_cases import (CPU, inputs, port_forward, port_lm, ref_forward,
                      ref_init, rel_err, smoke_params, with_dtype)
from repro import configs as ref_configs
from repro.configs import registry as ref_registry
from repro.hercule.checkpoint import leaf_name as ref_leaf_name
from repro.models.transformer import LM as RefLM
from repro_torch import configs
from repro_torch.configs import ARCHS, get_config, get_smoke_config, registry
from repro_torch.models.transformer import (LM, params_from_numpy,
                                           params_to_numpy)
from repro_torch.train import optim, step

# Tolerances on max |logit difference| / max |reference logit|:
# float32 - sums in another order, amplified by the random inits' large
# activations (one-ulp noise on the reference's own parameters moves its
# logits by up to 7e-5 of the largest; recurrentgemma's scans add more);
# bf16 - the bound test_models' decode test uses; with every bf16 op
# rounded as written in both packages they differ by at most 0.5 %.
TOL = {"float32": 5e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, dtype):
    cfg = with_dtype(get_smoke_config(arch), dtype)
    params = smoke_params(arch)
    tokens, extras = inputs(cfg, 2, 16)
    want, want_aux = ref_forward(with_dtype(ref_configs.get_smoke_config(
        arch), dtype), params, tokens, extras)
    got, aux = port_forward(cfg, params, tokens, extras)
    assert got.shape == (2, 16, cfg.vocab_size)
    assert rel_err(got, want) <= TOL[dtype], rel_err(got, want)
    # MoE aux: the same routing at float32; bf16 may route a near-tie
    # differently, which moves one assignment's count
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5 if dtype ==
                               "float32" else 2e-2, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    """Dotted names, shapes and dtypes equal the reference's
    ``jax.tree_util`` paths (``leaf_name`` of their keystr)."""
    shapes = jax.eval_shape(RefLM(ref_configs.get_smoke_config(arch)).init,
                            jax.random.PRNGKey(0))
    want = {ref_leaf_name(jax.tree_util.keystr(p)): (tuple(x.shape),
                                                     str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}
    lm = LM(get_smoke_config(arch), device=CPU)
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in lm.named_parameters()}
    assert got == want


def test_registry_matches_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.SHAPES == ref_configs.SHAPES
    assert registry.LONG_OK == ref_registry.LONG_OK
    assert registry.cells(True) == ref_registry.cells(True)
    for arch in ARCHS:
        for mine, theirs in ((get_config(arch), ref_configs.get_config(arch)),
                             (get_smoke_config(arch),
                              ref_configs.get_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert mine.param_count() == theirs.param_count()
            assert mine.active_param_count() == theirs.active_param_count()


def test_full_configs_match_assignment():
    """Exact dims from the assignment table."""
    want = {
        "whisper_medium": dict(n_layers=24, d_model=1024, n_heads=16,
                               d_ff=4096, vocab_size=51865),
        "minicpm_2b": dict(n_layers=40, d_model=2304, n_heads=36,
                           d_ff=5760, vocab_size=122753),
        "internlm2_20b": dict(n_layers=48, d_model=6144, n_heads=48,
                              n_kv_heads=8, d_ff=16384, vocab_size=92544),
        "nemotron_4_340b": dict(n_layers=96, d_model=18432, n_heads=96,
                                n_kv_heads=8, d_ff=73728, vocab_size=256000),
        "stablelm_1_6b": dict(n_layers=24, d_model=2048, n_heads=32,
                              d_ff=5632, vocab_size=100352),
        "mamba2_1_3b": dict(n_layers=48, d_model=2048, vocab_size=50280,
                            ssm_state=128),
        "mixtral_8x22b": dict(n_layers=56, d_model=6144, n_heads=48,
                              n_kv_heads=8, d_ff=16384, vocab_size=32768,
                              n_experts=8, top_k=2),
        "granite_moe_1b_a400m": dict(n_layers=24, d_model=1024, n_heads=16,
                                     n_kv_heads=8, d_ff=512, vocab_size=49155,
                                     n_experts=32, top_k=8),
        "recurrentgemma_2b": dict(n_layers=26, d_model=2560, n_heads=10,
                                  n_kv_heads=1, d_ff=7680, vocab_size=256000),
        "llava_next_34b": dict(n_layers=60, d_model=7168, n_heads=56,
                               n_kv_heads=8, d_ff=20480, vocab_size=64000),
    }
    for arch, fields in want.items():
        cfg = get_config(arch)
        for k, v in fields.items():
            assert getattr(cfg, k) == v, (arch, k, getattr(cfg, k), v)


def test_param_count_plausible():
    """Formula param counts near published sizes (rough: +-40%), and the
    tree of a smoke model holds exactly what its formula's terms add up
    to for the dense families."""
    approx = {"minicpm_2b": 2.7e9, "internlm2_20b": 20e9,
              "nemotron_4_340b": 340e9, "stablelm_1_6b": 1.6e9,
              "mamba2_1_3b": 1.3e9, "mixtral_8x22b": 141e9,
              "recurrentgemma_2b": 2.7e9, "llava_next_34b": 34e9}
    for arch, want in approx.items():
        n = get_config(arch).param_count()
        assert 0.5 * want < n < 1.6 * want, (arch, n, want)
    for arch in ("stablelm_1_6b", "internlm2_20b", "minicpm_2b"):
        cfg = get_smoke_config(arch)
        lm = LM(cfg, device=CPU)
        norms = sum(p.numel() for k, p in lm.named_parameters()
                    if "ln" in k or "norm" in k)
        n = sum(p.numel() for p in lm.parameters())
        assert n - norms == cfg.param_count(), arch


def test_sliding_window_masks_old_tokens():
    """Changing a token more than ``window`` positions back leaves the
    last position's logits as they were."""
    cfg = dataclasses.replace(get_smoke_config("mixtral_8x22b"), window=4,
                              capacity_factor=16.0, compute_dtype="float32")
    lm = LM(cfg, device=CPU)
    lm.init(torch.Generator().manual_seed(3))
    tokens, _ = inputs(cfg, 1, 10, seed=4)
    t1 = torch.from_numpy(tokens)
    t2 = t1.clone()
    t2[0, 0] = (t2[0, 0] + 1) % cfg.vocab_size
    with torch.no_grad():
        la, _ = lm(t1)
        lb, _ = lm(t2)
    np.testing.assert_allclose(la[0, -1].numpy(), lb[0, -1].numpy(),
                               atol=1e-4)
    assert not torch.equal(la[0, 0], lb[0, 0])


def test_lm_runs_on_the_card_unless_asked():
    """``LM(cfg)`` and ``params_from_numpy(tree)`` mean the card; without
    one they raise, never carry on on the CPU."""
    cfg = get_smoke_config("stablelm_1_6b")
    tree = smoke_params("stablelm_1_6b")
    if torch.cuda.is_available():
        assert LM(cfg).device.type == "cuda"
        assert params_from_numpy(tree)["embed"]["tok"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LM(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_numpy(tree)
    assert LM(cfg, device="cpu").device == CPU


def test_init_is_seeded_and_draws_as_the_reference():
    """``lm.init`` draws every leaf from the generator: the same seed
    gives the same tree, norms as their init, and every leaf from the
    reference's distribution: a default-scaled one at 1/sqrt(shape[0])
    (the layer count for a stacked leaf), as the reference's own init."""
    cfg = get_smoke_config("granite_moe_1b_a400m")
    a = LM(cfg, device=CPU).init(torch.Generator().manual_seed(1))
    b = LM(cfg, device=CPU).init(torch.Generator().manual_seed(1))
    flat, other = dict(_flat(a)), dict(_flat(b))
    for name, x in flat.items():
        assert torch.equal(x, other[name]), name
    assert torch.equal(flat["final_norm.scale"], torch.zeros(cfg.d_model))
    assert torch.equal(flat["blocks.ln1.scale"],
                       torch.zeros(cfg.n_layers, cfg.d_model))
    std = {"blocks.moe.wi": cfg.n_layers, "blocks.moe.router": cfg.n_layers,
           "blocks.attn.wo": cfg.n_layers, "embed.tok": 1}
    for name, n in std.items():
        got = float(flat[name].detach().std())
        assert abs(got * n ** 0.5 - 1.0) < 0.1, (name, got)
    # every leaf's spread within 10 % of the reference init's (sampling
    # error of the smallest normal leaf, 64 x 8 values: about 3 %)
    ref = dict(_flat(ref_init(cfg, 1)))
    for name, x in flat.items():
        want = float(np.std(ref[name]))
        if want > 0:
            assert abs(float(x.detach().std()) / want - 1.0) < 0.1, name


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_on_the_card_matches_cpu(arch, cuda_device):
    """Phase 9(a) of chip_smoke.py: the card against the port's CPU path
    on the reference's smoke parameters (those the CPU tests use), at
    float32 compute with TF32 off (TOL) and at bf16 (TOL), then one
    train step on the card."""
    assert not torch.backends.cuda.matmul.allow_tf32
    params = smoke_params(arch)
    for dtype in ("float32", "bfloat16"):
        cfg = with_dtype(get_smoke_config(arch), dtype)
        tokens, extras = inputs(cfg, 2, 16)
        want, _ = port_forward(cfg, params, tokens, extras)
        got, _ = port_forward(cfg, params, tokens, extras, cuda_device)
        assert np.isfinite(got).all()
        assert rel_err(got, want) <= TOL[dtype], (dtype, rel_err(got, want))
    lm = port_lm(get_smoke_config(arch), params, cuda_device)
    state = {"params": lm.param_tree(),
             **optim.init_opt_state(lm.param_tree())}
    before = lm.embed.tok.detach().clone()
    batch = {"tokens": torch.from_numpy(tokens).to(cuda_device),
             "labels": torch.from_numpy(tokens).to(cuda_device),
             **{k: torch.from_numpy(v).to(cuda_device)
                for k, v in extras.items()}}
    state, metrics = step.make_train_step(
        lm, optim.OptConfig(warmup_steps=1))(state, batch)
    assert torch.isfinite(metrics["loss"]) and int(state["step"]) == 1
    assert not torch.equal(before, lm.embed.tok)
