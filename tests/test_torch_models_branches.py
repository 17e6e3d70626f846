"""Branches of the port's LM stack that the smoke shapes miss, against
the reference at float32 compute on the same parameters: query-chunked
attention, sliding windows, MoE grouping (t >= 2,048) and capacity
drops, tied expert choices, an SSD length that is not a multiple of the
chunk, the hybrid tail, tied embeddings, remat, the unrolled layer
loop, and the two branches the published widths take: a VLM patch
prefix across query chunks (llava-next-34b's 2,880 patches against
``attn_chunk`` 1,024) and an encoder whose frame count is not a
multiple of the chunk (whisper-medium's 1,500).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_cases import (CPU, batch_np, inputs, leaves, port_forward,
                      ref_forward, ref_init, rel_err, smoke_params, to_torch,
                      with_dtype)
from repro.configs import ARCHS, get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers, moe, ssm
from repro_torch.models.transformer import LM, params_from_numpy
from repro_torch.train import step

# max |logit difference| / max |reference logit| at float32: sums in
# another order (test_torch_models.TOL)
TOL = 5e-4

# name: (arch, config overrides, batch, sequence)
CASES = {
    "attn_chunk": ("stablelm_1_6b", dict(attn_chunk=8), 2, 16),
    "window": ("stablelm_1_6b", dict(window=4), 2, 16),
    "window_chunked": ("mixtral_8x22b", dict(window=4, attn_chunk=8), 2, 16),
    "moe_groups": ("granite_moe_1b_a400m", dict(moe_groups=4), 2, 1024),
    "moe_capacity_drop": ("mixtral_8x22b", dict(capacity_factor=0.5), 2, 16),
    "ssd_pad": ("mamba2_1_3b", {}, 2, 13),
    "hybrid_tail": ("recurrentgemma_2b", dict(n_layers=4), 2, 16),
    "tied_embeddings": ("stablelm_1_6b", dict(tie_embeddings=True), 2, 16),
    "remat": ("granite_moe_1b_a400m", dict(remat="full"), 2, 16),
    "unroll": ("internlm2_20b", dict(unroll_layers=True), 2, 16),
    "vlm_chunked": ("llava_next_34b", dict(n_patches=12, attn_chunk=8), 2,
                    16),
    "encdec_chunked": ("whisper_medium", dict(n_frames=12, attn_chunk=8), 2,
                       16),
}
# cases whose parameter tree differs from the smoke config's
NEW_TREE = {"hybrid_tail", "tied_embeddings"}


def case_configs(name):
    arch, over, b, s = CASES[name]
    ref_cfg = dataclasses.replace(ref_smoke(arch), compute_dtype="float32",
                                  **over)
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype="float32", **over)
    return ref_cfg, cfg, b, s


@pytest.mark.parametrize("name", sorted(CASES))
def test_branch_matches_reference(name):
    ref_cfg, cfg, b, s = case_configs(name)
    params = ref_init(ref_cfg, 0) if name in NEW_TREE \
        else smoke_params(CASES[name][0])
    tokens, extras = inputs(cfg, b, s, seed=1)
    want, want_aux = ref_forward(ref_cfg, params, tokens, extras)
    got, aux = port_forward(cfg, params, tokens, extras)
    assert rel_err(got, want) <= TOL, rel_err(got, want)
    np.testing.assert_allclose(aux, want_aux, rtol=1e-5, atol=1e-7)
    # the branch is the one the case names
    if name == "attn_chunk" or name == "window_chunked":
        assert s > cfg.attn_chunk
    if name == "moe_groups":
        assert moe.groups(cfg, b * s) == 4
    if name == "moe_capacity_drop":       # pigeonhole: some expert overflows
        tl = b * s // moe.groups(cfg, b * s)
        assert moe.capacity(cfg, tl) < tl * cfg.top_k / cfg.n_experts
    if name == "ssd_pad":
        assert s % cfg.ssm_chunk
    if name == "hybrid_tail":
        assert LM(cfg, device=CPU).tail_kinds == ["rec"]
    if name == "vlm_chunked":      # the patches fill one chunk and cross
        assert s > cfg.attn_chunk and s % cfg.attn_chunk == 0
        assert cfg.attn_chunk < cfg.n_patches < s
        assert extras["patch_embeds"].shape == (b, cfg.n_patches, cfg.d_model)
    if name == "encdec_chunked":   # as 1,500 frames against 1,024
        assert s > cfg.attn_chunk and cfg.n_frames % cfg.attn_chunk
        assert extras["frames"].shape == (b, cfg.n_frames, cfg.d_model)


def test_moe_ties_keep_the_lower_expert():
    """A zero router ties every expert for every token: ``lax.top_k``
    takes experts 0..k-1, and the stable sort decides which tokens each
    overflowing bucket keeps, over four dispatch groups."""
    cfg = dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"),
                              compute_dtype="float32", moe_groups=4)
    params = smoke_params("granite_moe_1b_a400m")
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    p["router"] = np.zeros_like(p["router"])
    x = np.random.default_rng(2).standard_normal(
        (2, 1024, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.moe_mlp(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), cfg)
    got, aux = moe.moe_mlp(params_from_numpy(p, CPU), torch.from_numpy(x),
                           cfg)
    assert moe.groups(cfg, 2048) == 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    kept = (got.abs().sum(-1) > 0).reshape(-1)
    assert 0 < int(kept.sum()) < kept.numel()   # some tokens dropped


def test_router_hook_sees_each_moe_layer_and_is_removed():
    """``moe.register_router_hook`` gets each MoE layer's router
    probabilities, (groups, tokens per group, experts), rows summing to
    1; the output does not change, and after ``remove()`` it is not
    called."""
    cfg = get_smoke_config("granite_moe_1b_a400m")
    lm = LM(cfg, device=CPU)
    lm.load_param_tree(params_from_numpy(
        smoke_params("granite_moe_1b_a400m"), CPU))
    tokens = torch.from_numpy(inputs(cfg, 2, 16)[0])
    seen = []
    with torch.no_grad():
        want, _ = lm(tokens)
        with moe.register_router_hook(seen.append):
            got, _ = lm(tokens)
        lm(tokens)
    assert torch.equal(got, want)
    assert len(seen) == cfg.n_layers
    for probs in seen:
        assert probs.shape == (1, 32, cfg.n_experts)
        assert not probs.requires_grad
        torch.testing.assert_close(probs.sum(-1), torch.ones(1, 32))


def test_ssd_grads_finite_past_exp_overflow():
    """A chunk whose decay sum passes ~88: the forward equals the
    reference's, and the port's grads stay finite (the masked triangle
    is set to -inf before the exp, never exp'd and then masked)."""
    cfg = get_smoke_config("mamba2_1_3b")
    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 16, 2, 4, 8
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 12.0, np.float32)
    a = -np.ones(h, np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    want, want_state = ref_ssm.ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm,
                                                              cm)), 16)
    args = [torch.from_numpy(v).requires_grad_(True)
            for v in (xh, dt, a, bm, cm)]
    got, state = ssm.ssd_chunked(*args, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(state.detach().numpy(),
                               np.asarray(want_state), rtol=1e-5, atol=1e-6)
    (got.sum() + state.sum()).backward()
    for t in args:
        assert torch.isfinite(t.grad).all()
    assert cfg.ssm_chunk < s * 12      # the decay passes exp's range


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "granite_moe_1b_a400m",
                                  "mamba2_1_3b", "recurrentgemma_2b",
                                  "whisper_medium"])
def test_remat_matches_no_remat(arch):
    """``remat="full"`` recomputes each layer in the backward: the logits
    and every grad equal the run without it, bit for bit."""
    params = smoke_params(arch)
    batch = to_torch(batch_np(get_smoke_config(arch), 2, 16, seed=8))
    out = []
    for remat in ("none", "full"):
        cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
        lm = LM(cfg, device=CPU)
        tree = params_from_numpy(params, CPU)
        with torch.no_grad():
            logits, _ = lm.apply_params(tree, batch["tokens"], extras={
                k: v for k, v in batch.items()
                if k in ("patch_embeds", "frames")})
        metrics, grads = step.loss_and_grads(lm, tree, batch)
        out.append((logits, metrics["loss"], grads))
    (la, lossa, ga), (lb, lossb, gb) = out
    assert torch.equal(la, lb) and torch.equal(lossa, lossb)
    for (name, x), (_, y) in zip(leaves(ga), leaves(gb)):
        assert torch.equal(x, y), name


def test_unroll_matches_scan():
    """``unroll_layers`` (the reference's cost-analysis probe flag)
    changes nothing in the port, whose layer loop is always unrolled."""
    cfg = with_dtype(get_smoke_config("internlm2_20b"), "bfloat16")
    params = smoke_params("internlm2_20b")
    tokens, _ = inputs(cfg, 2, 8, seed=3)
    a, _ = port_forward(cfg, params, tokens, {})
    b, _ = port_forward(dataclasses.replace(cfg, unroll_layers=True), params,
                        tokens, {})
    assert np.array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_rope_freqs_are_the_references(arch):
    """RoPE's inverse frequencies at each published and smoke config's
    head_dim and theta are the reference's bits (its float32 exponent,
    XLA's float32 ``pow``), and the float64 power of that exponent
    rounded once, which every device computes alike: a float32 ``pow``
    gave other bits on the card than on the CPU, and by position 3,000
    those moved llava-next-34b's q.k scores by up to 28 at the
    reference's init (ROADMAP C10)."""
    for cfg in (ref_config(arch), ref_smoke(arch)):
        half = cfg.hd // 2
        want = np.asarray(cfg.rope_theta ** (
            -jnp.arange(0, half, dtype=jnp.float32) / half))
        got = layers.rope_freqs(half, cfg.rope_theta, CPU)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), (arch, cfg.hd)
        e = np.float32(-np.arange(half, dtype=np.float32) / np.float32(half))
        once = (cfg.rope_theta ** e.astype(np.float64)).astype(np.float32)
        assert got.numpy().tobytes() == once.tobytes(), (arch, cfg.hd)
