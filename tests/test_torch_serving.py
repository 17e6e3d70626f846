"""LM serving in the port (``repro_torch.models.serving``, the decode
branches of ``attention``, ``ssm`` and ``rglru``, ``launch.serve``).

For every arch: prefill + decode against the port's own full forward
(``tests/test_models.py::test_decode_matches_forward``'s contract, at
the configs' bf16 compute), and against the reference's prefill and
decode on the same parameters (numpy draws of the reference's
ParamSpecs, crossed with ``params_from_numpy``) at float32 compute.
The allocated cache has the reference's shapes and dtypes; a window's
ring cache wraps; the serve CLI runs with ``--device cpu``.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_cases import (CPU, inputs, leaves, spec_params, to_jax, to_torch,
                      with_dtype)
from repro.configs import ARCHS, get_smoke_config as ref_smoke
from repro.models import serving as ref_serving
from repro.models.transformer import LM as RefLM
from repro_torch.configs import get_smoke_config
from repro_torch.models import serving
from repro_torch.models.transformer import LM, params_from_numpy

#: max |decode - forward| / max |forward logit| (tests/test_models.py:74)
TOL = 2e-2
#: the same at float32, port against reference (test_torch_models' TOL)
TOL_F32 = 5e-4


def _no_drop(cfg):
    """MoE with a no-drop capacity factor: token dropping legitimately
    depends on batch composition (as tests/test_models.py)."""
    if cfg.family == "moe":
        return dataclasses.replace(cfg, capacity_factor=16.0)
    return cfg


def _port_decode(lm, params, tokens, extras, s: int, n: int):
    """Prefill tokens[:, :s], then n teacher-forced decode steps: the
    logits of positions s-1 .. s+n-1, and the cache."""
    tokens = torch.from_numpy(tokens)
    extras = to_torch(extras)
    lg, cache = serving.prefill(lm, params, tokens[:, :s], extras=extras,
                                max_seq=s + n)
    out = [lg]
    for i in range(n):
        lg, cache = serving.decode_step(lm, params, tokens[:, s + i], s + i,
                                        cache)
        out.append(lg)
    return torch.stack(out, 1).numpy(), cache


def _ref_decode(cfg, params, tokens, extras, s: int, n: int):
    lm = RefLM(cfg)
    p = jax.tree.map(jnp.asarray, params)
    lg, cache = ref_serving.prefill(lm, p, jnp.asarray(tokens[:, :s]),
                                    extras=to_jax(extras), max_seq=s + n)
    out = [lg]
    for i in range(n):
        lg, cache = ref_serving.decode_step(
            lm, p, jnp.asarray(tokens[:, s + i]), jnp.int32(s + i), cache)
        out.append(lg)
    return np.asarray(jnp.stack(out, 1)), cache


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill + decode logits == the port's full forward logits (cache
    correctness), within 2e-2 of the largest logit: at bf16 compute the
    decode and the forward round different sums (attention over the
    cache against query chunks, the SSM's recurrent step against its
    chunked scan, the RG-LRU's step against the doubling scan)."""
    cfg = _no_drop(get_smoke_config(arch))
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(1))
    b, s, extra = 2, 12, 3
    tokens, extras = inputs(cfg, b, s + extra, seed=1)
    with torch.no_grad():
        full, _ = lm(torch.from_numpy(tokens), to_torch(extras))
    got, _ = _port_decode(lm, params, tokens, extras, s, extra)
    assert np.isfinite(got).all()
    assert _rel(got, full[:, s - 1:].numpy()) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """The port's prefill and decode logits against the reference's on
    the same parameters at float32 compute (sums in another order:
    within 5e-4 of the largest logit), and the caches they leave,
    leaf for leaf, within the same bound of each leaf's largest."""
    ref_cfg = _no_drop(with_dtype(ref_smoke(arch), "float32"))
    cfg = _no_drop(with_dtype(get_smoke_config(arch), "float32"))
    params = spec_params(ref_cfg, 3)
    tokens, extras = inputs(cfg, 2, 15, seed=2)
    want, ref_cache = _ref_decode(ref_cfg, params, tokens, extras, 12, 3)
    lm = LM(cfg, device=CPU)
    lm.load_param_tree(params_from_numpy(params, CPU))
    got, cache = _port_decode(lm, lm.param_tree(), tokens, extras, 12, 3)
    assert _rel(got, want) < TOL_F32
    want_c = dict(leaves(jax.tree.map(np.asarray, ref_cache)))
    got_c = dict(leaves(cache))
    assert sorted(got_c) == sorted(want_c)
    for name, w in want_c.items():
        g = got_c[name].float().numpy()
        assert g.shape == w.shape, name
        assert _rel(g, w.astype(np.float32)) < TOL_F32, name


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    """``cache_specs`` allocates zeros of the reference's shapes and
    dtypes, at the configs' bf16 compute, with a window's capacity."""
    cfg = get_smoke_config(arch)
    want, _ = ref_serving.cache_specs(RefLM(ref_smoke(arch)), 3, 20)
    got = serving.cache_specs(LM(cfg, device=CPU), 3, 20)
    want = dict(leaves(jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                                    want,
                                    is_leaf=lambda x: hasattr(x, "shape"))))
    got = dict(leaves(got))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == \
            want[name], name
        assert not t.any(), name


@pytest.mark.parametrize("prompt,steps", [(4, 8), (7, 6), (5, 5)])
def test_window_ring_cache(prompt, steps):
    """A window of 5 on stablelm's smoke config (dense attention, no
    other state): prefill pads (prompt < 5), fills exactly (= 5) or
    keeps the last 5 rolled to slot pos % 5 (> 5), and decode wraps the
    ring. Against the port's forward (bf16, 2e-2) and, at float32,
    against the reference's ring (5e-4)."""
    cfg = dataclasses.replace(get_smoke_config("stablelm_1_6b"), window=5)
    ref_cfg = dataclasses.replace(ref_smoke("stablelm_1_6b"), window=5)
    params = spec_params(ref_cfg, 4)
    tokens, _ = inputs(cfg, 2, prompt + steps, seed=3)
    assert serving.cache_capacity(cfg, prompt + steps) == 5
    lm = LM(cfg, device=CPU)
    lm.load_param_tree(params_from_numpy(params, CPU))
    with torch.no_grad():
        full, _ = lm(torch.from_numpy(tokens))
    got, cache = _port_decode(lm, lm.param_tree(), tokens, {}, prompt, steps)
    assert cache["k"].shape[2] == 5
    assert _rel(got, full[:, prompt - 1:].numpy()) < TOL
    lm32 = LM(with_dtype(cfg, "float32"), device=CPU)
    lm32.load_param_tree(params_from_numpy(params, CPU))
    got32, _ = _port_decode(lm32, lm32.param_tree(), tokens, {}, prompt,
                            steps)
    want32, _ = _ref_decode(with_dtype(ref_cfg, "float32"), params, tokens,
                            {}, prompt, steps)
    assert _rel(got32, want32) < TOL_F32


def test_seed_attn_cache_places_the_ring():
    """``_seed_attn_cache`` places position p at slot p % cap, as the
    reference's: for s > cap the last cap positions, rolled."""
    k = np.arange(2 * 7 * 1 * 2, dtype=np.float32).reshape(2, 7, 1, 2)
    for cap in (3, 5, 7, 9):
        got = serving._seed_attn_cache(torch.from_numpy(k),
                                       torch.from_numpy(-k), cap, 5)
        want = ref_serving._seed_attn_cache(jnp.asarray(k), jnp.asarray(-k),
                                            cap, 5)
        for g, w in zip(got, want):
            assert g.numpy().tobytes() == np.asarray(w).tobytes(), cap


def test_decode_past_capacity_raises():
    """Without a window, a position past the cache raises; the
    reference's ``dynamic_update_slice`` clamps it onto the last slot."""
    cfg = get_smoke_config("stablelm_1_6b")
    lm = LM(cfg, device=CPU)
    params = lm.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    _, cache = serving.prefill(lm, params, tokens, max_seq=4)
    with pytest.raises(IndexError):
        serving.decode_step(lm, params, tokens[:, 0], 4, cache)


def test_serve_cli_smoke():
    env = {**os.environ,
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mamba2_1_3b", "--smoke", "--batch", "2", "--prompt-len", "8",
         "--tokens", "4", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "decode:" in out.stdout
    assert "sample token ids:" in out.stdout


def test_serve_cli_means_the_gpu():
    """Without ``--device`` the serve CLI runs on cuda, so on a machine
    without a card it raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2_1_3b", "--smoke", "--batch", "1",
                    "--prompt-len", "4", "--tokens", "2"])


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mamba2_1_3b",
                                  "recurrentgemma_2b", "granite_moe_1b_a400m"])
def test_decode_matches_forward_on_cuda(arch, cuda_device):
    """test_decode_matches_forward on the card at float32 compute (TF32
    off), within 5e-4 of the largest logit, with the window's ring
    wrapping for recurrentgemma (window 8, 12 + 3). At bf16 the card's
    decode and forward run other GEMM kernels than each other, and at
    the reference's init one bf16 rounding of the embeddings moves these
    models' logits by a large share of the largest, so the bf16 case is
    held on the CPU (test_decode_matches_forward) and, on the card, in
    chip_smoke.py's phase 11 with every layer of prefill and decode_step
    run on the forward's own inputs."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = _no_drop(with_dtype(get_smoke_config(arch), "float32"))
    lm = LM(cfg, device=cuda_device)
    params = lm.init(torch.Generator(device=cuda_device).manual_seed(1))
    tokens, _ = inputs(cfg, 2, 15, seed=1)
    t = torch.from_numpy(tokens).to(cuda_device)
    with torch.no_grad():
        full, _ = lm(t)
    lg, cache = serving.prefill(lm, params, t[:, :12], max_seq=15)
    out = [lg]
    for i in range(3):
        lg, cache = serving.decode_step(lm, params, t[:, 12 + i], 12 + i,
                                        cache)
        out.append(lg)
    got = torch.stack(out, 1).cpu().numpy()
    assert np.isfinite(got).all()
    assert _rel(got, full[:, 11:].cpu().numpy()) < TOL_F32
