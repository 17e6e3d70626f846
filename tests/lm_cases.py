"""Shared inputs and runners for the LM tests of the port
(``test_torch_models*.py``, ``test_torch_train_step.py``,
``test_torch_trainer.py``, ``test_torch_serving.py``).

The reference runs compiled with ``xla_allow_excess_precision`` off, so
XLA rounds every bf16 op to bf16 as the program is written (with it on,
the CPU compiler keeps some fused bf16 intermediates in float32, which
moves the reference's own smoke logits by up to 0.5 % of their largest
between its compiled and its op-by-op run); the port rounds as written.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models.layers import ParamSpec as RefParamSpec
from repro.models.transformer import LM as RefLM
from repro_torch.models.transformer import LM, params_from_numpy

CPU = torch.device("cpu")
COMPILER_OPTIONS = {"xla_allow_excess_precision": False}


def inputs(cfg, b, s, seed=0):
    """Seeded numpy tokens and the family's extras, as test_models."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = (rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "encdec":
        extras["frames"] = (rng.standard_normal(
            (b, cfg.n_frames, cfg.d_model)) * 0.1).astype(np.float32)
    return tokens, extras


def batch_np(cfg, b, s, seed=0):
    """Tokens, extras and labels (taken as given, no shift; one masked)."""
    tokens, extras = inputs(cfg, b, s, seed)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, -1] = -1
    return {"tokens": tokens, "labels": labels, **extras}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def leaves(tree, path=""):
    """(dotted path, leaf) in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}.{k}" if path else k)
    else:
        yield path, tree


def with_dtype(cfg, dtype: str):
    return dataclasses.replace(cfg, compute_dtype=dtype)


@functools.lru_cache(maxsize=None)
def ref_init(cfg, seed: int):
    """The reference's own ``lm.init`` parameters, as numpy."""
    params = RefLM(cfg).init(jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def smoke_params(arch: str, seed: int = 0):
    return ref_init(ref_smoke(arch), seed)


def spec_params(cfg, seed: int):
    """Parameters drawn with numpy from the reference's own ParamSpecs
    (its shapes, inits and scales), without a jax.random compile."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        scale = spec.scale if spec.scale is not None else \
            1.0 / np.sqrt(max(1, spec.shape[0]))
        return (rng.standard_normal(spec.shape) * scale).astype(np.float32)
    return jax.tree.map(draw, RefLM(cfg).param_specs(),
                        is_leaf=lambda x: isinstance(x, RefParamSpec))


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with COMPILER_OPTIONS."""
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILER_OPTIONS)


def ref_forward(cfg, params, tokens, extras):
    """The reference's logits and aux (numpy, float32)."""
    lm = RefLM(cfg)
    args = (to_jax(params), jnp.asarray(tokens), to_jax(extras))
    logits, aux = compiled(lambda p, t, e: lm.forward(p, t, extras=e),
                           *args)(*args)
    return np.asarray(logits, np.float32), float(aux)


def port_lm(cfg, params, device=CPU):
    lm = LM(cfg, device=device)
    lm.load_param_tree(params_from_numpy(params, device))
    return lm


def port_forward(cfg, params, tokens, extras, device=CPU):
    lm = port_lm(cfg, params, device)
    with torch.no_grad():
        logits, aux = lm(torch.from_numpy(tokens).to(device),
                         {k: torch.from_numpy(v).to(device)
                          for k, v in extras.items()})
    return logits.float().cpu().numpy(), float(aux)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())
