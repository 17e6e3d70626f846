"""input_specs(): ``meta`` stand-ins for every (arch x shape) cell.

No device allocation anywhere: an ``LM(cfg, device="meta")`` gives the
parameters, the train state and the decode cache as ``meta`` tensors
(shapes and dtypes, no storage), which the dry-run places on its mesh
and runs the step over. Modality frontends are stubs per the
assignment: [audio] supplies frame embeddings (B, n_frames, d_model);
[vlm] supplies patch embeddings (B, n_patches, d_model).

The port's ``decode_step`` takes ``pos`` as a Python int. ``input_specs``
passes it as an int32 0-d CPU tensor holding ``seq - 1``, the last
position the cache holds (it is a 4-byte argument, as the reference's
traced scalar), and the decode callable reads it with ``int()``. A
step's work is the same at every position: it attends over the whole
cache under a mask.
"""
from __future__ import annotations

import torch

from ..configs import SHAPES, get_config
from ..models import layers, serving
from ..models.transformer import LM
from ..train import step as step_lib


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _extras_specs(cfg, batch: int):
    cdt = layers.dtype_of(cfg.compute_dtype)
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = _meta((batch, cfg.n_patches, cfg.d_model), cdt)
    if cfg.family == "encdec":
        out["frames"] = _meta((batch, cfg.n_frames, cfg.d_model), cdt)
    return out


def _extras_axes(cfg):
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = ("batch", "patches", "embed")
    if cfg.family == "encdec":
        out["frames"] = ("batch", "frames", "embed")
    return out


def cell_shape(shape: str, batch: int | None = None,
               seq: int | None = None) -> dict:
    """``SHAPES[shape]`` with its batch or sequence replaced."""
    cell = dict(SHAPES[shape])
    if batch is not None:
        cell["batch"] = batch
    if seq is not None:
        cell["seq"] = seq
    return cell


def input_specs(arch: str, shape: str, cfg=None, *, batch=None, seq=None):
    """Abstract inputs for one dry-run cell.

    Returns (kind, kwargs, axes) where kwargs feed :func:`build_callable`'s
    function and ``axes`` mirrors kwargs with logical-axis tuples.
    """
    cfg = cfg or get_config(arch)
    lm = LM(cfg, device="meta")
    cell = cell_shape(shape, batch, seq)
    b, s = cell["batch"], cell["seq"]
    kind = cell["kind"]

    if kind == "train":
        state = step_lib.abstract_state(lm, "meta")
        batch_ = {"tokens": _meta((b, s), torch.int32),
                  "labels": _meta((b, s), torch.int32),
                  **_extras_specs(cfg, b)}
        batch_axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                      **_extras_axes(cfg)}
        return kind, {"state": state, "batch": batch_}, \
            {"state": step_lib.state_axes(lm), "batch": batch_axes}

    params = lm.abstract_params()
    p_axes = lm.param_axes()
    if kind == "prefill":
        kwargs = {"params": params, "tokens": _meta((b, s), torch.int32),
                  **_extras_specs(cfg, b)}
        axes = {"params": p_axes, "tokens": ("batch", "seq"),
                **_extras_axes(cfg)}
        return kind, kwargs, axes

    # decode: one new token against a seq_len-deep cache
    kwargs = {"params": params, "token": _meta((b,), torch.int32),
              "pos": torch.tensor(s - 1, dtype=torch.int32),
              "cache": serving.cache_specs(lm, b, s)}
    axes = {"params": p_axes, "token": ("batch",), "pos": (),
            "cache": serving.cache_axes(lm)}
    return kind, kwargs, axes


def build_callable(arch: str, shape: str, cfg=None, *, seq=None):
    """The function each cell runs: train_step / prefill / decode_step
    (of a ``meta`` LM; it runs on whatever tensors it is given)."""
    from ..train import optim
    cfg = cfg or get_config(arch)
    lm = LM(cfg, device="meta")
    cell = cell_shape(shape, seq=seq)
    kind = cell["kind"]

    if kind == "train":
        return step_lib.make_train_step(lm, optim.OptConfig())

    if kind == "prefill":
        def prefill_fn(params, tokens, **extras):
            return serving.prefill(lm, params, tokens, extras=extras,
                                   max_seq=cell["seq"])
        return prefill_fn

    def decode_fn(params, token, pos, cache):
        return serving.decode_step(lm, params, token, int(pos), cache)
    return decode_fn
