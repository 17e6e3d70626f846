"""Shared layers: norms, MLPs, embeddings, RoPE, parameter specs.

Parameters are plain nested dicts built from ``ParamSpec`` tables, with
the JAX package's keys, shapes and float32 leaves, so that a tree moves
between the two packages leaf for leaf (``models.transformer``'s
``params_from_numpy``/``params_to_numpy``).

Init is the reference's: a default-scaled leaf is drawn at
1/sqrt(shape[0]), from a ``torch.Generator`` (other numbers than
``jax.random``'s, the same distribution).

Numerics follow the reference einsum by einsum. Where it asks for a
float32 result of compute-dtype inputs (``preferred_element_type=f32``
and no cast after), :func:`dot` multiplies float32 copies of the
operands: bf16 products are exact in float32, so the result is the
reference's up to the order of the sums. Where the reference casts the
float32 result back to the compute dtype, the product runs in that
dtype, whose kernels also accumulate in float32.

:func:`wcast` and the ``sharding.constrain`` calls stand where the
reference's stand: inside ``sharding.use_rules`` they pin a DTensor's
layout on the mesh; anywhere else (every path on one card) they return
their input, so the plain forward is the one without them.
:func:`axes_tree` and :func:`shapes_tree` give a spec tree's logical
axes and its ``meta`` tensors (the reference's ``ShapeDtypeStruct``s).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import sharding

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple           # logical axis names, len == len(shape)
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # default: 1/sqrt(shape[0])

    def initializer(self, generator, dtype, device):
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        scale = self.scale if self.scale is not None else 1.0 / math.sqrt(
            max(1, self.shape[0]))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dtype)


def map_specs(fn, specs, path: str = ""):
    """``specs`` with every ``ParamSpec`` replaced by ``fn(path, spec)``;
    ``path`` is the leaf's dotted name. Keys are walked sorted, as
    ``jax.tree_util`` walks a dict."""
    if isinstance(specs, ParamSpec):
        return fn(path, specs)
    return {k: map_specs(fn, specs[k], f"{path}.{k}" if path else k)
            for k in sorted(specs)}


def axes_tree(specs):
    return map_specs(lambda _, s: s.axes, specs)


def shapes_tree(specs, dtype):
    """``specs`` as ``meta`` tensors of ``dtype``: shapes, no storage."""
    return map_specs(lambda _, s: torch.empty(s.shape, dtype=dtype,
                                              device="meta"), specs)


def wcast(w, dtype, *axes):
    """Cast a sharded param to compute dtype, pinning the sharded layout.

    Without the constraint the cast copy may be gathered whole; pinning
    it to the parameter's own sharding makes the FSDP gather move the
    compute dtype's bytes (the reference's §Perf i3)."""
    return sharding.constrain(sharding.cast(w, dtype), *axes)


def pin_out(y):
    """A block's output (a product summed over a model-sharded dim) pinned
    to ("batch", ..., "embed"), its partial sums reduced there by
    explicit collectives (``sharding.reduce_by``, whose backward is the
    port's own). DTensor keeps such a partial sum partial until an op
    needs it whole, so the residual stream would carry each model rank's
    partial through the next norm into the next products, which then run
    whole on every rank; GSPMD reduces at the product. A site of the port
    only (the reference needs none)."""
    axes = ("batch", *(None,) * (y.ndim - 2), "embed")
    return sharding.constrain(sharding.reduce_by(y, *axes), *axes)


def dot(eq: str, a, b, *, f32: bool):
    """``einsum(eq, a, b)`` with ``b`` cast to ``a``'s dtype; with ``f32``
    a float32 result, else one in ``a``'s dtype (see the module
    docstring)."""
    b = sharding.cast(b, a.dtype)
    if f32:
        return sharding.einsum(eq, a.float(), b.float())
    return sharding.einsum(eq, a, b)


def gelu(x):
    """``jax.nn.gelu``'s default form: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class _Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid``: the forward as it lowers, ``1 / (1 + exp(-x))``
    with each op rounded to x's dtype; the derivative ``s (1 - s)`` of
    ``lax.logistic`` (autograd through the lowered form would give
    0 · inf = NaN where exp(-x) overflows)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x):
    return _Sigmoid.apply(x)


def silu(x):
    """``jax.nn.silu`` as it lowers: ``x * sigmoid(x)``, each op rounded
    to x's dtype (``F.silu`` rounds once, which differs in bf16)."""
    return x * sigmoid(x)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------------------ norms

def rmsnorm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def norm_spec(cfg) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones"),
                "bias": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), "zeros")}


def apply_norm(p, x, cfg):
    # the branch's gradient reduced before it meets the skip's
    x = sharding.grad_at(x)
    eps = {} if cfg.norm_eps is None else {"eps": cfg.norm_eps}
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], **eps)
    return rmsnorm(x, p["scale"], **eps)


def residual(x, y, cfg):
    """The residual stream ``x`` plus a branch's output ``y``, scaled by
    ``cfg.residual_multiplier`` where that is set (Granite)."""
    m = cfg.residual_multiplier
    return x + y if m == 1.0 else x + y * m


# ------------------------------------------------------------------- MLPs

def mlp_spec(cfg, d_in=None, d_ff=None) -> dict:
    d = d_in or cfg.d_model
    f = d_ff or cfg.d_ff
    gated = cfg.mlp_act in ("swiglu", "geglu")
    spec = {"wi": ParamSpec((d, f), ("fsdp", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "fsdp"))}
    if gated:
        spec["wg"] = ParamSpec((d, f), ("fsdp", "mlp"))
    return spec


def mlp(p, x, cfg):
    h_axes = ("batch", *(None,) * (x.ndim - 2), "mlp")
    # where d_model is split and the tokens are not (a batch of one),
    # the products are partial sums, reduced before the nonlinearity
    h = sharding.reduce_by(dot("...d,df->...f", x, wcast(
        p["wi"], x.dtype, "fsdp", "mlp"), f32=True), *h_axes)
    if cfg.mlp_act in ("swiglu", "geglu"):
        g = sharding.reduce_by(dot("...d,df->...f", x, wcast(
            p["wg"], x.dtype, "fsdp", "mlp"), f32=True), *h_axes)
        h = (silu(g) if cfg.mlp_act == "swiglu" else gelu(g)) * h
    elif cfg.mlp_act == "relu2":          # nemotron squared-ReLU
        h = torch.square(F.relu(h))
    else:
        h = gelu(h)
    h = sharding.constrain(h.to(x.dtype), *h_axes)
    # the output projection's partial sums cross the model ranks in the
    # compute dtype (the reference's §Perf i6)
    return pin_out(dot("...f,fd->...d", h, wcast(p["wo"], x.dtype, "mlp",
                                                  "fsdp"), f32=False))


# ------------------------------------------------------------- embeddings

def embed_spec(cfg) -> dict:
    spec = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model),
                             ("vocab", "embed"), scale=1.0)}
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                    ("embed", "vocab"))
    return spec


def _lookup(tokens, table):
    """``F.embedding(tokens, table)``. Under ``sharding.use_rules`` with
    DTensors, each rank looks up the rows its shard of the table holds
    and zeroes the rest (``local_map``): the result is a plain partial
    sum over the mesh dims that split the vocabulary. (DTensor's own
    embedding rule gives a masked partial whose backward cannot take
    the partial-sum gradient that a MoE or tied head sends back.)"""
    from torch.distributed.tensor import DTensor, Partial, Shard
    ctx = sharding.active()
    if ctx is None or not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    cut = [m for m, q in enumerate(table.placements) if q == Shard(0)]
    rows = table.to_local().shape[0]

    def fn(ids, local):
        idx = ids - sharding.shard_start(mesh, cut, rows)
        hit = (idx >= 0) & (idx < rows)
        out = F.embedding(torch.where(hit, idx, 0), local)
        return out * hit[..., None].to(out.dtype)
    out_place = tuple(Partial() if m in cut else q
                      for m, q in enumerate(tokens.placements))
    return sharding.local_call(fn, (tokens, table), (tokens.placements,
                               table.placements), (out_place,), mesh)


def embed(p, tokens, cfg):
    # F.embedding's backward on the card sums each row's duplicates in a
    # fixed order (no float atomics)
    x = _lookup(tokens.long(), p["tok"].to(dtype_of(cfg.compute_dtype)))
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return sharding.constrain(x, "batch", "seq", "embed")


def unembed(p, x, cfg):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    logits = dot("...d,dv->...v", x, w, f32=True)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return sharding.constrain(
        logits, *("batch",) + (None,) * (x.ndim - 2) + ("vocab",))


# ------------------------------------------------------------------- RoPE

def rope_freqs(half: int, theta: float, device):
    """The (half,) float32 inverse frequencies theta^(-i / half): the
    exponent rounded to float32 as the reference rounds it, the power
    taken in float64 and rounded once, so that they are the same bits
    on every device and the reference's (XLA's float32 ``pow`` on the
    CPU). A float32 ``pow`` rounds differently on the card and the CPU
    (one ulp at 6 of head_dim 128's 64 frequencies, an H100 80GB HBM3
    at 700 W against the CPU): by position 3,000 an angle moves by 3e-4
    rad, which at the reference's init moved llava-next-34b's q.k
    scores by up to 28 (ROADMAP C10)."""
    e = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return (theta ** e.double()).float()


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int. Rotates halves."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(half, theta, x.device)
    angles = positions[..., None].float() * freqs       # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
