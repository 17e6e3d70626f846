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
and no cast after), :func:`dot` gives the float32 sum of exact
products: a bf16 x bf16 product is exact in float32. On the card
(plain CUDA tensors in bf16) that is one bf16 tensor-core GEMM with a
float32 result on the operands as they are (``torch.mm``/``bmm`` with
``out_dtype``; :class:`_BF16F32Dot`), which saves the bf16 operands for
the backward. The backward follows the reference's transpose rule
(``jax/_src/lax/lax.py`` ``_dot_general_transpose_lhs``/``_rhs``):
the float32 cotangent times the operand, rounded to the operand's dtype
once. Rounding the cotangent to bf16 before the product would lose
precision, so it is split exactly into three bf16 pieces, hi + mid + lo
(``kernels.bf16split``, G1), and each gradient is one bf16 GEMM of the
pieces against the saved operand, accumulated in float32 over all three
pieces and the whole contraction. On the CPU, and for DTensors, the
product multiplies float32 copies of the operands. Both routes sum the
same exact products in float32; they differ in the order and the
accumulation of the sums, and the tensor cores' land further from the
exact sum than the copies' FMA chains (norm-wise, against float64,
about 2e-6 against 4e-7 in stablelm-1.6b's MLP and head). Where the
reference casts the float32 result back to the compute dtype, the
product runs in that dtype, whose kernels also accumulate in float32.

:func:`wcast` and the ``sharding.constrain`` calls stand where the
reference's stand: inside ``sharding.use_rules`` they pin a DTensor's
layout on the mesh; anywhere else (every path on one card) they return
their input, so the plain forward is the one without them.
:func:`axes_tree` and :func:`shapes_tree` give a spec tree's logical
axes and its ``meta`` tensors (the reference's ``ShapeDtypeStruct``s).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from .. import sharding
from ..kernels import bf16split
from . import probe

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
    docstring). Under a traced step each ``f32`` product of the forward
    is counted, and whether it took the tensor cores
    (``StepProbe.count_dot``)."""
    b = sharding.cast(b, a.dtype)
    if not f32:
        return sharding.einsum(eq, a, b)
    plan = _bmm_plan(eq, tuple(a.shape), tuple(b.shape)) \
        if _tensor_cores(a, b) else None
    if probe.ACTIVE is not None:
        probe.ACTIVE.count_dot(plan is not None)
    if plan is not None:
        return _BF16F32Dot.apply(a, b, plan)
    return sharding.einsum(eq, a.float(), b.float())


_PLAIN = (torch.Tensor, torch.nn.Parameter)
#: the cotangent's pieces a backward product takes at once, in bytes;
#: past it the products run over column blocks of the cotangent (each
#: block costs four launches; stablelm-1.6b's head takes three). Whole
#: pieces leave the benchmark cells' peaks as they are, but put
#: recurrentgemma-2b's 256,000-word head (12.6 GB of pieces) out of an
#: 80 GB card
SPLIT_BLOCK_BYTES = 2 * 2 ** 30


def _tensor_cores(a, b) -> bool:
    """Whether a float32-result :func:`dot` takes :class:`_BF16F32Dot`:
    plain (not DTensor) CUDA tensors in bf16. A float32 operand keeps the
    float32 product, the CPU keeps it to stay the reference's bit for
    bit, and a sharded step keeps it too (the dry-run plans count its
    collectives)."""
    return type(a) in _PLAIN and type(b) in _PLAIN and a.is_cuda and \
        a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16


@dataclasses.dataclass(frozen=True)
class _Plan:
    """``einsum(eq, a, b)`` as one product ``A (G, M, K) @ B (G, K, N)``
    (no G where no label is shared by both operands and the output):
    each operand permuted (None: as it is) and reshaped, the (G, M, N)
    result reshaped to (batch, a's free, b's free) and permuted to the
    output's labels."""
    perm_a: tuple | None
    perm_b: tuple | None
    shape_a: tuple        # a permuted, then A
    shape_b: tuple
    canon_a: tuple
    canon_b: tuple
    canon_c: tuple        # (G, M, N) or (M, N)
    shape_c: tuple        # the result before its permutation
    perm_c: tuple | None

    def operands(self, a, b) -> tuple:
        a = a if self.perm_a is None else a.permute(self.perm_a)
        b = b if self.perm_b is None else b.permute(self.perm_b)
        return a.reshape(self.canon_a), b.reshape(self.canon_b)

    def result(self, c):
        c = c.reshape(self.shape_c)
        return c if self.perm_c is None else c.permute(self.perm_c)

    def cotangent(self, g):
        if self.perm_c is not None:
            g = g.permute(_inverse(self.perm_c))
        return g.reshape(self.canon_c)

    def grads(self, da, db) -> tuple:
        if da is not None:
            da = da.reshape(self.shape_a)
            if self.perm_a is not None:
                da = da.permute(_inverse(self.perm_a))
        if db is not None:
            db = db.reshape(self.shape_b)
            if self.perm_b is not None:
                db = db.permute(_inverse(self.perm_b))
        return da, db


def _inverse(perm: tuple) -> tuple:
    return tuple(sorted(range(len(perm)), key=perm.__getitem__))


@functools.lru_cache(maxsize=512)
def _bmm_plan(eq: str, sa: tuple, sb: tuple) -> _Plan | None:
    """The :class:`_Plan` of ``einsum(eq)`` on operands of shapes ``sa``
    and ``sb``; None where it is no single product: a label repeated in
    a term, summed in one operand alone, or of two sizes."""
    lhs, out = eq.replace(" ", "").split("->")
    ta, tb = lhs.split(",")
    n_ell = max(len(sa) - len(ta.replace("...", "")),
                len(sb) - len(tb.replace("...", "")), 0)
    la = sharding._labels(ta, len(sa), n_ell)
    lb = sharding._labels(tb, len(sb), n_ell)
    lo = sharding._labels(out, len(out.replace("...", "")) + n_ell, n_ell)
    if any(len(set(t)) != len(t) for t in (la, lb, lo)):
        return None
    size: dict = {}
    for label, n in zip(la + lb, sa + sb):
        if size.setdefault(label, n) != n:
            return None
    batch = [x for x in lo if x in la and x in lb]
    free_a = [x for x in la if x in lo and x not in lb]
    free_b = [x for x in lb if x in lo and x not in la]
    con = [x for x in la if x in lb and x not in lo]
    if sorted(la) != sorted(batch + free_a + con) or \
            sorted(lb) != sorted(batch + con + free_b) or \
            sorted(lo) != sorted(batch + free_a + free_b):
        return None

    def perm(order, labels):
        p = tuple(labels.index(x) for x in order)
        return None if p == tuple(range(len(p))) else p

    def n_of(labels):
        return math.prod(size[x] for x in labels)

    g = (n_of(batch),) if batch else ()
    m, k, n = n_of(free_a), n_of(con), n_of(free_b)
    canon = batch + free_a + free_b
    return _Plan(
        perm_a=perm(batch + free_a + con, la),
        perm_b=perm(batch + con + free_b, lb),
        shape_a=tuple(size[x] for x in batch + free_a + con),
        shape_b=tuple(size[x] for x in batch + con + free_b),
        canon_a=(*g, m, k), canon_b=(*g, k, n), canon_c=(*g, m, n),
        shape_c=tuple(size[x] for x in canon), perm_c=perm(lo, canon))


def _gemm(x, y, acc=None, out=None):
    """``acc + x @ y`` (``acc`` None: 0) in float32 of bf16 ``x``, ``y``,
    into ``out`` if given: on the card one tensor-core GEMM with a
    float32 result (float32 accumulation, ``acc`` added in its
    epilogue); on the CPU, the plain version, a float32 product of
    float32 copies."""
    if not x.is_cuda:
        r = torch.matmul(x.float(), y.float())
        r = r if acc is None else acc + r
        return r if out is None else out.copy_(r)
    f32 = torch.float32
    if acc is not None:
        return (torch.baddbmm if x.ndim == 3 else torch.addmm)(
            acc, x, y, out_dtype=f32)
    mm = torch.bmm if x.ndim == 3 else torch.mm
    if out is None:
        return mm(x, y, out_dtype=f32)
    if out.is_contiguous():
        return mm(x, y, out_dtype=f32, out=out)
    return out.copy_(mm(x, y, out_dtype=f32))


def _backward_products(g, a, b, need_a: bool, need_b: bool) -> tuple:
    """(dA, dB) = (g Bᵀ, Aᵀ g), each rounded once to its operand's dtype
    (None where not needed), of the float32 cotangent g (…, M, N) and
    the bf16 operands a (…, M, K) and b (…, K, N): g's exact pieces
    (``bf16split``, (rows, 3, w)) against the operand, one product over
    all three pieces, in column blocks of g whose pieces take at most
    :data:`SPLIT_BLOCK_BYTES` (multiples of 64 columns). dA multiplies
    the pieces side by side, (…, M, 3w), by bᵀ's block stacked thrice,
    (…, 3w, K), adding block to block in the GEMM's float32 epilogue;
    dBᵀ's rows of the block are the pieces row by row, (…, 3M, w)ᵀ,
    times a with each row thrice, (…, 3M, K)."""
    lead, (m, n) = g.shape[:-2], g.shape[-2:]
    k = a.shape[-1]
    rows = g.numel() // max(n, 1)
    width = n if 6 * rows * n <= SPLIT_BLOCK_BYTES else \
        max(64, SPLIT_BLOCK_BYTES // (6 * rows) // 64 * 64)
    da = dbt = None
    if need_b:
        a3 = a.unsqueeze(-2).expand(*a.shape[:-1], 3, k).reshape(
            *lead, 3 * m, k)
        dbt = torch.empty((*lead, n, k), dtype=torch.float32,
                          device=g.device)
    for n0 in range(0, n, width):
        w = min(width, n - n0)
        gc, bc, dc = (g, b, dbt) if w == n else (
            g[..., n0:n0 + w], b[..., n0:n0 + w],
            dbt[..., n0:n0 + w, :] if need_b else None)
        p = bf16split.split(gc.reshape(rows, w))
        if need_a:
            bt = bc.mT
            da = _gemm(p.view(*lead, m, 3 * w),
                       torch.cat((bt, bt, bt), dim=-2), da)
        if need_b:
            _gemm(p.view(*lead, 3 * m, w).mT, a3, out=dc)
    return (da.to(a.dtype) if need_a else None,
            dbt.mT.to(b.dtype) if need_b else None)


class _BF16F32Dot(torch.autograd.Function):
    """A float32-result product of bf16 operands on the tensor cores
    (the module docstring): forward one GEMM with a float32 result,
    backward the exact three-piece split of the cotangent and one GEMM
    per gradient, each gradient rounded to bf16 once. Saves the bf16
    operands. On CPU tensors the GEMMs run on float32 copies (the plain
    version, for the tests)."""

    @staticmethod
    def forward(ctx, a, b, plan):
        x, y = plan.operands(a, b)
        ctx.save_for_backward(x, y)
        ctx.plan = plan
        return plan.result(_gemm(x, y))

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        plan = ctx.plan
        da, db = _backward_products(plan.cotangent(g), x, y,
                                    *ctx.needs_input_grad[:2])
        return (*plan.grads(da, db), None)


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
