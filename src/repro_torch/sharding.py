"""Logical-axis sharding rules (MaxText-style) for all parallelism forms.

Model code annotates tensors with *logical* axis names; a rules table maps
them to mesh axes. Resolution is shape-aware: a logical->mesh mapping is
dropped (replicated) when the dimension is not divisible by the mesh axes'
product — e.g. 8 KV heads on a 16-way 'model' axis fall back to replicated
KV (correct GQA TP semantics), without per-arch special cases.

The port of the JAX package's ``sharding`` module onto DTensor. A spec
is a plain tuple, one part per tensor dim: ``None``, a mesh axis name,
or a tuple of names (the reference's ``PartitionSpec``, part for part).
:func:`placements` turns it into DTensor placements on a
``DeviceMesh``; :func:`distribute` places a tensor by its logical axes
(the reference's ``named_sharding``), :func:`tree_placements` a tree
(``tree_shardings``), and :func:`constrain` is ``with_sharding_constraint``:
``x.redistribute`` to the resolved placements, only inside
:func:`use_rules` and only for a DTensor.

Where DTensor's own rules cannot carry the model code, or carry it only
at the global shape, the code calls a function here that works on the
local shards (mostly one op per rank, :func:`local_call`, ``local_map``
with the gradients placed right): :func:`einsum`, :func:`along`,
:func:`take`, :func:`logsumexp` and :func:`write_slice`. On plain
tensors each is the plain op.

A dim split over several mesh axes is split in mesh-dim order: plain
``Shard`` placements, the first mesh dim major. A ``PartitionSpec``
splits in the order the spec names the axes, so where that order is not
the mesh's (``fsdp: ("data", "pod")`` on a ("pod", "data", "model")
mesh: nemotron, mixtral and llava) each device holds a piece of the
same shape and bytes as the reference's device, but not the same piece.
DTensor can express the spec's order (``_StridedShard``, a shard order),
but torch 2.13's redistribution planner cannot run it: its min-cost
graph search takes minutes an op on such placements, and its greedy
planner fails on them.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

# Default rules: tuple values are tried jointly (a dim can shard over
# several mesh axes); None = replicated.
DEFAULT_RULES: dict[str, tuple | str | None] = {
    "batch": ("pod", "data"),      # data parallel (pod folds into DP)
    "seq": None,                   # sequence (sharded for SP via override)
    "kv_seq": None,                # decode KV-cache sequence axis
    "embed": None,                 # activation d_model (i6b tried 'data'
                                   # for table ZeRO: memory term regressed
                                   # 132->197 s from d-gathers at lookup)
    "heads": "model",              # tensor parallel attention
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",                # tensor parallel FFN
    "vocab": "model",              # tensor parallel embedding / logits
    "experts": "model",            # expert parallel (block-diagonal)
    "expert_cap": "data",          # expert capacity rides the data axis
    "expert_in": "data",           # expert weight d_model dim (ZeRO)
    "expert_mlp": "model",         # TP inside experts (when E % model != 0)
    "fsdp": "data",                # ZeRO-3 param dim
    "state": "model",              # SSM / LRU state width
    "frames": None,                # encoder stub frames
    "patches": None,
}

_CTX = threading.local()


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``,
    ``mesh.size(i)``) or of any object whose ``.shape`` maps names to
    sizes (the reference's tests pass such a stand-in)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def resolve_spec(shape: tuple, axes: tuple, rules: dict, mesh) -> tuple:
    """Spec (one part per dim) for ``shape`` with logical ``axes`` under
    ``rules``."""
    assert len(shape) == len(axes), f"{shape} vs {axes}"
    sizes = mesh_sizes(mesh)
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, axes):
        if name is None:
            parts.append(None)
            continue
        cand = rules.get(name)
        if cand is None:
            parts.append(None)
            continue
        cand = (cand,) if isinstance(cand, str) else tuple(cand)
        cand = [a for a in cand if a in sizes and a not in used]
        # largest prefix whose product divides the dim
        chosen = []
        prod = 1
        for a in cand:
            if dim % (prod * sizes[a]) == 0:
                chosen.append(a)
                prod *= sizes[a]
        used.update(chosen)
        parts.append(tuple(chosen) if len(chosen) > 1 else (chosen[0] if chosen else None))
    return tuple(parts)


def _spec_axes(part) -> tuple:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on every mesh dim of more than one device that the spec
    puts on tensor dim ``d``, ``Replicate()`` elsewhere (in mesh order:
    module docstring). A split over one device is no split, and DTensor
    will not reshape a dim it holds as sharded, so on a (1, 1) mesh every
    placement is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        for a in _spec_axes(part):
            m = names.index(a)
            if mesh.size(m) > 1:
                out[m] = Shard(d)
    return tuple(out)


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The per-device shape of a tensor of ``shape`` under ``spec``
    (every split divides its dim: :func:`resolve_spec` picks only those)."""
    sizes = mesh_sizes(mesh)
    return tuple(n // math.prod(sizes[a] for a in _spec_axes(p))
                 for n, p in zip(shape, spec))


def distribute(t: torch.Tensor, axes: tuple, rules: dict, mesh):
    """``t`` (the global tensor) as a DTensor on ``mesh`` placed by its
    logical ``axes``. A ``meta`` tensor becomes a meta DTensor of the
    local shape, with no collective (the dry-run's inputs); any other is
    cut locally, each rank keeping its own piece (every rank holds the
    same global tensor, as from the same seed)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    spec = resolve_spec(tuple(t.shape), tuple(axes), rules, mesh)
    place = placements(spec, mesh)
    if t.device.type == "meta":
        local = torch.empty(local_shape(tuple(t.shape), spec, mesh),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, place, src_data_rank=None)


def tree_zeros(shapes_tree, axes_tree, rules: dict, mesh, *, device):
    """Zeros of the shapes and dtypes of ``shapes_tree``'s leaves as
    DTensors placed by their logical axes, each rank allocating only its
    own piece on ``device``."""
    from torch.distributed.tensor import DTensor
    if isinstance(shapes_tree, dict):
        return {k: tree_zeros(v, axes_tree[k], rules, mesh, device=device)
                for k, v in shapes_tree.items()}
    t = shapes_tree
    spec = resolve_spec(tuple(t.shape), tuple(axes_tree), rules, mesh)
    local = torch.zeros(local_shape(tuple(t.shape), spec, mesh),
                        dtype=t.dtype, device=device)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def tree_placements(shapes_tree, axes_tree, rules: dict, mesh):
    """Map matching (tensors, axes) trees to DTensor placements."""
    if isinstance(shapes_tree, dict):
        return {k: tree_placements(v, axes_tree[k], rules, mesh)
                for k, v in shapes_tree.items()}
    return placements(resolve_spec(tuple(shapes_tree.shape),
                                   tuple(axes_tree), rules, mesh), mesh)


def tree_distribute(tree, axes_tree, rules: dict, mesh):
    """:func:`distribute` over matching (tensors, axes) trees."""
    if isinstance(tree, dict):
        return {k: tree_distribute(v, axes_tree[k], rules, mesh)
                for k, v in tree.items()}
    return distribute(tree, axes_tree, rules, mesh)


@contextlib.contextmanager
def use_rules(rules: dict, mesh):
    """Activate rules+mesh for :func:`constrain`. Inside, a plain tensor
    that meets a DTensor (an ``arange`` of positions, a zero aux loss)
    counts as replicated (DTensor's ``implicit_replication``): every
    rank makes the same one."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = getattr(_CTX, "val", None)
    _CTX.val = (dict(rules), mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.val = prev


def active() -> tuple[dict, object] | None:
    return getattr(_CTX, "val", None)


def constrain(x, *axes):
    """with_sharding_constraint by logical axes; no-op outside use_rules
    and for a tensor that is not a DTensor."""
    ctx = active()
    if ctx is None:
        return x
    return constrain_spec(x, resolve_spec(tuple(x.shape), tuple(axes), *ctx))


def constrain_spec(x, spec: tuple):
    """:func:`constrain` to a resolved ``spec`` (mesh axes per dim)."""
    ctx = active()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx[1], placements(spec, ctx[1]))


def local_call(fn, args: tuple, in_place: tuple, out_place: tuple, mesh):
    """``fn(*local args)`` on each rank (``local_map``): the DTensor
    ``args`` redistributed to ``in_place`` first, the outputs DTensors of
    ``out_place``. A replicated input's gradient is a ``Partial`` sum on
    every mesh dim where an output is split or partial (each rank then
    saw another part of the work), and a replica elsewhere."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    split = [any(not isinstance(o[m], Replicate) for o in out_place)
             for m in range(mesh.ndim)]
    grad_place = tuple(
        tuple(Partial() if split[m] and isinstance(q, Replicate) else q
              for m, q in enumerate(ins)) for ins in in_place)
    return local_map(fn, out_placements=out_place, in_placements=in_place,
                     in_grad_placements=grad_place, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def along(fn, args: tuple, dim: int):
    """``fn(*args)``, a scan along ``dim`` that keeps every other dim
    apart; for DTensors, each rank's own ``fn`` with ``dim`` whole
    (gathered first where split) and the first arg's other splits,
    which every arg takes. Torch 2.11's DTensor has no rule for the
    ``flip`` of ``cumsum``'s backward, and its planner fails on the
    ``pad`` of a doubling scan."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    dim %= first.ndim
    place = tuple(Replicate() if q.is_partial() or q == Shard(dim) else q
                  for q in first.placements)
    return local_call(fn, args, (place,) * len(args), (place,),
                      first.device_mesh)


def shard_start(mesh, cut: list, rows: int) -> int:
    """The first index this rank holds of a dim split in mesh-dim order
    over the mesh dims ``cut``, ``rows`` to a shard."""
    coord = mesh.get_coordinate()
    return rows * sum(coord[m] * math.prod(mesh.size(j) for j in cut
                                           if j > m) for m in cut)


def take(x, index):
    """``torch.gather(x, -1, index[..., None])[..., 0]``. For a DTensor
    ``x``, each rank reads from its own shard of the last dim (an index
    outside it reads 0) and the mesh dims that split that dim leave a
    ``Partial`` sum. DTensor's own gather makes its backward's zeros at
    ``x``'s global shape on every rank (a replicated ``new_zeros``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, index[..., None])[..., 0]
    mesh = x.device_mesh
    last = x.ndim - 1
    px = tuple(Replicate() if q.is_partial() else q for q in x.placements)
    cut = [m for m, q in enumerate(px) if q == Shard(last)]
    pi = tuple(Replicate() if m in cut else q for m, q in enumerate(px))
    po = tuple(Partial() if m in cut else q for m, q in enumerate(px))
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)

    def fn(u, i):
        cols = u.shape[-1]
        j = i - shard_start(mesh, cut, cols)
        hit = (j >= 0) & (j < cols)
        v = torch.gather(u, -1, torch.where(hit, j, 0)[..., None])[..., 0]
        return torch.where(hit, v, 0)
    return local_call(fn, (x, index), (px, pi), (po,), mesh)


class _LogSumExp(torch.autograd.Function):
    """ATen's logsumexp over the last dim, op for op, on a DTensor split
    along it: the max and the sum reduced across ranks by ``place``."""

    @staticmethod
    def forward(ctx, x, place):
        mesh = x.device_mesh
        m = x.amax(-1, keepdim=True).redistribute(mesh, place)
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = torch.exp(x - m).sum(-1).redistribute(mesh, place)
        out = s.log() + m[..., 0]
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * (x - out[..., None]).exp(), None


def logsumexp(x):
    """``torch.logsumexp(x, -1)``. For a DTensor, the ranks that split
    the last dim each reduce their own shard, and two small all-reduces
    (the max, the sum) combine them; the gradient is ATen's,
    ``g * exp(x - lse)``. DTensor's own rule gathers the whole last dim
    on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, -1)
    last = x.ndim - 1
    place = tuple(Replicate() if q.is_partial() or q == Shard(last) else q
                  for q in x.placements)
    return _LogSumExp.apply(x, place)


def write_slice(dst, dim: int, start: int, value) -> None:
    """``dst.narrow(dim, start, value.shape[dim]).copy_(value)``, in
    place. For a DTensor ``dst``, each rank writes the part of ``value``
    that falls in its own shard of ``dim`` (DTensor would run the slice
    of a split dim against a gathered copy, and the write would miss the
    shard)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n = value.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(value)
        return
    mesh = dst.device_mesh
    cut = [m for m, q in enumerate(dst.placements) if q == Shard(dim)]
    place = tuple(Replicate() if m in cut or q.is_partial() else q
                  for m, q in enumerate(dst.placements))
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
    value = value.redistribute(mesh, place).to_local()
    local = dst.to_local()
    rows = local.shape[dim]
    first = shard_start(mesh, cut, rows)
    lo, hi = max(start, first), min(start + n, first + rows)
    if lo < hi:
        local.narrow(dim, lo - first, hi - lo).copy_(
            value.narrow(dim, lo - start, hi - lo))


def _labels(term: str, ndim: int, n_ell: int) -> list:
    """One label per dim of an einsum operand; an ellipsis's dims get
    labels of their own, aligned from the right across operands."""
    if "..." not in term:
        return list(term)
    head, tail = term.split("...")
    k = ndim - len(head) - len(tail)
    return list(head) + [f"...{n_ell - k + i}" for i in range(k)] + \
        list(tail)


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; for DTensors, one local einsum per
    rank (``local_map``) after the operands are placed so that it is
    exact: on each mesh dim, a dim of the two operands that bears the
    same label is split alike (a replicated operand is cut locally, a
    clash gathers ``b``'s), a split output label stays split and a
    split contracted label leaves a ``Partial`` sum. DTensor's own
    rule runs an einsum as a ``bmm`` over the batch labels folded into
    one dim: where two folded labels are split over different mesh dims
    (attention's batch and heads) torch 2.11 refuses the fold, and 2.13
    makes it a ``_StridedShard`` whose strategy search takes seconds an
    op."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.einsum(eq, a, b)
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    rep = (Replicate(),) * mesh.ndim
    a, b = (x if isinstance(x, DTensor) else DTensor.from_local(
        x, mesh, rep, run_check=False) for x in (a, b))
    lhs, out_term = eq.replace(" ", "").split("->")
    ta, tb = lhs.split(",")
    n_ell = max(a.ndim - len(ta.replace("...", "")),
                b.ndim - len(tb.replace("...", "")), 0)
    la, lb = _labels(ta, a.ndim, n_ell), _labels(tb, b.ndim, n_ell)
    lo = _labels(out_term, n_ell + len(out_term.replace("...", "")), n_ell)
    pa = [Replicate() if q.is_partial() else q for q in a.placements]
    pb = [Replicate() if q.is_partial() else q for q in b.placements]
    po = []
    for m in range(mesh.ndim):
        x = la[pa[m].dim] if pa[m].is_shard() else None
        y = lb[pb[m].dim] if pb[m].is_shard() else None
        if x is not None and y is not None and x != y:
            pb[m], y = Replicate(), None
        lab = x if x is not None else y
        if lab is None:
            po.append(Replicate())
            continue
        if lab in la:
            pa[m] = Shard(la.index(lab))
        if lab in lb:
            pb[m] = Shard(lb.index(lab))
        po.append(Shard(lo.index(lab)) if lab in lo else Partial())
    return local_call(lambda u, v: torch.einsum(eq, u, v), (a, b),
                      (tuple(pa), tuple(pb)), (tuple(po),), mesh)


def splits(n: int, name: str) -> bool:
    """Whether the active rules shard a dim of size ``n`` with logical
    axis ``name`` (False outside :func:`use_rules`)."""
    ctx = active()
    return ctx is not None and resolve_spec((n,), (name,), *ctx)[0] is not None


def merge_rules(*overrides) -> dict:
    out = dict(DEFAULT_RULES)
    for o in overrides:
        if o:
            out.update(o)
    return out
