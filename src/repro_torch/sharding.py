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
:func:`take`, :func:`logsumexp`, :func:`write_slice` and
:func:`per_rank`. On plain tensors each is the plain op.

Where DTensor would be left to choose how operands of different
placements meet, the choice can differ between torch versions (torch
2.11 reduced RG-LRU's gate products to whole rows where 2.13 split
their batch, and its scan ran at 16 times the width a rank holds), so
the port fixes it: :func:`layout` gives the placements the rules name,
:func:`per_rank` runs a function on pieces laid out so, and
:func:`reduce_to` (:func:`reduce_by`, :func:`mean`) reduces a partial
sum to them by explicit collectives. DTensor's planner moves nothing:
:func:`move` is the port's own redistribution (:func:`move_local`:
explicit collectives in a fixed order, forward and backward), which
:func:`constrain` and :func:`local_call` use, and :func:`grad_at`
reduces a gradient before autograd adds it to one of another layout,
so every collective of a step is one the port names and the counts
are the same on every torch version.

A dim split over several mesh axes is split in the order the spec
names them, as a ``PartitionSpec`` splits it: the first axis major.
Where that is the mesh's order the placements are plain ``Shard``
placements; where it is not (``fsdp: ("data", "pod")`` on a ("pod", "data",
"model") mesh: nemotron, mixtral and llava) the minor axis, which comes
first in the mesh, is a ``_StridedShard`` (DTensor's name for a split
made right to left), so each device holds the reference's piece.
DTensor's redistribution planner cannot run on such placements (on
torch 2.13 its min-cost graph search takes minutes an op, its greedy
planner fails), and torch 2.11's propagation mislays them in a view
(:func:`strided`), so DTensor never works on them: :func:`distribute`
cuts them locally, the train step's own ops on them (:func:`detach`,
:func:`unbind`, :func:`cast`, AdamW and the global norm in
``train.optim``) run on each rank's piece, and every product gathers
them first (:func:`unstride`: one all-gather a mesh axis, the minor
axis first, so the pieces land in the spec's order; its backward
reduce-scatters in the reverse order). A split over more than two mesh
axes out of the mesh's order is refused.

Where DTensor's own redistribution between two layouts builds a buffer
far larger than either (a dim gathered whole on every rank before it is
cut again), the port moves the data itself: :func:`gather` (one
all-gather a mesh dim) and :func:`regroup` (dim 0 from one nested split
to another by an all-gather and one all-to-all). :func:`positions`
makes a sequence's positions split like its tokens.
"""
from __future__ import annotations

import contextlib
import itertools
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


def _mesh_dims(part, mesh) -> list:
    """The mesh dims of more than one device that a spec part names,
    in its order."""
    names = list(mesh.mesh_dim_names)
    return [names.index(a) for a in _spec_axes(part)
            if mesh.size(names.index(a)) > 1]


def _chunk(coord, order: list, mesh) -> tuple:
    """(index, count) of the chunk that mesh coordinates ``coord`` hold
    of a dim split over the mesh dims ``order`` (major first)."""
    idx, n = 0, 1
    for m in order:
        idx, n = idx * mesh.size(m) + coord[m], n * mesh.size(m)
    return idx, n


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    on every mesh dim of more than one device that the spec puts on
    tensor dim ``d``, ``Shard(d)``, or for the minor of two axes named
    against the mesh's order ``_StridedShard(d)`` (module docstring);
    ``Replicate()`` elsewhere. A split over one device is no split, and
    DTensor will not reshape a dim it holds as sharded, so on a (1, 1)
    mesh every placement is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        cut = _mesh_dims(part, mesh)
        if cut == sorted(cut):
            for m in cut:
                out[m] = Shard(d)
        elif len(cut) == 2:
            major, minor = cut
            out[major] = Shard(d)
            out[minor] = _StridedShard(d, split_factor=mesh.size(major))
        else:
            raise NotImplementedError(
                f"dim {d} split over {part}: more than two mesh axes out of "
                f"the mesh's order {tuple(names)}")
    return tuple(out)


def _strided(q) -> bool:
    from torch.distributed.tensor.placement_types import _StridedShard
    return isinstance(q, _StridedShard)


def _splits(q, dim: int) -> bool:
    """Whether the placement ``q`` splits tensor dim ``dim`` (torch
    2.13's ``_StridedShard.is_shard`` says no)."""
    return q.is_shard(dim) or (_strided(q) and q.dim == dim)


def split_order(place: tuple, dim: int) -> list:
    """The mesh dims that split tensor dim ``dim`` under the placements
    ``place``, the major first (the spec's order; see :func:`placements`)."""
    cut = [m for m, q in enumerate(place) if _splits(q, dim)]
    if any(_strided(place[m]) for m in cut):
        return cut[::-1]
    return cut


def _piece(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's piece of ``t`` under ``spec``, each dim cut in the
    spec's order of its axes (a view)."""
    coord = mesh.get_coordinate()
    for d, part in enumerate(spec):
        idx, n = _chunk(coord, _mesh_dims(part, mesh), mesh)
        rows = t.shape[d] // n
        t = t.narrow(d, idx * rows, rows)
    return t


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
    elif any(_strided(q) for q in place):
        local = _piece(t.detach(), spec, mesh).clone()
    else:
        return distribute_tensor(t, mesh, place, src_data_rank=None)
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=t.shape, stride=t.stride())


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
    place = placements(spec, ctx[1])
    if any(_strided(q) for q in place):
        if place == tuple(x.placements):
            return x
        raise NotImplementedError(
            f"a layout {place} out of the mesh's order is made only by "
            f"distribute, not by a redistribution")
    # a node even where the layout holds already: the gradient is moved
    # to it too (``with_sharding_constraint`` pins both)
    return _Move.apply(unstride(x), place)


def local_call(fn, args: tuple, in_place: tuple, out_place: tuple, mesh):
    """``fn(*local args)`` on each rank (``local_map``'s contract): the
    DTensor ``args`` moved to ``in_place`` first (:func:`move`), the
    outputs DTensors of ``out_place``. A replicated input's gradient is
    a ``Partial`` sum on every mesh dim where an output is split or
    partial (each rank then saw another part of the work), and a
    replica elsewhere. Every move, forward and backward, is the port's
    own (``local_map`` leaves the inputs' moves and the outputs'
    gradients to DTensor's planner)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    split = [any(not isinstance(o[m], Replicate) for o in out_place)
             for m in range(mesh.ndim)]
    local = []
    for a, ins in zip(args, in_place):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        grad = tuple(Partial() if split[m] and isinstance(q, Replicate)
                     else q for m, q in enumerate(ins))
        local.append(move(a, tuple(ins)).to_local(grad_placements=grad))
    out = fn(*local)
    if isinstance(out, torch.Tensor):
        return _Out.apply(out, mesh, tuple(out_place[0]))
    return tuple(_Out.apply(o, mesh, tuple(p)) if isinstance(o, torch.Tensor)
                 else o for o, p in zip(out, out_place))


def layout(shape: tuple, *axes):
    """The placements the active rules give a tensor of ``shape`` with
    logical ``axes``; None outside :func:`use_rules`."""
    ctx = active()
    if ctx is None:
        return None
    return placements(resolve_spec(tuple(shape), tuple(axes), *ctx), ctx[1])


def summed(place: tuple, dim: int):
    """The placements of a sum over tensor dim ``dim`` (kept) of a
    tensor laid out as ``place``: a ``Partial`` sum on each mesh dim
    that splits ``dim``; None for None (:func:`layout` outside
    :func:`use_rules`)."""
    from torch.distributed.tensor import Partial
    if place is None:
        return None
    return tuple(Partial() if q.is_shard(dim) else q for q in place)


def per_rank(fn, args: tuple, in_place: tuple, out_place: tuple):
    """``fn(*args)`` on each rank's own pieces (:func:`local_call`), the
    args laid out as ``in_place`` and the outputs as ``out_place``, one
    tuple of placements each (:func:`layout`), so that no op inside meets
    operands of different placements and DTensor chooses no
    redistribution. Without a DTensor among ``args``, ``fn(*args)``."""
    from torch.distributed.tensor import DTensor
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    return local_call(fn, args, in_place, out_place, first.device_mesh)


def _collective(op, local, dim: int, mesh, m: int, *extra):
    """``_c10d_functional``'s all-gather or reduce-scatter ``op`` (it
    works on dim 0) over mesh dim ``m`` along tensor dim ``dim``, with
    the copies ``funcol`` makes: the gathered pieces cut and joined
    along ``dim``, or the pieces to scatter joined along dim 0 first."""
    c10d = torch.ops._c10d_functional
    group = mesh.get_group(m)
    n = group.size()
    if op is c10d.all_gather_into_tensor:
        out = c10d.wait_tensor(op(local.contiguous(), *extra, n,
                                  group.group_name))
        return out if dim == 0 else torch.cat(out.chunk(n, 0), dim)
    x = local if dim == 0 else torch.cat(local.chunk(n, dim))
    return c10d.wait_tensor(op(x.contiguous(), *extra, n, group.group_name))


def strided(x) -> bool:
    """Whether ``x`` is a DTensor with a dim split out of the mesh's
    order. The port keeps DTensor's sharding propagation off such a
    tensor and runs its ops on each rank's piece: torch 2.11's
    ``unbind`` leaves a ``_StridedShard`` on the old dim while the other
    splits move down (a wrong layout; 2.13 moves both)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor) and any(_strided(q) for q in x.placements)


def like(x, local):
    """``local``, this rank's piece of a tensor laid out as the DTensor
    ``x`` (its placements, shape and strides)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def detach(x):
    """``x.detach()``; a :func:`strided` DTensor on its local piece."""
    return like(x, x.to_local().detach()) if strided(x) else x.detach()


def cast(x, dtype):
    """``x.to(dtype)``; a :func:`strided` DTensor on its local piece."""
    if not strided(x):
        return x.to(dtype)
    return local_call(lambda t: t.to(dtype), (x,), (x.placements,),
                      (x.placements,), x.device_mesh)


def unbind(x):
    """``x.unbind(0)``; a :func:`strided` DTensor (its dim 0 whole) on
    its local piece, each slice keeping the other dims' splits."""
    if not strided(x):
        return x.unbind(0)
    from torch.distributed.tensor.placement_types import _StridedShard
    if any(_splits(q, 0) for q in x.placements):
        raise NotImplementedError("unbind of a split dim 0")

    def down(q):
        if _strided(q):
            return _StridedShard(q.dim - 1, split_factor=q.split_factor)
        return type(q)(q.dim - 1) if q.is_shard() else q
    place = tuple(down(q) for q in x.placements)
    return local_call(lambda t: tuple(t.unbind(0)), (x,), (x.placements,),
                      (place,) * x.shape[0], x.device_mesh)


def _shard_dims(place, dim: int) -> list:
    """The mesh dims whose ``Shard`` placement splits tensor dim ``dim``,
    the major first (plain placements split in the mesh's order)."""
    return [m for m, q in enumerate(place)
            if q.is_shard() and not _strided(q) and q.dim == dim]


def _all_reduce(local, op: str, mesh, m: int):
    """``local`` reduced by ``op`` over mesh dim ``m`` (an average as a
    sum over the group's size: gloo has no average)."""
    c10d = torch.ops._c10d_functional
    group = mesh.get_group(m)
    out = c10d.wait_tensor(c10d.all_reduce(
        local.contiguous(), "sum" if op == "avg" else op, group.group_name))
    return out / group.size() if op == "avg" else out


def _swap(local, dim: int, to: int, mesh, m: int):
    """One all-to-all over mesh dim ``m``: tensor dim ``dim`` gathered
    whole, ``to`` split (the op DTensor itself calls for such a move)."""
    return torch.ops._dtensor.shard_dim_alltoall(
        local.contiguous(), dim, to, mesh.get_group(m).group_name)


def move_local(local, have: tuple, want: tuple, mesh):
    """A rank's piece under the placements ``have`` as its piece under
    ``want``, by explicit collectives in a fixed order (the port's own
    redistribution; no ``_StridedShard`` either side). Per tensor dim,
    the mesh dims that split it in both layouts, as a common prefix in
    the mesh's order, stay; the rest of ``have``'s splits are undone
    innermost first, each by one all-to-all where it moves to the next
    split ``want`` names, else by an all-gather; then, outermost first,
    a partial sum reduce-scatters into its split or all-reduces, and a
    replica keeps its chunk."""
    from torch.distributed.tensor import Replicate
    c10d = torch.ops._c10d_functional
    if any(_strided(q) for q in have + want):
        raise NotImplementedError(f"move {have} to {want}")
    cur = list(have)
    keep = set()
    for d in range(local.ndim):
        a, b = _shard_dims(have, d), _shard_dims(want, d)
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        keep.update(a[:k])

    def next_split(m, d):
        now, goal = _shard_dims(cur, d), _shard_dims(want, d)
        return goal[:len(now)] == now and len(goal) > len(now) and \
            goal[len(now)] == m
    for m in reversed(range(mesh.ndim)):
        q, w = cur[m], want[m]
        if not q.is_shard() or m in keep:
            continue
        if w.is_shard() and w.dim != q.dim and next_split(m, w.dim):
            local = _swap(local, q.dim, w.dim, mesh, m)
            cur[m] = w
        else:
            local = _all_gather(local, q.dim, mesh, [m])
            cur[m] = Replicate()
    coord = mesh.get_coordinate()
    for m in range(mesh.ndim):
        q, w = cur[m], want[m]
        if q == w:
            continue
        if q.is_partial() and w.is_shard() and q.reduce_op != "avg":
            local = _collective(c10d.reduce_scatter_tensor, local, w.dim,
                                mesh, m, q.reduce_op)
        elif q.is_partial() and not w.is_partial():
            local = _all_reduce(local, q.reduce_op, mesh, m)
            if w.is_shard():
                local = local.chunk(mesh.size(m), w.dim)[coord[m]].clone()
        elif isinstance(q, Replicate) and w.is_shard():
            # a copy, so that the whole replica can go (DTensor's too)
            local = local.chunk(mesh.size(m), w.dim)[coord[m]].clone()
        else:
            raise NotImplementedError(f"move {have} to {want}")
        cur[m] = w
    return local.contiguous()


def _grad_place(place: tuple) -> tuple:
    """The placements of a gradient for a tensor of ``place``: a partial
    sum's is whole (each rank's share takes all of it)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if q.is_partial() else q for q in place)


def _moved(g, want: tuple):
    """The DTensor ``g``'s piece under ``want`` (:func:`move_local`)."""
    if tuple(g.placements) == tuple(want):
        return g.to_local()
    g = unstride(g)
    return move_local(g.to_local(), tuple(g.placements), tuple(want),
                      g.device_mesh)


def _back(have: tuple, grad: tuple) -> tuple:
    """Where a gradient of placements ``grad`` moves for an input of
    ``have`` (``DTensor.redistribute``'s backward): to the input's
    layout, but a partial sum's gradient whole, unless it is partial
    itself (then it stays so)."""
    from torch.distributed.tensor import Replicate
    return tuple(q if not q.is_partial() else
                 (q if h.is_partial() else Replicate())
                 for q, h in zip(have, grad))


def _placed(x, local, place: tuple):
    """``local`` as a DTensor of ``x``'s mesh, shape and strides laid out
    as ``place``."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, x.device_mesh, place, run_check=False,
                              shape=x.shape, stride=_dense_stride(x.shape))


class _Move(torch.autograd.Function):
    """:func:`move`'s forward and backward, each by :func:`move_local`."""

    @staticmethod
    def forward(ctx, x, place):
        ctx.have = tuple(x.placements)
        return _placed(x, _moved(x, place), place)

    @staticmethod
    def backward(ctx, g):
        want = _back(ctx.have, tuple(g.placements))
        return _placed(g, _moved(g, want), want), None


class _Out(torch.autograd.Function):
    """A rank's piece as a DTensor of ``place``; its gradient arrives
    moved to the layout of a gradient for ``place``."""

    @staticmethod
    def forward(ctx, local, mesh, place):
        from torch.distributed.tensor import DTensor
        ctx.place = _grad_place(place)
        return DTensor.from_local(local.view_as(local), mesh, place,
                                  run_check=False)

    @staticmethod
    def backward(ctx, g):
        return _moved(g, ctx.place), None, None


def grad_at(x):
    """``x`` as it is; its gradient moved to ``x``'s own placements by
    explicit collectives (a partial sum reduced whole). Where ``x`` has
    several uses whose gradients arrive at other placements (a norm's
    branch a partial sum, the residual skip whole; attention's query a
    partial sum, keys and values whole where the kv heads are not
    split), autograd adds them by DTensor's own choice: torch 2.11
    all-reduces the partial sum, 2.13 splits the whole one. Any other
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _Move.apply(x, tuple(x.placements))


def move(x, place: tuple):
    """``x.redistribute(mesh, place)`` by the port's own collectives
    (:func:`move_local`, forward and backward), so that no torch version
    plans it; a dim split out of the mesh's order is gathered first
    (:func:`unstride`). Any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or tuple(x.placements) == tuple(place):
        return x
    return _Move.apply(unstride(x), tuple(place))


def _all_gather(local, dim: int, mesh, order: list):
    """``local`` gathered along ``dim`` over the mesh dims ``order``
    (major first): the minor first, so that the pieces land in order."""
    for m in reversed(order):
        local = _collective(torch.ops._c10d_functional.all_gather_into_tensor,
                            local, dim, mesh, m)
    return local


def _dense_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for k in reversed(tuple(shape)):
        out.append(n)
        n *= k
    return tuple(reversed(out))


class _Gather(torch.autograd.Function):
    """A DTensor's dim ``dim`` gathered whole by one all-gather a mesh
    dim of ``order``; the backward takes each rank's piece back out of
    the gradient: a reduce-scatter where it is a partial sum, a slice
    where it is whole."""

    @staticmethod
    def forward(ctx, x, dim, order):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = x.device_mesh
        local = _all_gather(x.to_local(), dim, mesh, order).contiguous()
        stride = _dense_stride(x.shape)
        ctx.meta = (mesh, dim, order, tuple(x.placements), x.shape, stride)
        place = tuple(Replicate() if m in order else q
                      for m, q in enumerate(x.placements))
        return DTensor.from_local(local, mesh, place, run_check=False,
                                  shape=x.shape, stride=stride)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        mesh, dim, order, place, shape, stride = ctx.meta
        want = tuple(
            (Partial() if g.placements[m].is_partial() else Replicate())
            if m in order else place[m] for m in range(mesh.ndim))
        local = _moved(g, want)
        coord = mesh.get_coordinate()
        for m in order:
            if want[m].is_partial():
                local = _collective(
                    torch.ops._c10d_functional.reduce_scatter_tensor, local,
                    dim, mesh, m, "sum")
            else:
                local = local.chunk(mesh.size(m), dim)[coord[m]]
        return DTensor.from_local(local.contiguous(), mesh, place,
                                  run_check=False, shape=shape,
                                  stride=stride), None, None


def gather(x, dim: int):
    """``x`` with dim ``dim`` whole on every rank: for a DTensor split
    along it, one explicit all-gather a mesh dim that splits it, in the
    split's order (DTensor's own redistribution cannot take a
    ``_StridedShard``, and for some layouts plans a buffer many times
    the result). Any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    order = split_order(tuple(x.placements), dim)
    return _Gather.apply(x, dim, order) if order else x


class _Reduce(torch.autograd.Function):
    """A DTensor's partial sums reduced to the placements ``place``: on
    each mesh dim that holds them, a reduce-scatter into ``place``'s
    split or an all-reduce where ``place`` replicates. The backward
    all-gathers the gradient where the forward scattered it (each rank's
    partial sum takes the whole gradient)."""

    @staticmethod
    def forward(ctx, x, place):
        from torch.distributed.tensor import DTensor
        c10d = torch.ops._c10d_functional
        mesh = x.device_mesh
        local = x.to_local()
        for m, q in enumerate(x.placements):
            if not q.is_partial():
                continue
            if place[m].is_shard():
                local = _collective(c10d.reduce_scatter_tensor, local,
                                    place[m].dim, mesh, m, "sum")
            else:
                local = c10d.wait_tensor(c10d.all_reduce(
                    local, "sum", mesh.get_group(m).group_name))
        stride = _dense_stride(x.shape)
        ctx.meta = (mesh, tuple(x.placements), x.shape, stride, place)
        return DTensor.from_local(local.contiguous(), mesh, place,
                                  run_check=False, shape=x.shape,
                                  stride=stride)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        mesh, place_in, shape, stride, place = ctx.meta
        # a partial gradient of a partial input stays partial (as
        # ``DTensor.redistribute``'s backward keeps it)
        want = tuple(h if q.is_partial() and h.is_partial() else w
                     for q, h, w in zip(place_in, g.placements, place))
        local = _moved(g, want)
        for m in reversed(range(mesh.ndim)):
            if place_in[m].is_partial() and want[m].is_shard():
                local = _collective(
                    torch.ops._c10d_functional.all_gather_into_tensor,
                    local, want[m].dim, mesh, m)
        out = _back(place_in, want)
        return DTensor.from_local(local.contiguous(), mesh, out,
                                  run_check=False, shape=shape,
                                  stride=stride), None


def reduce_to(x, place: tuple):
    """``x`` with its partial sums reduced to the placements ``place``
    (:func:`layout`) by explicit collectives (:class:`_Reduce`), where
    DTensor would reduce them at the next op that needs it, to a
    placement of its own choice. Only the mesh dims that hold partial
    sums move; the others must lie as ``place`` says already, and a
    split is added only on the minor side of a dim's existing splits.
    Any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    have = tuple(x.placements)
    for m, (q, want) in enumerate(zip(have, place)):
        if q.is_partial():
            if q.reduce_op != "sum":
                raise NotImplementedError(f"reduce of a {q} partial")
            if want.is_partial() or _strided(want) or want.is_shard() and                     any(_splits(have[j], want.dim) for j in range(m + 1,
                                                                  len(have))):
                raise NotImplementedError(f"reduce {have} to {place}")
        elif q != want:
            raise ValueError(f"reduce {have} to {place}: mesh dim {m} is "
                             f"not a partial sum")
    if have == tuple(place):
        return x
    return _Reduce.apply(x, tuple(place))


def reduce_by(x, *axes):
    """``x`` with its partial sums reduced (:func:`reduce_to`) into the
    placements the active rules give the logical ``axes`` on the mesh
    dims that hold them (without ``axes``, whole there); the other mesh
    dims as they are. An op that meets a partial sum (a nonlinearity, a
    quotient) would else leave the reduction to DTensor. Any other
    tensor, or one without partial sums, as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or not any(
            q.is_partial() for q in x.placements):
        return x
    want = layout(tuple(x.shape), *axes) if axes else None
    return reduce_to(x, tuple(
        (want[m] if want else Replicate()) if q.is_partial() else q
        for m, q in enumerate(x.placements)))


def mean(x, dims: tuple):
    """``x.mean(dims)``. For a DTensor, each rank's mean of its piece,
    weighted by its share of the count, summed across the ranks that
    split ``dims`` by explicit all-reduces (DTensor's own mean leaves a
    ``Partial(avg)`` for the next op to reduce as it chooses). The
    weight is 1 for a dim held whole, so a plain tensor's mean is
    unchanged."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    if not isinstance(x, DTensor):
        return x.mean(dim=dims)
    dims = tuple(sorted(d % x.ndim for d in dims))
    n = math.prod(x.shape[d] for d in dims)
    x = reduce_by(x)
    out = tuple(Partial() if q.is_shard() and q.dim in dims else
                Shard(q.dim - sum(d < q.dim for d in dims)) if q.is_shard()
                else q for q in x.placements)

    def share(t):
        return t.mean(dim=dims) * (math.prod(t.shape[d] for d in dims) / n)
    return reduce_by(per_rank(share, (x,), (tuple(x.placements),), (out,)))


def _held(coord, rows: int, src: list, gathered: list, mesh) -> list:
    """The global rows a rank at ``coord`` holds, in its local order, of
    a dim of ``rows`` split over ``src`` once the mesh dims
    ``gathered`` (in ``src``'s order) are gathered."""
    _, n = _chunk(coord, src, mesh)
    out = []
    for g in itertools.product(*(range(mesh.size(m)) for m in gathered)):
        c = list(coord)
        for m, v in zip(gathered, g):
            c[m] = v
        idx = _chunk(c, src, mesh)[0]
        out += range(idx * rows // n, (idx + 1) * rows // n)
    return out


def _needed(coord, rows: int, dst: list, mesh) -> list:
    idx, n = _chunk(coord, dst, mesh)
    return list(range(idx * rows // n, (idx + 1) * rows // n))


def _regroup_plan(mesh, rows: int, src: list, dst: list) -> dict:
    """How :func:`regroup` moves this rank's rows: the mesh dims it
    gathers, then either a local pick (``pick``: positions of the rows
    it needs in what it holds) or one all-to-all over the mesh dim
    ``m`` that splits both layouts (``send``: positions it sends, by
    destination; ``splits_in``/``splits_out``; ``order``: where each
    received row goes)."""
    gathered = [m for m in src if m not in dst]
    common = [m for m in src if m in dst]
    if len(common) > 1:
        raise NotImplementedError(
            f"regroup from {src} to {dst}: more than one mesh dim in common")
    me = list(mesh.get_coordinate())
    held = _held(me, rows, src, gathered, mesh)
    need = _needed(me, rows, dst, mesh)
    where = {r: i for i, r in enumerate(held)}
    if not common:
        return {"gathered": gathered, "pick": [where[r] for r in need],
                "held": len(held)}
    m = common[0]
    mine = set(need)
    send, splits_in, splits_out, got = [], [], [], []
    for t in range(mesh.size(m)):
        c = list(me)
        c[m] = t
        theirs = set(_needed(c, rows, dst, mesh))
        out = sorted(r for r in held if r in theirs)
        send += [where[r] for r in out]
        splits_in.append(len(out))
        back = sorted(r for r in _held(c, rows, src, gathered, mesh)
                      if r in mine)
        got += back
        splits_out.append(len(back))
    pos = {r: i for i, r in enumerate(got)}
    return {"gathered": gathered, "m": m, "send": send,
            "splits_in": splits_in, "splits_out": splits_out,
            "order": [pos[r] for r in need], "held": len(held)}


def _all_to_all(local, mesh, m: int, splits_out: list, splits_in: list):
    """``_c10d_functional.all_to_all_single`` over mesh dim ``m`` along
    dim 0."""
    c10d = torch.ops._c10d_functional
    group = mesh.get_group(m)
    return c10d.wait_tensor(c10d.all_to_all_single(
        local.contiguous(), splits_out, splits_in, group.group_name))


def _rows(local, idx: list):
    return local.index_select(0, torch.tensor(idx, dtype=torch.long,
                                              device=local.device))


class _Regroup(torch.autograd.Function):
    """A DTensor's dim 0 moved from the split over the mesh dims ``src``
    to the split over ``dst`` (both major first): an all-gather a mesh
    dim that only ``src`` splits, then a local pick or one all-to-all
    over the mesh dim both split; each rank ends with only its rows. The
    backward runs it in reverse: the all-to-all back, zeros for the
    rows it did not send, a reduce-scatter or a slice a gathered dim."""

    @staticmethod
    def forward(ctx, x, src, dst):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = x.device_mesh
        rows = x.shape[0]
        plan = _regroup_plan(mesh, rows, src, dst)
        local = _all_gather(x.to_local(), 0, mesh, plan["gathered"])
        if "pick" in plan:
            local = _rows(local, plan["pick"])
        else:
            local = _all_to_all(_rows(local, plan["send"]), mesh, plan["m"],
                                plan["splits_out"], plan["splits_in"])
            local = _rows(local, plan["order"])
        place = tuple(Shard(0) if m in dst else
                      (Replicate() if m in src else q)
                      for m, q in enumerate(x.placements))
        stride = _dense_stride(x.shape)
        ctx.meta = (mesh, src, dst, plan, tuple(x.placements), x.shape,
                    stride, place)
        return DTensor.from_local(local.contiguous(), mesh, place,
                                  run_check=False, shape=x.shape,
                                  stride=stride)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial
        mesh, src, dst, plan, place_in, shape, stride, place = ctx.meta
        want = tuple(place[m] if m in dst else
                     (Partial() if g.placements[m].is_partial()
                      else place[m]) for m in range(mesh.ndim))
        local = _moved(g, want)
        if "pick" in plan:
            held = local.new_zeros((plan["held"], *local.shape[1:]))
            held = held.index_copy(0, torch.tensor(
                plan["pick"], dtype=torch.long, device=local.device), local)
        else:
            back = local.new_empty(local.shape).index_copy(0, torch.tensor(
                plan["order"], dtype=torch.long, device=local.device), local)
            back = _all_to_all(back, mesh, plan["m"], plan["splits_in"],
                               plan["splits_out"])
            held = local.new_zeros((plan["held"], *local.shape[1:]))
            held = held.index_copy(0, torch.tensor(
                plan["send"], dtype=torch.long, device=local.device), back)
        coord = mesh.get_coordinate()
        for m in plan["gathered"]:
            if want[m].is_partial():
                held = _collective(
                    torch.ops._c10d_functional.reduce_scatter_tensor, held,
                    0, mesh, m, "sum")
            else:
                held = held.chunk(mesh.size(m), 0)[coord[m]]
        out = tuple(Partial() if (m in dst and m not in src) or
                    (m not in dst and want[m].is_partial() and
                     m not in plan["gathered"]) else place_in[m]
                    for m in range(mesh.ndim))
        return DTensor.from_local(held.contiguous(), mesh, out,
                                  run_check=False, shape=shape,
                                  stride=stride), None, None


def regroup(x, dim: int, part):
    """``x`` with dim ``dim`` split as the spec part ``part`` says (a
    mesh axis, a tuple of them, or ``None``), each rank receiving only
    its own rows (DTensor's own redistribution between two nested
    splits, e.g. from ("pod", "data") to ("data",), gathers the whole
    dim on every rank first). Only dim 0, and splits that share at most
    one mesh dim; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if dim % x.ndim:
        raise NotImplementedError("regroup moves dim 0 only")
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    x = unstride(x)
    src = split_order(tuple(x.placements), 0)
    dst = _mesh_dims(part, mesh)
    if src == dst:
        return x
    if any(not x.placements[m].is_shard(0) and
           not isinstance(x.placements[m], Replicate) for m in dst):
        x = move(x, tuple(
            Replicate() if m in dst and not q.is_shard(0) else q
            for m, q in enumerate(x.placements)))
    return _Regroup.apply(x, src, dst)


def unstride(x):
    """``x`` with every dim split out of the mesh's order gathered
    whole (:func:`gather`); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    for d in sorted({q.dim for q in x.placements if _strided(q)}):
        x = gather(x, d)
    return x


def positions(b: int, s: int, like):
    """The (b, s) int32 positions of a sequence, 0..s-1 on every row.
    For a DTensor ``like`` whose first two dims are (batch, seq), a
    DTensor split as those two dims are, each rank making only its own
    rows and columns (under GSPMD the reference's positions follow the
    tokens' split); else a plain tensor on ``like``'s device."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(like, DTensor):
        return torch.arange(s, dtype=torch.int32,
                            device=like.device)[None, :].repeat(b, 1)
    mesh = like.device_mesh
    place = tuple(q if (q.is_shard(0) or q.is_shard(1)) and not _strided(q)
                  else Replicate() for q in like.placements)
    local = like.to_local()
    rows, cols = local.shape[0], local.shape[1]
    first = shard_start(mesh, [m for m, q in enumerate(place)
                               if q.is_shard(1)], cols)
    pos = torch.arange(first, first + cols, dtype=torch.int32,
                       device=local.device)[None, :].repeat(rows, 1)
    return DTensor.from_local(pos, mesh, place, run_check=False,
                              shape=(b, s), stride=(s, 1))


def arange(n: int, like, dim: int):
    """``torch.arange(n)`` for a dim ``dim`` of ``n`` of ``like``. For a
    DTensor, a DTensor split as that dim is, each rank making only its
    own indices (a mask from it then meets ``like`` with no move)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(like, DTensor):
        return torch.arange(n, device=like.device)
    dim %= like.ndim
    mesh = like.device_mesh
    cut = [m for m, q in enumerate(like.placements)
           if q.is_shard(dim) and not _strided(q)]
    rows = like.to_local().shape[dim]
    first = shard_start(mesh, cut, rows)
    local = torch.arange(first, first + rows, device=like.to_local().device)
    place = tuple(Shard(0) if m in cut else Replicate()
                  for m in range(mesh.ndim))
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=(n,), stride=(1,))


def first_row(pos):
    """Row 0 of (B, S) positions as a plain tensor. For a DTensor from
    :func:`positions`, whose rows are all alike, this rank's first row
    with its seq dim gathered whole."""
    from torch.distributed.tensor import DTensor
    if not isinstance(pos, DTensor):
        return pos[0]
    cut = split_order(tuple(pos.placements), 1)
    return _all_gather(pos.to_local()[0], 0, pos.device_mesh, cut) if cut \
        else pos.to_local()[0]


def along(fn, args: tuple, dim: int):
    """``fn(*args)``, a scan along ``dim`` that keeps every other dim
    apart; for DTensors, each rank's own ``fn`` with ``dim`` whole and
    the first arg's other splits, which every arg takes. A mesh dim on
    which the first arg splits ``dim`` (or holds a partial sum) splits
    another dim instead where one divides: one that an arg splits
    there, else the last, so that split still divides the scan's work.
    Torch 2.11's DTensor has no rule for the ``flip`` of ``cumsum``'s
    backward."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    args = tuple(unstride(a) for a in args)
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    mesh = first.device_mesh
    dim %= first.ndim
    moved = [q.is_partial() or _splits(q, dim) for q in first.placements]
    place = [Replicate() if mv else q
             for mv, q in zip(moved, first.placements)]
    local = list(first.shape)
    for m, q in enumerate(place):
        if q.is_shard():
            local[q.dim] //= mesh.size(m)
    for m in range(mesh.ndim):
        if not moved[m]:
            continue
        others = [a.placements[m].dim for a in args
                  if isinstance(a, DTensor) and a.placements[m].is_shard()]
        fits = [d for d in others + list(range(first.ndim - 1, -1, -1))
                if d != dim and local[d] % mesh.size(m) == 0]
        if fits:
            place[m] = Shard(fits[0])
            local[fits[0]] //= mesh.size(m)
    place = tuple(place)
    return local_call(fn, args, (place,) * len(args), (place,), mesh)


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
        m = move(x.amax(-1, keepdim=True), place)
        m = m.masked_fill(m.abs() == math.inf, 0)
        s = move(torch.exp(x - m).sum(-1), place)
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
    value = _moved(value, place)
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
    a, b = (unstride(x) if isinstance(x, DTensor) else DTensor.from_local(
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
