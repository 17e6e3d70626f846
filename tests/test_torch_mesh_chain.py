"""The mesh path's carry chain as one call per shard (B4/B5 and their
float32 instantiations) against the twins' per-tile chain and the
reference.

On the card ``ops.raster_slice_partial``/``raster_projection_partial``
make one kernel call over a shard; the twins (``backend="ref"`` and CPU
tensors) chain it in ``tile_n``-row tiles, and the call must give the
chain's bits. Contract, at small size (the Sedov tree of
``tests/test_torch_mesh.py``, R = 32, and a larger Sedov tree at R = 64
with several 4,096-row tiles):

  * the twins' per-tile chain equals their one call bitwise at float32
    (tiles of 512 and 4,096 rows; float64 is ``test_torch_mesh.py``'s);
  * the reference's ``raster_*_partial(backend="pallas_interpret")``
    equals the port's one call on the CPU (the wrappers with the chain's
    ``tile_n``, which run the twins), in each dtype;
  * every ``MeshTable`` shard's kept rows are level-sorted (S = 1, 2, 4),
    the precondition under which the projection's (level, row) walk is
    the chain's (tile, level, row) order;
  * numpy mirrors of what the CUDA source does (the segment-major order
    step, the pixel walk with its restart in the chain's order, and the
    cut at the int32 row limit) give the twins' bits, on level-sorted and
    on shuffled tables.

Tolerance: bitwise everywhere. Every JAX call runs under
``jax.enable_x64(True)``. The ``gpu`` cases hold the CUDA one call
against the twins' chain on the card, count one launch per shard, and
check that a failing launch raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ops_ref
from repro.sim import amrgen, fields
from repro_torch.insitu import reducers as red_pt
from repro_torch.insitu.mesh_reduce import MeshDAGRunner, MeshTable
from repro_torch.insitu.staging import Snapshot
from repro_torch.kernels import ops, raster, ref
from test_torch_mesh import R, assert_bits, node_tables, sedov_arrays

CPU = torch.device("cpu")
DTYPES = [np.float64, np.float32]


@pytest.fixture(scope="module")
def arrays():
    return sedov_arrays()


@pytest.fixture(scope="module")
def big_arrays():
    """A Sedov tree with several 4,096-row tiles (R = 64 = 2**max_level)."""
    rng = np.random.default_rng(21)
    tree = amrgen.generate_tree(fields.sedov(r_shock=0.2), min_level=2,
                                max_level=6, threshold=1.15,
                                level_factor=1.05)          # 8,777 nodes
    tree.fields["density"] = rng.standard_normal(tree.n_nodes) * 4.0 + 1.0
    return tree.to_arrays()


def table(arrays, dtype=np.float64) -> dict:
    x = node_tables(arrays)
    return {**x, "values": x["values"].astype(dtype)}


def tensors(x: dict, device=CPU) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in x.items() if k != "n_levels"}


def partial(x: dict, kind: str, *, resolution: int, tile_n, backend=None,
            device=CPU):
    """``ops``' partial raster of ``x``: (image, depth) or (image,)."""
    t = tensors(x, device)
    kw = dict(axis=2, resolution=resolution, n_levels=x["n_levels"],
              backend=backend, tile_n=tile_n)
    if kind == "slice":
        return ops.raster_slice_partial(t["coords"], t["levels"],
                                        t["values"], t["ok"], position=0.5,
                                        **kw)
    return (ops.raster_projection_partial(t["coords"], t["levels"],
                                          t["values"], t["ok"], **kw),)


def one_call(x: dict, kind: str, *, resolution: int, tile_n, device=CPU):
    """The wrapper the card's one call goes through, over the whole table
    with the chain's ``tile_n`` (on the CPU it runs the twins)."""
    t = tensors(x, device)
    c2 = ops.plane_coords(t["coords"], 2)
    lv = t["levels"].to(torch.int32)
    geo = dict(resolution=resolution, n_levels=x["n_levels"])
    if kind == "slice":
        return raster.slice_raster_carry(
            c2, t["coords"][:, 2].to(torch.int32), lv, t["values"], t["ok"],
            position=0.5, **geo)
    return (raster.projection_raster_carry(c2, lv, t["values"], t["ok"],
                                           tile_n=tile_n, **geo),)


def shuffled(x: dict, seed: int = 0) -> dict:
    """``x`` with its rows in a random order: kept rows not level-sorted."""
    perm = np.random.default_rng(seed).permutation(x["values"].shape[0])
    return {k: (v if k == "n_levels" else np.asarray(v)[perm])
            for k, v in x.items()}


def bits(t) -> np.ndarray:
    return np.asarray(t.numpy() if torch.is_tensor(t) else t)


# ------------------------------------------------------ the twins' chain

@pytest.mark.parametrize("tile_n", [512, 4096])
@pytest.mark.parametrize("kind", ["slice", "projection"])
def test_twin_chain_equals_one_call_f32(big_arrays, kind, tile_n):
    """float32: the twins chained over tiles are bit-equal to their one
    call over the table (image and depth)."""
    x = table(big_arrays, np.float32)
    assert x["values"].shape[0] > 2 * tile_n         # several tiles
    chain = partial(x, kind, resolution=64, tile_n=tile_n)
    whole = partial(x, kind, resolution=64, tile_n=None)
    assert chain[0].dtype == torch.float32
    for a, b in zip(chain, whole):
        assert_bits(bits(a), bits(b), f"{kind} chain vs one call")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["slice", "projection"])
def test_reference_interpret_equals_port_one_call(arrays, kind, dtype):
    """The reference's Pallas carry kernels (interpret mode, chained over
    512-row tiles) against the port's one call with that ``tile_n``."""
    x = table(arrays, dtype)
    got = one_call(x, kind, resolution=R, tile_n=512)
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in x.items() if k != "n_levels"}
        kw = dict(axis=2, resolution=R, n_levels=x["n_levels"],
                  backend="pallas_interpret", tile_n=512)
        if kind == "slice":
            want = ops_ref.raster_slice_partial(
                j["coords"], j["levels"], j["values"], j["ok"],
                position=0.5, **kw)
        else:
            want = (ops_ref.raster_projection_partial(
                j["coords"], j["levels"], j["values"], j["ok"], **kw),)
        want = [np.asarray(w) for w in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_bits(bits(g), w, f"{kind} {np.dtype(dtype)}")


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_mesh_shards_keep_level_sorted_rows(big_arrays, n_shards):
    """Every shard's kept rows (ok, 0 <= level < n_levels) ascend in
    level: BFS-ascending leaves of one Hilbert segment."""
    mt = MeshTable(big_arrays, 1, [CPU] * n_shards)
    shards = list(mt.shards("density"))
    assert len(shards) == n_shards
    for _, levels, _, ok in shards:
        lv = levels.numpy()
        keep = ok.numpy() & (lv >= 0) & (lv < mt.n_levels)
        assert keep.any()
        assert np.all(np.diff(lv[keep]) >= 0)


def test_shuffled_table_chain_differs_from_the_whole_walk(big_arrays):
    """On rows that are not level-sorted the chain's order is not the one
    (level, row) walk: the case the kernel's restart exists for."""
    x = shuffled(table(big_arrays, np.float32), seed=3)
    chain = partial(x, "projection", resolution=64, tile_n=512)[0]
    whole = partial(x, "projection", resolution=64, tile_n=None)[0]
    assert not np.array_equal(bits(chain), bits(whole))
    wrapped = one_call(x, "projection", resolution=64, tile_n=512)[0]
    assert_bits(bits(wrapped), bits(chain), "wrapper with tile_n")


# ---------------------------------------------------- mirrors of the card

def order_mirror(cell, offsets, slot_row, *, span: int, stage: int):
    """``proj_order_kernel``: each block's ``span`` placed entries, the
    window widened to whole segments and staged ``stage`` entries at a
    time; an entry's rank counts the staged rows of its own segment below
    its row, and the entry goes to its segment's start plus its rank."""
    valid = int(offsets[-1])
    order = np.full(valid, -1, np.int64)
    for first in range(0, valid, span):
        last = min(first + span, valid)
        rows = slot_row[first:last]
        lo, hi = offsets[cell[rows]], offsets[cell[rows] + 1]
        rank = np.zeros(rows.size, np.int64)
        w_lo, w_hi = lo[0], hi[-1]
        for c in range(w_lo, w_hi, stage):
            staged = slot_row[c:min(c + stage, w_hi)]
            for i, r in enumerate(rows):
                a, b = max(lo[i], c), min(hi[i], c + staged.size)
                if b > a:
                    rank[i] += int(np.sum(staged[a - c:b - c] < r))
        assert np.all(order[lo + rank] == -1)
        order[lo + rank] = rows
    return order


def csr(x: dict, resolution: int, rng):
    """Steps 1-3 of B2/B5 in numpy: each kept row's pyramid cell, the
    offsets, and the rows placed in a random order inside each segment
    (the place step's atomics order them arbitrarily)."""
    t = tensors(x)
    c2 = ops.plane_coords(t["coords"], 2)
    cells = ref.level_cells(c2, t["levels"], resolution=resolution,
                            n_levels=x["n_levels"]).numpy()
    lv = x["levels"]
    keep = x["ok"] & (lv >= 0) & (lv < x["n_levels"])
    total = ref.level_bases(x["n_levels"],
                            resolution.bit_length() - 1)[-1]
    cell = np.where(keep, cells, -1)
    counts = np.bincount(cell[keep], minlength=total)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    slot_row = np.empty(int(offsets[-1]), np.int64)
    for c in np.flatnonzero(counts):
        rows = np.flatnonzero(cell == c)
        slot_row[offsets[c]:offsets[c + 1]] = rng.permutation(rows)
    return cell, offsets, slot_row


def projection_mirror(x: dict, order, offsets, *, resolution: int,
                      tile_n, img0):
    """``projection_kernel``: the order step's contributions value * 2^-l
    in CSR order, then per pixel the (level, row) walk over them; with
    ``tile_n`` each segment's first row is checked against the tile of the
    last row before it, and a pixel that meets an earlier tile starts
    again from its seed in ``chain_sum``'s order (tile by tile)."""
    dt = np.asarray(x["values"]).dtype.type
    val, lv = np.asarray(x["values"]), np.asarray(x["levels"])
    contrib = np.array([dt(val[r] * dt(np.ldexp(1.0, -int(lv[r]))))
                        for r in order], dt)
    k = resolution.bit_length() - 1
    L = x["n_levels"]
    tile = tile_n if tile_n and tile_n < val.size else 0
    img = np.empty((resolution, resolution), dt)

    def segments(i, j):
        base = 0
        for lvl in range(L):
            sh = k - min(lvl, k)
            g = 1 << (k - sh)
            cell = base + (i >> sh) * g + (j >> sh)
            yield range(offsets[cell], offsets[cell + 1])
            base += g * g

    def chain_sum(i, j, acc):
        done = -1
        while True:
            nxt = min((int(order[e]) // tile for seg in segments(i, j)
                       for e in seg if int(order[e]) // tile > done),
                      default=None)
            if nxt is None:
                return acc
            for seg in segments(i, j):
                for e in seg:
                    if int(order[e]) // tile == nxt:
                        acc = dt(acc + contrib[e])
            done = nxt

    restarts = 0
    for i in range(resolution):
        for j in range(resolution):
            acc = seed = dt(img0[i, j])
            tile_lo, again = 0, False
            for seg in segments(i, j):
                if not len(seg):
                    continue
                if tile:
                    if order[seg[0]] < tile_lo:
                        again = True
                        break
                    tile_lo = order[seg[-1]] - order[seg[-1]] % tile
                for e in seg:
                    acc = dt(acc + contrib[e])
            if again:
                restarts += 1
                acc = chain_sum(i, j, seed)
            img[i, j] = acc
    return img, restarts


@pytest.mark.parametrize("span,stage", [(256, 4096), (8, 4), (3, 2)])
def test_order_step_mirror_is_the_stable_sort(span, stage):
    """The segment-major rank gives each segment in row order, at the
    kernel's block and stage (256 and 4,096 entries) and at small ones
    that deep columns outgrow."""
    from test_torch_raster import projection_table
    x = projection_table(5, resolution=16, n_levels=8, invalid_run=40)
    cell, offsets, slot_row = csr(x, 16, np.random.default_rng(span))
    got = order_mirror(cell, offsets, slot_row, span=span, stage=stage)
    kept = np.flatnonzero(cell >= 0)
    want = kept[np.argsort(cell[kept], kind="stable")]
    assert np.array_equal(got, want)
    if stage < 4096:                   # a segment outgrows span and stage
        assert int(np.diff(offsets).max()) > max(span, stage)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("tile_n", [None, 64])
def test_projection_walk_mirror_gives_the_twin_chain(dtype, shuffle, tile_n):
    """The kernel's walk, fed the mirrored order step, against the twins'
    chain over ``tile_n``-row tiles with a random seed: bitwise on a
    level-sorted table (no restart) and on a shuffled one (restarts)."""
    from test_torch_raster import projection_table
    res = 16
    x = projection_table(7, resolution=res, n_levels=8)
    x = {**x, "values": x["values"].astype(dtype)}
    if shuffle:
        x = shuffled(x, seed=7)
    rng = np.random.default_rng(11)
    cell, offsets, slot_row = csr(x, res, rng)
    order = order_mirror(cell, offsets, slot_row, span=64, stage=32)
    img0 = rng.standard_normal((res, res)).astype(dtype)
    got, restarts = projection_mirror(x, order, offsets, resolution=res,
                                      tile_n=tile_n, img0=img0)
    t = tensors(x)
    want = ref.projection_raster_ref(
        ops.plane_coords(t["coords"], 2), t["levels"], t["values"], t["ok"],
        resolution=res, n_levels=x["n_levels"], init=torch.from_numpy(img0),
        tile_n=tile_n)
    assert_bits(got, want.numpy(), f"walk shuffle={shuffle}")
    assert (restarts > 0) == (shuffle and tile_n is not None)


@pytest.mark.parametrize("kind", ["slice", "projection"])
def test_shard_call_cut_at_the_row_limit(big_arrays, monkeypatch, kind):
    """``ops._run_shard`` past ``raster.MAX_ROWS`` rows: calls of whole
    ``tile_n``-row tiles chained through the carry, bit-equal to the
    twins' chain (the wrappers run the twins on the CPU); without
    ``tile_n`` the wrapper refuses the table."""
    x = shuffled(table(big_arrays), seed=5)
    tile_n = 512
    want = partial(x, kind, resolution=64, tile_n=tile_n, backend="ref")
    t = tensors(x)
    c2 = ops.plane_coords(t["coords"], 2)
    lv = t["levels"].to(torch.int32)
    geo = dict(resolution=64, n_levels=x["n_levels"])
    calls = []
    if kind == "slice":
        cols = (c2, t["coords"][:, 2].to(torch.int32), lv, t["values"],
                t["ok"])
        seed = (torch.full((64, 64), float("nan"), dtype=torch.float64),
                torch.full((64, 64), -1, dtype=torch.int32))

        def call(*a, tn=tile_n):
            calls.append(a[0].shape[0])
            return raster.slice_raster_carry(*a[:5], position=0.5,
                                             init=a[5:], **geo)
    else:
        cols = (c2, lv, t["values"], t["ok"])
        seed = (torch.zeros((64, 64), dtype=torch.float64),)

        def call(*a, tn=tile_n):
            calls.append(a[0].shape[0])
            return (raster.projection_raster_carry(*a[:4], init=a[4],
                                                   tile_n=tn, **geo),)

    monkeypatch.setattr(raster, "MAX_ROWS", 3 * tile_n + 100)
    got = ops._run_shard(call, cols, seed, tile_n=tile_n,
                         block_n=ops.BLOCK_N)
    n = x["values"].shape[0]
    assert calls == [3 * tile_n] * (n // (3 * tile_n)) + \
        ([n % (3 * tile_n)] if n % (3 * tile_n) else [])
    for g, w in zip(got, want):
        assert_bits(bits(g), bits(w), f"{kind} cut at the row limit")
    with pytest.raises(ValueError, match="int32 row index"):
        if kind == "slice":
            raster._slice_columns("slice_raster_carry", *cols)
        else:
            raster._projection("raster_projection_carry_f64", 0, *cols,
                               64, x["n_levels"], seed[0], tile_n)


# --------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_n", [512, 4096])
def test_cuda_one_call_bit_equal_to_twin_chain(cuda_device, big_arrays,
                                               tile_n, dtype, shuffle):
    """B4/B5 (and -f32) in one call a table against the twins' chain on
    the card, bitwise; one launch each."""
    x = table(big_arrays, dtype)
    if shuffle:
        x = shuffled(x, seed=9)
    fx = "" if dtype == np.float64 else "_f32"
    for kind, name in (("slice", "slice_raster_carry"),
                       ("projection", "projection_raster_carry")):
        before = dict(raster.LAUNCHES)
        got = partial(x, kind, resolution=64, tile_n=tile_n,
                      device=cuda_device)
        torch.cuda.synchronize()
        moved = {k: raster.LAUNCHES[k] - before[k] for k in before}
        assert moved == {**dict.fromkeys(before, 0), name + fx: 1}
        want = partial(x, kind, resolution=64, tile_n=tile_n,
                       backend="ref", device=cuda_device)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert_bits(bits(g.cpu()), bits(w.cpu()), f"{name}{fx}")


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [1, 4])
def test_cuda_mesh_launches_once_per_shard(cuda_device, big_arrays,
                                           n_shards):
    dag = red_pt.ReducerDAG([
        red_pt.SliceReducer(field="density", axis=2, position=0.5,
                            resolution=64),
        red_pt.ProjectionReducer(field="density", axis=2, resolution=64)])
    runner = MeshDAGRunner(dag, devices=[cuda_device] * n_shards,
                           tile_n=512)
    raster.reset_launches()
    runner.run(Snapshot(step=0, kind="amr", arrays=big_arrays))
    torch.cuda.synchronize()
    assert raster.LAUNCHES["slice_raster_carry"] == n_shards
    assert raster.LAUNCHES["projection_raster_carry"] == n_shards


@pytest.mark.gpu
def test_cuda_failing_launch_raises(cuda_device, big_arrays, monkeypatch):
    """No fallback: a launch that fails raises out of the partial, after
    one try, and counts nothing."""
    x = table(big_arrays)
    tries = []

    def broken(name, *args):
        tries.append(name)
        raise RuntimeError(f"{name}: launch failed")

    monkeypatch.setattr(raster, "launch", broken)
    before = dict(raster.LAUNCHES)
    for kind in ("slice", "projection"):
        with pytest.raises(RuntimeError, match="launch failed"):
            partial(x, kind, resolution=64, tile_n=512, device=cuda_device)
    assert len(tries) == 2
    assert raster.LAUNCHES == before
