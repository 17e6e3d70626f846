"""Float32-result products of bf16 operands on the tensor cores
(``models.layers._BF16F32Dot``) and G1, the exact three-piece bf16 split
of their float32 cotangent (``kernels/bf16split.py``,
``csrc/bf16split.cu``).

On the CPU: the split's plain version is exact (hi + mid + lo is the
float32 value, bit for bit in float64) over the exponent range where
its pieces stay normal, with signs, zeros, rounding ties and values past
bf16's largest finite one; the function, whose products run on float32
copies on the CPU, gives ``torch.einsum`` of float32 copies up to the
order of the sums, forward and both gradients, for every form the model
uses; ``dot`` on CPU tensors is unchanged bit for bit; the step's
counters count each product of the forward once.

On the card (``gpu`` cases): the kernel gives its plain version's bits,
on whole matrices and column blocks, aligned or not, and the function
gives the CPU's values up to the order of the sums.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import bf16split, cudalib
from repro_torch.models import layers, probe
from repro_torch.models.transformer import LM

ROOT = Path(__file__).resolve().parents[1]
BF16_MAX = float(torch.finfo(torch.bfloat16).max)
#: below this the pieces of a float32 value may fall under bf16's
#: smallest normal (2^-126) and lose bits; above it the split is exact
EXACT_FROM = 2.0 ** -102

#: the float32-result products the port makes: (equation, a, b)
FORMS = [
    ("...d,df->...f", (2, 9, 24), (24, 40)),         # MLP wi / wg
    ("...d,dv->...v", (2, 9, 24), (24, 300)),        # untied head
    ("gtd,de->gte", (2, 9, 24), (24, 8)),            # MoE router
    ("ecd,edf->ecf", (4, 9, 24), (4, 24, 40)),       # MoE experts
    ("bqhd,bkhd->bhqk", (2, 9, 3, 16), (2, 11, 3, 16)),    # plain scores
    ("bqhrd,bkhd->bhrqk", (2, 1, 3, 2, 16), (2, 11, 3, 16)),  # decode
]


def _values(n, seed=0):
    """float32 values over [EXACT_FROM, max] with random signs and
    significands, zeros, and values at bf16 rounding ties: halfway
    between two bf16 values for hi, and halfway again below for mid."""
    g = torch.Generator().manual_seed(seed)
    e = torch.randint(-102, 128, (n,), generator=g).float()
    m = 1 + torch.rand(n, generator=g)
    x = (m * torch.exp2(e - 1)).float()
    x = torch.where(torch.isinf(x), torch.finfo(torch.float32).max, x)
    sign = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    x = x * sign
    base = torch.exp2(torch.randint(-90, 120, (64,), generator=g).float())
    ties = torch.cat([
        base * (1 + 2.0 ** -8),                       # hi tie, even below
        base * (1 + 3 * 2.0 ** -8),                   # hi tie, odd below
        base * (1 + 2.0 ** -7 + 2.0 ** -16),          # mid tie
        -base * (1 + 2.0 ** -8 + 2.0 ** -17),         # hi and mid ties
        base * (1 + 2.0 ** -8 + 2.0 ** -16 + 2.0 ** -23)])
    big = torch.tensor([BF16_MAX, 3.3961e38, 3.4e38,
                        float(torch.finfo(torch.float32).max)])
    return torch.cat([x, ties.float(), big, -big, torch.zeros(2),
                      -torch.zeros(2), torch.tensor([EXACT_FROM,
                                                     -EXACT_FROM])])


def _exact(pieces, g):
    """hi + mid + lo in float64 against g: bit for bit."""
    return torch.equal(pieces.double().sum(dim=-2), g.double())


def test_split_twin_is_exact_over_the_exponent_range():
    x = _values(40_000)
    g = x[: x.numel() // 8 * 8].view(-1, 8)
    p = bf16split.split_ref(g)
    assert p.shape == (g.shape[0], 3, 8) and p.dtype == torch.bfloat16
    assert _exact(p, g)
    # hi is the nearest bf16 value wherever that is finite, mid the
    # nearest to what is left
    hi, mid, lo = p.unbind(-2)
    fits = g.abs() <= BF16_MAX
    assert torch.equal(hi[fits], g[fits].to(torch.bfloat16))
    assert torch.equal(mid, (g - hi.float()).to(torch.bfloat16))
    # past bf16's largest finite value hi is truncated, never inf
    assert torch.isfinite(hi.float()).all()
    assert (~fits).sum() >= 4


def test_split_twin_pieces_are_ordered_and_signed():
    """Each piece is at most half a bf16 ulp of the one before (so three
    of 8 bits hold 24), and may carry the other sign."""
    g = _values(8_000, seed=1)
    g = g[g.abs() <= BF16_MAX]
    p = bf16split.split_ref(g[None])[0].float()
    hi, mid, lo = p
    ok = hi != 0
    assert (mid[ok].abs() <= hi[ok].abs() * 2.0 ** -8).all()
    ok = mid != 0
    assert (lo[ok].abs() <= mid[ok].abs() * 2.0 ** -8).all()
    assert ((mid * hi) < 0).any()


def test_split_twin_non_finite_and_zero():
    g = torch.tensor([[float("inf"), -float("inf"), float("nan"), 0.0,
                       -0.0, 1.0, 1e-30, -2.5]])
    hi, mid, lo = bf16split.split_ref(g)[0]
    assert hi[0] == float("inf") and hi[1] == -float("inf")
    assert torch.isnan(hi[2])
    assert (mid[:3] == 0).all() and (lo[:3] == 0).all()
    assert torch.equal(torch.signbit(hi[3:5]), torch.tensor([False, True]))
    assert _exact(bf16split.split_ref(g[:, 3:]), g[:, 3:])


def test_split_wrapper_takes_column_blocks_and_checks():
    g = _values(4_096, seed=2)[:4_000].view(40, 100)
    block = g[:, 12:60]
    assert block.stride() == (100, 1)
    assert torch.equal(bf16split.split(block),
                       bf16split.split_ref(block.contiguous()))
    with pytest.raises(TypeError, match="float32"):
        bf16split.split(g.double())
    with pytest.raises(ValueError, match="rows, n"):
        bf16split.split(g[0])
    before = dict(bf16split.LAUNCHES)
    bf16split.split(g)
    assert bf16split.LAUNCHES == before       # the CPU launches nothing


def test_c_entry_is_declared():
    assert cudalib.SIGNATURES["bf16x3_split"] == [
        cudalib._p, cudalib._p, cudalib._i64, cudalib._i64, cudalib._i64,
        cudalib._i32, cudalib._p]


def _operands(sa, sb, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(sa, generator=g).to(torch.bfloat16)
    b = torch.randn(sb, generator=g).to(torch.bfloat16)
    return a, b


def _close_to_f32_sums(got, a, b, eq, want):
    """``got`` is ``want`` up to the order of float32 sums: within a few
    float32 ulps of the sum of absolute products."""
    scale = torch.einsum(eq, a.double().abs(), b.double().abs())
    err = (got.double() - want.double()).abs()
    assert (err <= 8 * 2.0 ** -24 * scale + 1e-30).all(), \
        float((err / scale.clamp_min(1e-30)).max())


def _within_one_bf16_rounding(got, want_f32):
    """A gradient rounded once to bf16 against the float32 one rounded to
    bf16: the two float32 values differ by summation order alone, so the
    bf16 values are equal or neighbours."""
    assert got.dtype == torch.bfloat16
    err = (got.float() - want_f32).abs()
    assert (err <= 2.0 ** -7 * want_f32.abs() + 1e-30).all()


@pytest.mark.parametrize("eq,sa,sb", FORMS, ids=[f[0] for f in FORMS])
def test_function_matches_einsum_of_float32_copies(eq, sa, sb):
    a, b = _operands(sa, sb, seed=len(eq))
    plan = layers._bmm_plan(eq, sa, sb)
    assert plan is not None
    aa, bb = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = layers._BF16F32Dot.apply(aa, bb, plan)
    a32, b32 = a.float().requires_grad_(), b.float().requires_grad_()
    want = torch.einsum(eq, a32, b32)
    assert out.shape == want.shape and out.dtype == torch.float32
    _close_to_f32_sums(out.detach(), a, b, eq, want.detach())
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(5))
    out.backward(g)
    want.backward(g)
    assert aa.grad.shape == a.shape and bb.grad.shape == b.shape
    _within_one_bf16_rounding(aa.grad, a32.grad)
    _within_one_bf16_rounding(bb.grad, b32.grad)


@pytest.mark.parametrize("eq,sa,sb", FORMS[:4], ids=[f[0] for f in
                                                      FORMS[:4]])
def test_function_column_blocks_give_the_one_block_values(eq, sa, sb,
                                                          monkeypatch):
    """With the pieces cut into column blocks of 64 the gradients are the
    one block's up to the order of the sums (dA adds block to block in
    float32; dB's blocks are its columns)."""
    a, b = _operands(sa, sb, seed=7)
    plan = layers._bmm_plan(eq, sa, sb)
    n = plan.canon_c[-1]
    rows = 1
    for d in plan.canon_c[:-1]:
        rows *= d
    grads = []
    for limit in (layers.SPLIT_BLOCK_BYTES, 6 * rows * 64):
        monkeypatch.setattr(layers, "SPLIT_BLOCK_BYTES", limit)
        aa, bb = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = layers._BF16F32Dot.apply(aa, bb, plan)
        out.backward(torch.ones_like(out) / 7)
        grads.append((aa.grad.float(), bb.grad.float()))
    if n > 64:
        for x, y in zip(*grads):
            assert (x - y).abs().max() <= 2.0 ** -7 * x.abs().max()


def test_plan_refuses_what_is_no_single_product():
    assert layers._bmm_plan("ii,ij->ij", (3, 3), (3, 4)) is None
    assert layers._bmm_plan("ij,jk->i", (3, 4), (4, 5)) is None
    assert layers._bmm_plan("ij,jk->ik", (3, 4), (5, 6)) is None
    p = layers._bmm_plan("...d,df->...f", (2, 9, 24), (24, 40))
    assert (p.perm_a, p.perm_b, p.perm_c) == (None, None, None)
    assert (p.canon_a, p.canon_b, p.canon_c) == ((18, 24), (24, 40),
                                                 (18, 40))
    p = layers._bmm_plan("ecd,edf->ecf", (4, 9, 24), (4, 24, 40))
    assert p.canon_c == (4, 9, 40)


@pytest.mark.parametrize("eq,sa,sb", FORMS, ids=[f[0] for f in FORMS])
def test_dot_on_cpu_tensors_is_unchanged(eq, sa, sb):
    """On the CPU ``dot(f32=True)`` is the float32 product of float32
    copies, forward and backward, bit for bit, and launches nothing."""
    a, b = _operands(sa, sb, seed=3)
    assert not layers._tensor_cores(a, b)
    aa, bb = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = layers.dot(eq, aa, bb, f32=True)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.einsum(eq, a2.float(), b2.float())
    assert torch.equal(out, want)
    g = torch.randn(want.shape, generator=torch.Generator().manual_seed(2))
    out.backward(g)
    want.backward(g)
    assert torch.equal(aa.grad, a2.grad) and torch.equal(bb.grad, b2.grad)


def test_route_refuses_cpu_and_float32_operands():
    a, b = _operands((4, 8), (8, 4), seed=0)
    assert not layers._tensor_cores(a, b)               # the CPU
    assert not layers._tensor_cores(a.float(), b.float())


def _loss(lm, tokens):
    return lm.loss_fn(lm.param_tree(), {
        "tokens": tokens, "labels": torch.roll(tokens, -1, 1)})[0]


@pytest.mark.parametrize("arch,per_layer", [("stablelm_1_6b", 3),
                                            ("granite_moe_1b_a400m", 4)])
def test_counters_count_each_product_once(arch, per_layer, monkeypatch):
    """``dot_f32`` is one per float32-result product of the forward (a
    layer: the MLP's wi and wg, or the router and the experts' wi and
    wg, and on the CPU the plain attention's scores, one query block
    here; then the head), remat's recompute not counted again; ``dot_tc`` those
    that took the function: none on the CPU, all where the route is
    forced (the function then runs its plain version), with the loss
    and gradients the float32 copies' up to the order of the sums."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat="full",
                              compute_dtype="bfloat16")
    lm = LM(cfg, device="cpu")
    lm.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    want = per_layer * cfg.n_layers + 1
    grads = {}
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(layers, "_tensor_cores",
                                lambda a, b: a.dtype == torch.bfloat16)
        pr = probe.StepProbe("cpu")
        with pr.active():
            loss = _loss(lm, tokens)
            grads[forced] = (loss.item(), torch.autograd.grad(
                loss, list(lm.parameters())))
        assert pr.dot_counts() == {"dot_f32": want,
                                   "dot_tc": want if forced else 0}
    (l0, g0), (l1, g1) = grads[False], grads[True]
    assert abs(l0 - l1) <= 1e-5 * abs(l0)
    for x, y in zip(g0, g1):
        assert (x - y).norm() <= 2e-2 * x.norm() + 1e-12


def test_train_step_span_carries_the_counters(tmp_path):
    """Each traced step's ``train.step`` span carries the step's counts,
    the same every step (remat's recompute not counted)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.obs.trace import TRACER
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(get_smoke_config("stablelm_1_6b"),
                              remat="full")
    lm = LM(cfg, device="cpu")
    lm.init(torch.Generator().manual_seed(0))
    tr = Trainer(lm, ckpt_dir=str(tmp_path / "ckpt"), log_every=0,
                 data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                     global_batch=2), device="cpu")
    TRACER.clear()
    TRACER.enable()
    try:
        tr.run(2)
        steps = [sp["args"] for sp in TRACER.spans()
                 if sp["name"] == "train.step"]
    finally:
        TRACER.disable()
        TRACER.clear()
    assert [(a["dot_f32"], a["dot_tc"]) for a in steps] == \
        [(3 * cfg.n_layers + 1, 0)] * 2


def test_no_products_no_counters():
    assert probe.StepProbe("cpu").dot_counts() == {}


def test_tc_share_metric_reads_the_counters():
    spec = importlib.util.spec_from_file_location(
        "dot_tc_share", ROOT / "portbench" / "metrics" / "dot.tc_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    step = lambda **a: {"name": "train.step", "args": {"step": 1, **a}}
    assert mod.read({"spans": [step()]}) is None
    assert mod.read({}) is None
    assert mod.read({"spans": [
        step(dot_f32=49, dot_tc=49), step(dot_f32=49, dot_tc=0),
        {"name": "block.ffn", "args": {"device_ms": 1.0}}]}) == 50.0


# ------------------------------------------------------------ the card

@pytest.mark.gpu
def test_kernel_gives_the_twins_bits_on_the_card():
    """Whole matrices (the vector path) and column blocks, aligned or
    not (the one-value path), against the plain version on the CPU; NaN
    in the same places (its bits may differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _values(200_000, seed=4)
    x[:7] = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0,
                          -0.0, 2.0 ** -140, -(2.0 ** -149)])
    for rows, n, c0, c1 in ((100, 2000, 0, 2000), (100, 2000, 100, 1124),
                            (97, 2001, 0, 2001), (100, 2000, 3, 1003)):
        g = x[: rows * n].view(rows, n)[:, c0:c1]
        before = bf16split.LAUNCHES["bf16x3_split"]
        got = bf16split.split(g.cuda()).cpu()
        assert bf16split.LAUNCHES["bf16x3_split"] == before + 1
        want = bf16split.split_ref(g.contiguous())
        nan = torch.isnan(want.float())
        assert torch.equal(torch.isnan(got.float()), nan)
        assert torch.equal(got.view(torch.int16)[~nan],
                           want.view(torch.int16)[~nan])


@pytest.mark.gpu
@pytest.mark.parametrize("eq,sa,sb", FORMS, ids=[f[0] for f in FORMS])
def test_function_on_the_card_gives_the_cpu_values(eq, sa, sb,
                                                   monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = _operands(sa, sb, seed=11)
    plan = layers._bmm_plan(eq, sa, sb)
    g = torch.randn(torch.einsum(eq, a.float(), b.float()).shape,
                    generator=torch.Generator().manual_seed(6))
    for limit in (layers.SPLIT_BLOCK_BYTES, 6 * 64 * 64):
        monkeypatch.setattr(layers, "SPLIT_BLOCK_BYTES", limit)
        runs = []
        for dev in ("cpu", "cuda"):
            aa = a.detach().to(dev).requires_grad_()
            bb = b.detach().to(dev).requires_grad_()
            assert layers._tensor_cores(aa, bb) == (dev == "cuda")
            out = layers._BF16F32Dot.apply(aa, bb, plan)
            out.backward(g.to(dev))
            runs.append([t.detach().cpu() for t in (out, aa.grad,
                                                    bb.grad)])
        (o0, da0, db0), (o1, da1, db1) = runs
        _close_to_f32_sums(o1, a, b, eq, o0)
        _within_one_bf16_rounding(da1, da0.float())
        _within_one_bf16_rounding(db1, db0.float())
