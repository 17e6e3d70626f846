"""A1, the fused attention kernel (``kernels/attention.py``,
``csrc/attention.cu``).

On the card (``gpu`` cases) the kernel is held against the plain version,
``models.attention``'s query-block loop, at the shapes the port runs:
both cells', one of each head dim (64, 128, 192 padded, 256, 8 padded),
GQA and MQA, both windows, whisper's full and cross shapes and a ragged
length. Each is measured against float64 attention of the same bf16
inputs, and the kernel must come as close as the plain version does: its
norm-wise error at most 1.25x the plain version's plus 1e-4, for out,
dq, dk and dv. The two differ by the order of the float32 sums (P is
rounded to bf16 after the normalisation in both), by dP (float32 in the
kernel, bf16 in the plain version), by the backward's P (exp(S - lse) in
the kernel) and by dS's hi + lo split (float32 in the plain version).
The float32 log-sum-exp is held to float64's within 1e-5 (float32
exponentials and sums in another order).

On the CPU the wrapper's Python side is covered: the template a head dim
takes, the padding, the argument checks, the route ``multihead`` takes
(causal attention needs the caller's ``index_positions``) and its
counters.
"""
import importlib.util
import math
import types
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro_torch.kernels import attention as fa
from repro_torch.models import attention as mattn
from repro_torch.models import layers
from repro_torch.models import probe

ROOT = Path(__file__).resolve().parents[1]


def _inputs(b, sq, sk, h, hkv, hd, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda s, n: torch.randn((b, s, n, hd), generator=g).to(
        device=device, dtype=torch.bfloat16)
    return mk(sq, h), mk(sk, hkv), mk(sk, hkv), mk(sq, h)


def _cfg(h, hkv, s, window):
    chunk = 1024 if s % 1024 == 0 else s
    return types.SimpleNamespace(n_heads=h, n_kv_heads=hkv,
                                 attn_chunk=chunk, window=window)


def _plain(q, k, v, causal, window):
    """The plain version, its float32-result products on float32 copies
    of their operands (on the card ``layers.dot`` would take the tensor
    cores and their split kernel, G1, which the kernel is not held
    to)."""
    pos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    with mock.patch.object(layers, "_tensor_cores", lambda a, b: False):
        return mattn._plain(q, k, v, cfg=_cfg(q.shape[2], k.shape[2],
                                              q.shape[1], window),
                            positions=pos, kpos=kpos, causal=causal)


def _visible(sq, sk, causal, window, device):
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok = j <= i
        if window is not None:
            ok &= i - j < window
    return ok


def _exact(q, k, v, dout, causal, window):
    """float64 out, lse, dq, dk, dv of the bf16 inputs, a (batch, head)
    at a time."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    ok = _visible(sq, k.shape[1], causal, window, q.device)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float64, device=q.device)
    dq = torch.empty_like(out)
    dk = torch.zeros(k.shape, dtype=torch.float64, device=q.device)
    dv = torch.zeros_like(dk)
    for bi in range(b):
        for hi in range(h):
            gi = hi // (h // hkv)
            qh, kh, vh = (t[bi, :, x].double().requires_grad_()
                          for t, x in ((q, hi), (k, gi), (v, gi)))
            s = (qh @ kh.T) * hd ** -0.5
            s = s.masked_fill(~ok, -math.inf)
            o = torch.softmax(s, -1) @ vh
            o.backward(dout[bi, :, hi].double())
            out[bi, :, hi] = o.detach()
            lse[bi, hi] = torch.logsumexp(s.detach(), -1)
            dq[bi, :, hi] = qh.grad
            dk[bi, :, gi] += kh.grad
            dv[bi, :, gi] += vh.grad
    return out, lse, dq, dk, dv


def _rel(a, ref) -> float:
    return float((a.detach().double() - ref).norm() / ref.norm())


# ---------------------------------------------------------------- the card

#: (name, B, Sq, Sk, H, Hkv, hd, causal, window)
CARD_SHAPES = [
    ("stablelm", 2, 4096, 4096, 32, 32, 64, True, None),
    ("granite", 2, 4096, 4096, 16, 8, 64, True, None),
    ("minicpm", 1, 2048, 2048, 36, 36, 64, True, None),
    ("internlm2-gqa6", 1, 2048, 2048, 48, 8, 128, True, None),
    ("llava-gqa7", 1, 3072, 3072, 56, 8, 128, True, None),
    ("mixtral-window", 1, 5120, 5120, 48, 8, 128, True, 4096),
    ("nemotron-hd192", 1, 2048, 2048, 8, 8, 192, True, None),
    ("recurrentgemma-mqa", 1, 3072, 3072, 10, 1, 256, True, 2048),
    ("smoke-hd8", 2, 100, 100, 4, 2, 8, True, None),
    ("whisper-full", 2, 1500, 1500, 16, 16, 64, False, None),
    ("whisper-cross", 2, 448, 1500, 16, 16, 64, False, None),
    ("ragged", 1, 1000, 1000, 12, 4, 64, True, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=[s[0] for s in
                                                    CARD_SHAPES])
def test_kernel_against_plain_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, b, sq, sk, h, hkv, hd, causal, window = shape
    q, k, v, dout = _inputs(b, sq, sk, h, hkv, hd, "cuda")
    want = _exact(q, k, v, dout, causal, window)
    got, plain = [], []
    for fn, acc in ((lambda *a: fa.attention(*a, causal=causal,
                                             window=window), got),
                    (lambda *a: _plain(*a, causal, window), plain)):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv)
        out.backward(dout)
        acc += [out, qq.grad, kk.grad, vv.grad]
    for name, x, y, ref in zip(("out", "dq", "dk", "dv"), got, plain,
                               (want[0], *want[2:])):
        assert x.dtype == torch.bfloat16 and x.shape == y.shape, name
        e_kernel, e_plain = _rel(x, ref), _rel(y, ref)
        assert e_kernel <= 1.25 * e_plain + 1e-4, (name, e_kernel, e_plain)
    # the forward's log-sum-exp, as the backward reads it
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa.attention(qq, kk, vv, causal=causal, window=window)
    lse = out.grad_fn.saved_tensors[4]
    torch.testing.assert_close(lse.double(), want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_kernel_backward_is_deterministic_on_the_card():
    """No atomics: two backward passes give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, dout = _inputs(2, 2048, 2048, 16, 8, 64, "cuda", seed=3)
    runs = []
    for _ in range(2):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        fa.attention(qq, kk, vv, causal=True).backward(dout)
        runs.append((qq.grad, kk.grad, vv.grad))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_multihead_takes_the_kernel_on_the_card():
    """A CUDA bf16 call launches A1 once forward and once backward and
    counts as a kernel call; float32 compute keeps the plain loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pr = probe.StepProbe("cuda")
    cfg = types.SimpleNamespace(d_model=64, hd=16, n_heads=4, n_kv_heads=2,
                                rope_theta=1e4, attn_chunk=64, window=None,
                                position_embedding="rope",
                                attention_multiplier=None)
    p = {n: 0.1 * torch.randn(s.shape, device="cuda")
         for n, s in mattn.attn_spec(cfg).items()}
    pos = torch.arange(32, device="cuda")
    before = dict(fa.LAUNCHES)
    with pr.active():
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((2, 32, 64), device="cuda", dtype=dt,
                            requires_grad=True)
            mattn.multihead(p, x, cfg=cfg, positions=pos,
                            index_positions=True).sum().backward()
        counts = pr.attn_counts()
    assert counts == {"attn_calls": 2, "attn_kernel": 1}
    assert fa.LAUNCHES["attn_fwd"] == before["attn_fwd"] + 1
    assert fa.LAUNCHES["attn_bwd"] == before["attn_bwd"] + 1


# ------------------------------------------------------- the wrapper (CPU)

@pytest.mark.parametrize("hd,kd", [(1, 64), (8, 64), (32, 64), (64, 64),
                                   (65, 128), (128, 128), (192, 256),
                                   (256, 256)])
def test_head_dim_takes_the_next_template(hd, kd):
    assert fa.kernel_head_dim(hd) == kd


@pytest.mark.parametrize("hd", [0, 257, 512])
def test_head_dim_past_the_templates_raises(hd):
    with pytest.raises(ValueError, match="head dim"):
        fa.kernel_head_dim(hd)


def test_padding_adds_zero_columns_and_keeps_the_rest():
    x = torch.randn(2, 5, 3, 24).to(torch.bfloat16)
    p = fa._padded(x.transpose(1, 2).contiguous().transpose(1, 2), 64)
    assert p.shape == (2, 5, 3, 64) and p.is_contiguous()
    assert torch.equal(p[..., :24], x) and not p[..., 24:].any()
    assert fa._padded(p, 64) is p


def _bad(**kw):
    b, sq, sk, h, hkv, hd = 1, 8, 8, 4, 2, 64
    q = torch.zeros((b, sq, h, hd), dtype=torch.bfloat16)
    k = torch.zeros((b, sk, hkv, hd), dtype=torch.bfloat16)
    args = dict(q=q, k=k, v=k.clone(), causal=True, window=None)
    args.update(kw)
    return args


@pytest.mark.parametrize("kw,err,match", [
    (dict(q=torch.zeros((1, 8, 4, 64))), TypeError, "bfloat16"),
    (dict(v=torch.zeros((1, 8, 2, 64), dtype=torch.float16)), TypeError,
     "bfloat16"),
    (dict(q=torch.zeros((8, 4, 64), dtype=torch.bfloat16)), ValueError,
     "shape"),
    (dict(k=torch.zeros((1, 8, 3, 64), dtype=torch.bfloat16),
          v=torch.zeros((1, 8, 3, 64), dtype=torch.bfloat16)), ValueError,
     "kv heads"),
    (dict(k=torch.zeros((1, 9, 2, 64), dtype=torch.bfloat16),
          v=torch.zeros((1, 9, 2, 64), dtype=torch.bfloat16)), ValueError,
     "causal"),
    (dict(v=torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16)), ValueError,
     "match"),
    (dict(causal=False, window=4), ValueError, "window"),
    (dict(window=0), ValueError, "window"),
    (dict(q=torch.zeros((1, 8, 4, 300), dtype=torch.bfloat16),
          k=torch.zeros((1, 8, 2, 300), dtype=torch.bfloat16),
          v=torch.zeros((1, 8, 2, 300), dtype=torch.bfloat16)), ValueError,
     "head dim"),
])
def test_check_refuses_what_the_kernel_does_not_take(kw, err, match):
    a = _bad(**kw)
    with pytest.raises(err, match=match):
        fa.check(a["q"], a["k"], a["v"], a["causal"], a["window"])


def test_check_takes_gqa_cross_and_window():
    fa.check(**_bad())
    fa.check(**_bad(window=3))
    a = _bad(k=torch.zeros((1, 20, 1, 64), dtype=torch.bfloat16),
             causal=False)
    a["v"] = a["k"]
    fa.check(**a)


def test_wrapper_refuses_cpu_tensors():
    a = _bad()
    with pytest.raises(ValueError, match="plain"):
        fa.attention(a["q"], a["k"], a["v"], causal=True)


def test_c_entries_are_declared():
    from repro_torch.kernels import cudalib
    assert len(cudalib.SIGNATURES["attn_fwd"]) == 16
    assert len(cudalib.SIGNATURES["attn_bwd"]) == 21


def test_multihead_on_the_cpu_takes_the_plain_path_and_counts():
    """On the CPU every call takes the plain loop: the probe reads
    ``attn_kernel`` 0 of ``attn_calls`` N, the backward's calls (remat's
    recompute) are not counted, and nothing launches."""
    cfg = types.SimpleNamespace(d_model=32, hd=8, n_heads=4, n_kv_heads=2,
                                rope_theta=1e4, attn_chunk=16, window=None,
                                position_embedding="rope",
                                attention_multiplier=None)
    g = torch.Generator().manual_seed(0)
    p = {n: 0.1 * torch.randn(s.shape, generator=g)
         for n, s in mattn.attn_spec(cfg).items()}
    pos = torch.arange(32)
    x = torch.randn((2, 32, 32), generator=g).to(torch.bfloat16)
    before = dict(fa.LAUNCHES)
    pr = probe.StepProbe("cpu")
    with pr.active():
        ys = [mattn.multihead(p, x, cfg=cfg, positions=pos)
              for _ in range(3)]
        assert not mattn._fused(x)
    assert pr.attn_counts() == {"attn_calls": 3, "attn_kernel": 0}
    assert fa.LAUNCHES == before
    assert all(torch.equal(y, ys[0]) for y in ys)
    # the plain version is the query-block loop as it was
    q = torch.randn((2, 32, 4, 8), generator=g).to(torch.bfloat16)
    k = torch.randn((2, 32, 2, 8), generator=g).to(torch.bfloat16)
    kr = mattn._repeat_kv(k, 2)
    want = torch.cat([mattn._sdpa(
        q[:, i:i + 16], kr, kr, mattn._mask_bias(pos[i:i + 16], pos, None))
        for i in range(0, 32, 16)], dim=1)
    got = mattn._plain(q, k, k, cfg=cfg, positions=pos, kpos=pos,
                       causal=True)
    assert torch.equal(got, want)
    assert probe.StepProbe("cpu").attn_counts() == {}


def test_kernel_share_metric_reads_the_counters():
    spec = importlib.util.spec_from_file_location(
        "attn_kernel_share", ROOT / "portbench" / "metrics" /
        "attn.kernel_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    step = lambda **a: {"name": "train.step", "args": {"step": 1, **a}}
    assert mod.read({"spans": [step()]}) is None
    assert mod.read({}) is None
    assert mod.read({"spans": [
        step(attn_calls=24, attn_kernel=24),
        step(attn_calls=24, attn_kernel=12),
        {"name": "block.attention", "args": {"device_ms": 1.0}}]}) == 75.0


@pytest.mark.parametrize("causal,index_positions,offset,kernel", [
    (True, False, 0, False),      # causal, no fact: the plain loop
    (True, False, 5, False),      # offset positions stay on the plain loop
    (True, True, 0, True),        # the caller states 0 ... S-1
    (False, False, 5, True),      # no mask: positions are not read
])
def test_multihead_routes_causal_attention_by_the_callers_positions(
        causal, index_positions, offset, kernel, monkeypatch):
    """The kernel masks by index and reads no positions, so a causal call
    reaches it only with ``index_positions``; any other causal call
    (offset positions here) takes the plain loop, whose mask reads them.
    The kernel is stood in for by the plain version on the CPU."""
    cfg = types.SimpleNamespace(d_model=32, hd=8, n_heads=4, n_kv_heads=2,
                                rope_theta=1e4, attn_chunk=16, window=None,
                                position_embedding="rope",
                                attention_multiplier=None)
    g = torch.Generator().manual_seed(1)
    p = {n: 0.1 * torch.randn(s.shape, generator=g)
         for n, s in mattn.attn_spec(cfg).items()}
    x = torch.randn((2, 32, 32), generator=g).to(torch.bfloat16)
    pos = torch.arange(32) + offset
    taken = []

    def stand_in(q, k, v, *, causal, window=None, scale=None):
        fa.check(q, k, v, causal, window)
        taken.append(q.shape)
        i = torch.arange(q.shape[1])
        return mattn._plain(q, k, v, cfg=cfg, positions=i, kpos=i,
                            causal=causal, scale=scale)
    monkeypatch.setattr(mattn, "_fused", lambda q: True)
    monkeypatch.setattr(fa, "attention", stand_in)
    pr = probe.StepProbe("cpu")
    with pr.active():
        got = mattn.multihead(p, x, cfg=cfg, positions=pos, causal=causal,
                              index_positions=index_positions)
    assert len(taken) == int(kernel)
    assert pr.attn_counts() == {"attn_calls": 1, "attn_kernel": int(kernel)}
    monkeypatch.setattr(mattn, "_fused", lambda q: False)
    want = mattn.multihead(p, x, cfg=cfg, positions=pos, causal=causal)
    assert torch.equal(got, want)
