"""granite-4.0-h-small in the port: Mamba-2 and NoPE-attention layers,
each followed by routed experts and a shared expert, with Granite's
multipliers, and the expert layer that holds only a share of the experts.

The port is held to portbench's plain float32 reference of the family
(``portbench/reference/granite_hybrid_lm.py``, loaded by path) at the
``SMOKE`` size on the CPU, at float32 compute. On the card (``gpu``
case) A1 takes the configuration's softmax scale at its attention
shape."""
import dataclasses
import importlib.util
import math
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro_torch.configs import ARCHS, PORT_ARCHS, get_config, \
    get_smoke_config
from repro_torch.configs.granite_4_0_h_small import SHARE
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as mattn
from repro_torch.models import layers, moe, serving, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, tree_leaves
from repro_torch.obs.trace import TRACER
from repro_torch.train import optim, step

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite_4_0_h_small"


def _reference():
    path = ROOT / "portbench" / "reference" / "granite_hybrid_lm.py"
    spec = importlib.util.spec_from_file_location("granite_hybrid_lm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()
CPU = torch.device("cpu")
#: AdamW as portbench's training mix runs it
OPT = dict(lr=3e-4, warmup_steps=100, stable_steps=10000, decay_steps=2000,
           min_lr_ratio=0.1, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
           clip_norm=1.0)


def _model(**overrides) -> dict:
    """The smoke config at float32 compute (5 layers: 4 Mamba-2 and 1
    attention, 16 experts, top-4, a shared expert, chunk 8) as the
    reference's ``model`` table."""
    cfg = dataclasses.replace(get_smoke_config(ARCH),
                              compute_dtype="float32", **overrides)
    return dataclasses.asdict(cfg)


def _batch(seq: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, 256, (2, seq), generator=g),
            torch.randint(0, 256, (2, seq), generator=g))


# ------------------------------------------------------------ the presets


def test_presets_are_the_published_widths_and_the_stated_share():
    full, share = get_config(ARCH), SHARE
    pattern = ("ssm_moe",) * 5 + ("moe",) + ("ssm_moe",) * 4
    assert full.layer_kinds() == list(pattern) * 4
    want = dict(n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, hd=128,
                d_ff=768, vocab_size=100352, n_experts=72, top_k=10,
                n_held=72, shared_ff=1536, ssm_state=128, ssm_head_dim=64,
                ssm_heads=128, d_inner=8192, ssm_conv=4, ssm_conv_xbc=True,
                ssm_chunk=256, position_embedding="nope",
                attention_multiplier=1 / 128, embedding_multiplier=12.0,
                residual_multiplier=0.22, logits_scaling=16.0, norm_eps=1e-5,
                tie_embeddings=True)
    assert {k: getattr(full, k) for k in want} == want
    # one device's share: one period, experts 0-8 of each layer
    assert dataclasses.replace(share, n_layers=40, experts_held=0,
                               name=full.name) == full
    assert (share.n_layers, share.n_held) == (10, 9)
    # the name portbench's configuration gives the share finds it
    assert get_config("granite_4_0_h_small_ep8") is share
    params = LM(share, device="meta").param_tree()
    assert sum(p.numel() for _, p in tree_leaves(params)) == 2_414_692_992
    # the JAX package has no such config: the assigned list pairs none
    assert not set(PORT_ARCHS) & set(ARCHS)


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_launcher_trains_the_smoke_config(tmp_path, capsys, arch):
    assert train_cli.main(["--arch", arch, "--smoke", "--steps", "10",
                           "--seq-len", "16", "--global-batch", "2",
                           "--ckpt-dir", str(tmp_path / "ck"),
                           "--ckpt-every", "10", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.split("step    10 loss ")[1]
    assert math.isfinite(float(line.split()[0]))


def test_serving_refuses_the_pattern():
    lm = LM(get_smoke_config(ARCH), device="cpu")
    with pytest.raises(NotImplementedError, match="Mamba-2 \\+ MoE"):
        serving.cache_specs(lm, 2, 16)


def test_conv_over_xbc_refuses_a_decode_cache():
    """The Mamba-2 mixer with its conv over x, B and C runs over full
    sequences; handed a decode cache it raises, where a cache of x's
    conv alone would give wrong values."""
    cfg = get_smoke_config(ARCH)
    lm = LM(cfg, device="cpu")
    p = lm.param_tree()["blocks"]["sub0_ssm_moe"]["ssm"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.zeros((2, 1, cfg.d_model))
    cache = {"conv": torch.zeros((2, cfg.ssm_conv - 1, cfg.d_inner)),
             "state": torch.zeros((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state))}
    with pytest.raises(NotImplementedError, match="full sequences"):
        ssm.ssm_block(p, x, cfg, cache=cache, pos=0)


# ------------------------------------------------- against the reference


@pytest.mark.parametrize("seq", [32, 1024])
def test_port_is_the_reference(seq):
    """One train step of the port at float32 compute, 4 of 16 experts
    held, against the plain reference: loss, every leaf's gradient, and
    AdamW's first update. At 1,024 x 2 tokens the MoE dispatches in 2
    groups (2,048 tokens) and the SSD runs 128 chunks."""
    m = _model(experts_held=4)
    tokens, labels = _batch(seq, 7)
    lm = LM(ModelConfig(**m), device="cpu")
    lm.load_param_tree(REF.nest(REF.make_params(m, 11, CPU)))
    metrics, grads = step.loss_and_grads(lm, lm.param_tree(),
                                         {"tokens": tokens,
                                          "labels": labels})
    leaves = {k: v.requires_grad_(True)
              for k, v in REF.make_params(m, 11, CPU).items()}
    nll, aux = REF.loss(leaves, tokens, labels, m)
    g_ref = dict(zip(leaves, torch.autograd.grad(nll + 0.01 * aux,
                                                 list(leaves.values()))))
    # float32 sums in another order: a few ulps of a loss near 5.8 (the
    # tolerances of portbench's own test of the reference)
    assert float(metrics["loss"]) == pytest.approx(float(nll), rel=2e-6)
    assert float(metrics["aux"]) == pytest.approx(float(aux), rel=2e-6)
    flat = dict(tree_leaves(grads))
    assert flat.keys() == g_ref.keys()
    for k, g in g_ref.items():
        # each leaf to float32 roundoff of its largest entry; the SSD's
        # chunk decays are exps of differences of float32 cumsums, which
        # the two compute in another order
        scale = float(g.abs().max())
        assert float((flat[k] - g).abs().max()) <= 1e-4 * scale, k

    state = {"params": lm.param_tree(),
             **optim.init_opt_state(lm.param_tree())}
    optim.adamw_step(state["params"], grads, state, optim.OptConfig(**OPT))
    r = REF.train(m, OPT, REF.make_params(m, 11, CPU), [(tokens, labels)])
    p0 = REF.make_params(m, 11, CPU)
    mus = dict(tree_leaves(state["mu"]))
    for k, x in tree_leaves(state["params"]):
        # Adam's first step is +-lr an entry whatever the gradient's size,
        # so a norm of the change holds where entries could flip sign
        change = float((x.detach() - p0[k]).double().norm())
        assert change == pytest.approx(r["change_norm"][k], rel=1e-4), k
        mu = float(mus[k].double().norm()) / (1 - OPT["b1"])
        assert mu == pytest.approx(r["grad_norm"][k], rel=1e-5), k


def _rolled(p: dict, shift: int, held: int) -> dict:
    """The expert layer's parameters with the router's columns rolled by
    ``shift``, so that experts shift ... shift + held - 1 come first, and
    those experts' weights: the share that holds them, in the port's
    layout (a layer holds its first experts)."""
    out = dict(p, router=torch.roll(p["router"], -shift, dims=1))
    for w in ("wi", "wg", "wo"):
        out[w] = p[w][shift:shift + held]
    return out


@pytest.mark.parametrize("seq", [32, 1024])
def test_shares_add_up_to_the_whole_layer(seq):
    """The four 4-expert shares of a 16-expert layer, each computed by
    the port's expert layer as a device holding them, add up, with the
    shared expert counted once, to the uncut reference's whole layer; the
    aux loss, over the whole router, is the same in every share."""
    m = _model()
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, seq, m["d_model"]), generator=g)
    lay = {path: shape for path, shape, _, _ in REF.layout(m)}
    head = "blocks.sub0_ssm_moe.moe."
    p = {k[len(head):]: torch.randn(lay[k][1:], generator=g) / math.sqrt(
        lay[k][-2]) for k in lay if k.startswith(head)}
    whole, aux = REF._moe(x, {f"moe.{k}": v for k, v in p.items()}, m, None)
    share_cfg = ModelConfig(**dict(m, experts_held=4))
    tree = REF.nest(p)
    shared = layers.mlp(tree["shared"], x, share_cfg)
    parts = []
    for j in range(4):
        y, a = moe.moe_mlp(_rolled(tree, 4 * j, 4), x, share_cfg)
        parts.append(y)
        assert float(a) == pytest.approx(float(aux), rel=1e-5)
    got = sum(parts) - 3 * shared
    # float32 products and sums in another order
    assert float((got - whole).abs().max()) <= 1e-5 * float(
        whole.abs().max())
    # the reference's own share 0 is the port's
    ref0, _ = REF._moe(x, {f"moe.{k}": v for k, v in p.items()},
                       dict(m, experts_held=4), None)
    torch.testing.assert_close(parts[0], ref0, rtol=1e-5, atol=1e-5)


def test_nope_and_the_scale_give_the_plain_attention():
    """The configuration's attention (no rotary positions, scores scaled
    by ``attention_multiplier``) is plain causal softmax attention of
    the projections, GQA by repeat, at that scale."""
    cfg = ModelConfig(**_model())
    g = torch.Generator().manual_seed(3)
    p = {n: torch.randn(s.shape, generator=g) / math.sqrt(s.shape[0])
         for n, s in mattn.attn_spec(cfg).items()}
    x = torch.randn((2, 24, cfg.d_model), generator=g)
    pos = torch.arange(24)
    got = mattn.multihead(p, x, cfg=cfg, positions=pos)
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"]).double()
    rep = cfg.n_heads // cfg.n_kv_heads
    k, v = (torch.einsum("bsd,dhk->bhsk", x, p[w]).double()
            .repeat_interleave(rep, dim=1) for w in ("wk", "wv"))
    s = q @ k.transpose(-1, -2) * cfg.attention_multiplier
    s = s.masked_fill(pos[None, :] > pos[:, None], -math.inf)
    want = torch.einsum("bhsk,hkd->bsd", torch.softmax(s, -1) @ v,
                        p["wo"].double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    # with RoPE and hd^-0.5 the same inputs give another answer
    rope = dataclasses.replace(cfg, position_embedding="rope",
                               attention_multiplier=None)
    other = mattn.multihead(p, x, cfg=rope, positions=pos)
    assert float((other - got).abs().max()) > 1e-3


def test_layer_remat_gives_the_same_values():
    """Recomputing a layer at a time (``remat: layer``), a pattern at a
    time (``full``) or not at all: the same loss and gradients."""
    tokens, labels = _batch(32, 1)
    got = []
    for remat in ("none", "full", "layer"):
        m = _model(remat=remat)
        lm = LM(ModelConfig(**m), device="cpu")
        lm.load_param_tree(REF.nest(REF.make_params(m, 2, CPU)))
        metrics, grads = step.loss_and_grads(
            lm, lm.param_tree(), {"tokens": tokens, "labels": labels})
        got.append((metrics["loss"], dict(tree_leaves(grads))))
    for loss, grads in got[1:]:
        assert torch.equal(loss, got[0][0])
        assert all(torch.equal(grads[k], got[0][1][k]) for k in grads)


# ------------------------------------------------------------- tracing


@pytest.fixture
def tracer():
    TRACER.clear()
    TRACER.enable()
    yield TRACER
    TRACER.disable()
    TRACER.clear()


def test_traced_step_counts_the_held_share(tmp_path, tracer):
    """A traced step of the one-device share's smoke config (2 of 16
    experts held): ``train.step`` carries ``moe_routed`` (every routed
    assignment), ``moe_held`` (those to held experts, as a CPU top-k of
    the same router output counts them), the attention counters, and the
    step has ``block.ssm`` and ``block.ffn`` spans, one call a layer."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.trainer import Trainer
    cfg = dataclasses.replace(get_smoke_config(ARCH), experts_held=2)
    lm = LM(cfg, device="cpu")
    lm.init(torch.Generator().manual_seed(0))
    tr = Trainer(lm, ckpt_dir=str(tmp_path / "ckpt"), log_every=0,
                 data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     global_batch=2), device="cpu")
    held = []
    hook = moe.register_router_hook(lambda probs: held.append(int(
        (torch.topk(probs, cfg.top_k, dim=-1).indices < cfg.n_held).sum())))
    try:
        tr.run(1)
    finally:
        hook.remove()
    spans = tracer.spans()
    (st,) = [sp for sp in spans if sp["name"] == "train.step"]
    a = st["args"]
    assert a["moe_routed"] == cfg.n_layers * 2 * 32 * cfg.top_k
    assert a["moe_held"] == sum(held) == a["moe_assigned"]
    assert 0 < a["moe_held"] < a["moe_routed"]
    assert 0 <= a["moe_dropped"] <= a["moe_held"]
    assert a["attn_calls"] == 1 and a["attn_kernel"] == 0
    calls = {sp["name"]: sp["args"]["calls"] for sp in spans
             if sp["name"].startswith("block.")}
    assert calls["block.ssm"] == 4 and calls["block.ffn"] == 5
    assert calls["block.attention"] == 1


# ---------------------------------------------------------------- the card


@pytest.mark.gpu
def test_kernel_takes_the_configs_scale_on_the_card():
    """A1 at the configuration's attention (B 2, S 4,096, 32 heads over 8
    KV heads of 128, causal, no rotary positions) with its softmax scale
    1/128: out, dq, dk and dv as close to float64 attention of the same
    bf16 inputs as the plain version at that scale (norm-wise error at
    most 1.25x the plain version's + 1e-4, the rule of
    ``test_torch_attention_kernel.py``; the plain version's float32-result
    products on float32 copies, as there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import attention as fa
    scale = get_config(ARCH).attention_multiplier
    b, s, h, hkv, hd = 2, 4096, 32, 8, 128
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn((b, s, n, hd), generator=g).to(
        "cuda", torch.bfloat16) for n in (h, hkv, hkv, h))
    want = _exact(q, k, v, dout, scale)
    cfg = dataclasses.replace(get_config(ARCH), attn_chunk=1024)
    pos = torch.arange(s, device="cuda")
    errs = {}
    for name, fn in (("kernel", lambda *t: fa.attention(
                         *t, causal=True, scale=scale)),
                     ("plain", lambda *t: mattn._plain(
                         *t, cfg=cfg, positions=pos, kpos=pos, causal=True,
                         scale=scale))):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        with mock.patch.object(layers, "_tensor_cores", lambda a, b: False):
            out = fn(qq, kk, vv)
        out.backward(dout)
        errs[name] = [float((x.detach().double() - ref).norm() / ref.norm())
                      for x, ref in zip((out, qq.grad, kk.grad, vv.grad),
                                        want)]
    for name, e_kernel, e_plain in zip(("out", "dq", "dk", "dv"),
                                       errs["kernel"], errs["plain"]):
        assert e_kernel <= 1.25 * e_plain + 1e-4, (name, e_kernel, e_plain)


def _exact(q, k, v, dout, scale):
    """float64 out, dq, dk, dv of causal attention of the bf16 inputs at
    ``scale``, a (batch, head) at a time."""
    b, s, h, _ = q.shape
    rep = h // k.shape[2]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    dq = torch.empty_like(out)
    dk = torch.zeros(k.shape, dtype=torch.float64, device=q.device)
    dv = torch.zeros_like(dk)
    for bi in range(b):
        for hi in range(h):
            gi = hi // rep
            qh, kh, vh = (t[bi, :, x].double().requires_grad_()
                          for t, x in ((q, hi), (k, gi), (v, gi)))
            sc = (qh @ kh.T * scale).masked_fill(~ok, -math.inf)
            o = torch.softmax(sc, -1) @ vh
            o.backward(dout[bi, :, hi].double())
            out[bi, :, hi] = o.detach()
            dq[bi, :, hi] = qh.grad
            dk[bi, :, gi] += kh.grad
            dv[bi, :, gi] += vh.grad
    return out, dq, dk, dv
