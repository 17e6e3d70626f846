"""Plain float32 reference of the decoder LMs that portbench trains.

A frozen copy of the mathematics of a dense (SwiGLU MLP) or MoE (token
choice top-k of E experts, capacity per dispatch group) pre-norm decoder
as ``repro_torch``'s ``ModelConfig`` defines it, in plain ``torch``
operations at float32 with TF32 off. It imports nothing of this
repository and takes nothing that the port made: the harness hands it
the configuration's ``model`` table, the seed and the token batches.

What it states about the architecture (each a departure from the
published models where those differ; the configuration files list
them): rotary embedding over the whole head, rotating halves, base
``rope_theta``; no bias in any projection; LayerNorm with scale and bias
(eps 1e-5) or RMSNorm with a (1 + scale) gain (eps 1e-6); causal
softmax attention at scale head_dim^-0.5, key/value heads shared by
``n_heads / n_kv_heads`` query heads; SwiGLU ``silu(x Wg) * (x Wi) Wo``;
the MoE layer's gates are its top-k router probabilities (a stable
descending sort, so the lower expert wins a tie) renormalised to sum to
one, its tokens are cut into ``gcd(moe_groups, tokens)`` groups where
there are 2,048 tokens or more, and in each group an expert takes its
first ``capacity`` assignments in token order (token-major, then rank)
and drops the rest; its auxiliary loss is ``E * sum(mean probability x
share of assignments)`` per layer, added to the loss at 0.01; the
next-token loss is the mean NLL of the labels as given. AdamW as the
port runs it: warmup-stable-decay learning rate, clipping by the global
float32 norm, weight decay on every leaf.

``quant=CONTROL`` is the control: every matrix product's operands are
rounded to float8 (e4m3 forward, e5m2 for the gradients, one scale per
tensor from its largest magnitude), the precision below the bfloat16
that the configurations state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LAYERNORM_EPS = 1e-5
RMSNORM_EPS = 1e-6
ATTN_CHUNK = 512        # query rows per attention block (memory only)
CONTROL = "fp8"         # the precision below the stated bfloat16


# ------------------------------------------------------------- parameters


def layout(m: dict) -> list[tuple[str, tuple, str, float]]:
    """(dotted path, shape, init, scale) of every parameter, sorted by
    path: the port's parameter tree (stacked blocks with a leading layer
    axis). ``normal`` leaves are drawn at 1/sqrt(fan-in), the embedding
    at 1."""
    if m["mlp_act"] != "swiglu" or m["family"] not in ("dense", "moe"):
        raise ValueError("the reference covers dense and MoE SwiGLU "
                         "decoders only")
    nl, d, v = m["n_layers"], m["d_model"], m["vocab_size"]
    nh, nkv, f = m["n_heads"], m["n_kv_heads"], m["d_ff"]
    hd = m.get("head_dim") or d // nh
    out = [("embed.tok", (v, d), "normal", 1.0)]
    if not m["tie_embeddings"]:
        out.append(("embed.unembed", (d, v), "normal", d ** -0.5))
    for name, lead in (("final_norm", ()), ("blocks.ln1", (nl,)),
                       ("blocks.ln2", (nl,))):
        if m["norm"] == "layernorm":
            out += [(f"{name}.scale", (*lead, d), "ones", 0.0),
                    (f"{name}.bias", (*lead, d), "zeros", 0.0)]
        else:
            out.append((f"{name}.scale", (*lead, d), "zeros", 0.0))
    out += [("blocks.attn.wq", (nl, d, nh, hd), "normal", d ** -0.5),
            ("blocks.attn.wk", (nl, d, nkv, hd), "normal", d ** -0.5),
            ("blocks.attn.wv", (nl, d, nkv, hd), "normal", d ** -0.5),
            ("blocks.attn.wo", (nl, nh, hd, d), "normal", (nh * hd) ** -0.5)]
    if m["family"] == "moe":
        e = m["n_experts"]
        out += [("blocks.moe.router", (nl, d, e), "normal", d ** -0.5),
                ("blocks.moe.wi", (nl, e, d, f), "normal", d ** -0.5),
                ("blocks.moe.wg", (nl, e, d, f), "normal", d ** -0.5),
                ("blocks.moe.wo", (nl, e, f, d), "normal", f ** -0.5)]
    else:
        out += [("blocks.mlp.wi", (nl, d, f), "normal", d ** -0.5),
                ("blocks.mlp.wg", (nl, d, f), "normal", d ** -0.5),
                ("blocks.mlp.wo", (nl, f, d), "normal", f ** -0.5)]
    return sorted(out)


@torch.no_grad()
def make_params(m: dict, seed: int, device) -> dict:
    """{path: float32 tensor} drawn from ``seed`` on ``device``: one
    ``randn`` over every normal leaf from one generator, then views."""
    lay = layout(m)
    n = sum(math.prod(shape) for _, shape, init, _ in lay if init == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for path, shape, init, scale in lay:
        if init == "normal":
            k = math.prod(shape)
            out[path] = flat[at:at + k].view(shape).mul_(scale)
            at += k
        else:
            fill = torch.ones if init == "ones" else torch.zeros
            out[path] = fill(shape, dtype=torch.float32, device=device)
    return out


def nest(flat: dict) -> dict:
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


# ------------------------------------------------------------ model FLOPs


def matmul_params_per_token(m: dict) -> int:
    """Weights that one token multiplies by in a forward pass: each
    layer's q, k, v and output projections, its SwiGLU MLP or its
    router and ``top_k`` experts, and the unembedding. The embedding
    lookup and the norms multiply nothing."""
    layout(m)                           # the families this file covers
    d, f = m["d_model"], m["d_ff"]
    hd = m.get("head_dim") or d // m["n_heads"]
    attn = d * hd * (m["n_heads"] + 2 * m["n_kv_heads"]) \
        + m["n_heads"] * hd * d
    ffn = 3 * d * f
    if m["family"] == "moe":
        ffn = m["top_k"] * ffn + d * m["n_experts"]
    return m["n_layers"] * (attn + ffn) + d * m["vocab_size"]


def train_flops_per_token(m: dict, seq_len: int) -> int:
    """Model FLOPs of one trained token (PaLM, arXiv:2204.02311, app. B):
    6 x the weights it multiplies by, plus 12 x layers x (heads x head
    dim) x sequence for the attention scores and values, counted over
    the whole sequence as PaLM counts them. Recomputation (remat) is
    not model work and is not counted."""
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    return 6 * matmul_params_per_token(m) \
        + 12 * m["n_layers"] * m["n_heads"] * hd * seq_len


# ------------------------------------------------------------- precision


def _round(x, dtype):
    amax = x.detach().abs().max().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def _mm(eq: str, a, b, quant: str | None):
    if quant == "fp8":
        a, b = _Fp8.apply(a), _Fp8.apply(b)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return torch.einsum(eq, a, b)


# ---------------------------------------------------------------- forward


def _norm(x, p: dict, name: str, m: dict):
    if m["norm"] == "layernorm":
        return F.layer_norm(x, x.shape[-1:], p[f"{name}.scale"],
                            p[f"{name}.bias"], LAYERNORM_EPS)
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + RMSNORM_EPS) * (1.0 + p[f"{name}.scale"])


def _rope(x, theta: float):
    """x (B, S, H, hd), positions 0..S-1; rotates the two halves."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(h, p: dict, m: dict, quant):
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    q = _rope(_mm("bsd,dhk->bshk", h, p["attn.wq"], quant), m["rope_theta"])
    k = _rope(_mm("bsd,dhk->bshk", h, p["attn.wk"], quant), m["rope_theta"])
    v = _mm("bsd,dhk->bshk", h, p["attn.wv"], quant)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    s, hd = h.shape[1], q.shape[-1]
    outs = []
    for i in range(0, s, ATTN_CHUNK):
        j = min(i + ATTN_CHUNK, s)
        sc = _mm("bqhd,bkhd->bhqk", q[:, i:j], k[:, :j], quant) * hd ** -0.5
        qpos = torch.arange(i, j, device=h.device)[:, None]
        kpos = torch.arange(j, device=h.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        outs.append(_mm("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1),
                        v[:, :j], quant))
    return _mm("bshk,hkd->bsd", torch.cat(outs, dim=1), p["attn.wo"], quant)


def _mlp(h, p: dict, quant):
    g = _mm("bsd,df->bsf", h, p["mlp.wg"], quant)
    u = _mm("bsd,df->bsf", h, p["mlp.wi"], quant)
    return _mm("bsf,fd->bsd", F.silu(g) * u, p["mlp.wo"], quant)


def capacity(m: dict, tokens_per_group: int) -> int:
    c = int(tokens_per_group * m["top_k"] * m["capacity_factor"]
            / m["n_experts"])
    return max(8, -(-c // 8) * 8)


def _moe(h, p: dict, m: dict, quant):
    b, s, d = h.shape
    t, e, k = b * s, m["n_experts"], m["top_k"]
    x = h.reshape(t, d)
    g = math.gcd(m["moe_groups"], t) if t >= 2048 else 1
    cap = capacity(m, t // g)
    probs = torch.softmax(_mm("td,de->te", x, p["moe.router"], quant), -1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    gates = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(ids.reshape(g, (t // g) * k), e)
    arrival = (onehot.cumsum(1) * onehot).sum(-1) - 1   # place in its expert
    keep = (arrival < cap).reshape(t, k)
    counts = onehot.sum((0, 1)).float()
    aux = e * torch.sum(probs.mean(0) * counts / (t * k))
    y = torch.zeros_like(x)
    for ex in range(e):
        tok, rank = ((ids == ex) & keep).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        he = F.silu(_mm("td,df->tf", xe, p["moe.wg"][ex], quant)) * \
            _mm("td,df->tf", xe, p["moe.wi"][ex], quant)
        ye = _mm("tf,fd->td", he, p["moe.wo"][ex], quant)
        y = y.index_add(0, tok, ye * gates[tok, rank][:, None])
    return y.reshape(b, s, d), aux


def _layer(x, p: dict, m: dict, quant):
    x = x + _attention(_norm(x, p, "ln1", m), p, m, quant)
    h = _norm(x, p, "ln2", m)
    if m["family"] == "moe":
        y, aux = _moe(h, p, m, quant)
    else:
        y, aux = _mlp(h, p, quant), x.new_zeros(())
    return x + y, aux


def loss(params: dict, tokens, labels, m: dict, quant=None):
    """(mean NLL, summed auxiliary loss) of one batch; each layer is
    recomputed in the backward pass, so the reference fits beside the
    cell's sizes."""
    x = params["embed.tok"][tokens.long()]
    blocks = {k[len("blocks."):]: v.unbind(0) for k, v in params.items()
              if k.startswith("blocks.")}
    aux = x.new_zeros(())
    for i in range(m["n_layers"]):
        lp = {k: v[i] for k, v in blocks.items()}
        x, a = checkpoint(_layer, x, lp, m, quant, use_reentrant=False)
        aux = aux + a
    x = _norm(x, params, "final_norm", m)
    w = params["embed.tok"].T if m["tie_embeddings"] \
        else params["embed.unembed"]
    logits = _mm("bsd,dv->bsv", x, w, quant)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll), aux


# -------------------------------------------------------------- training


def _lr(step: int, o: dict) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    t = (step - o["warmup_steps"] - o["stable_steps"]) / max(
        o["decay_steps"], 1)
    return o["lr"] * warm * o["min_lr_ratio"] ** min(max(t, 0.0), 1.0)


def train(m: dict, o: dict, params0: dict, batches, *, quant=None,
          observe=None) -> dict:
    """Train a float32 copy of ``params0`` on ``batches`` (a list of
    (tokens, labels)) with AdamW (``o``: the optimizer table). Returns
    the readings: each step's NLL, the first step's clipped gradient
    norm per leaf, each leaf's change norm after the last step, and
    under ``observed`` what ``observe(step, params)`` returned after
    each step (``None`` left out). ``params0`` is left as it is."""
    p = {k: v.detach().clone() for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"loss": [], "grad_norm": {}, "observed": {}, "change_norm": {}}
    b1, b2 = o["b1"], o["b2"]
    for step, (tokens, labels) in enumerate(batches, 1):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        nll, aux = loss(leaves, tokens, labels, m, quant)
        grads = torch.autograd.grad(nll + 0.01 * aux, list(leaves.values()))
        del leaves
        out["loss"].append(float(nll.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(o["clip_norm"] / (gnorm + 1e-9), max=1.0)
            lr = _lr(step, o)
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for (k, x), g in zip(p.items(), grads):
                g = g * scale
                if step == 1:
                    out["grad_norm"][k] = float(g.double().norm())
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
                delta = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + o["eps"]) \
                    + o["weight_decay"] * x
                x.sub_(lr * delta)
            del grads
            seen = None if observe is None else observe(step, p)
            if seen is not None:
                out["observed"][step] = seen
    with torch.no_grad():
        out["change_norm"] = {k: float((x - params0[k]).double().norm())
                              for k, x in p.items()}
    return out
