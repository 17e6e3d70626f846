"""Plain float32 reference of the Granite 4.0 hybrid (``granitemoehybrid``)
LM that portbench trains: Mamba-2 and NoPE attention layers, each
followed by routed experts and a shared expert.

A frozen copy of the mathematics as ``repro_torch``'s ``ModelConfig``
defines it for ``granite-4.0-h-small``, in plain ``torch`` operations
at float32 with TF32 off. It imports nothing of this repository and
takes nothing that the port made: the harness hands it the
configuration's ``model`` table, the seed and the token batches. The
parameters are the port's tree: the layer pattern's slots
``blocks.sub<i>_<kind>``, each stacked over the pattern's repeats.

The layers, with r = ``residual_multiplier`` (0.22) and RMSNorm(x) =
x / sqrt(mean(x^2) + eps) * (1 + scale), eps = ``norm_eps`` (1e-5):

    h = h + r * mixer(RMSNorm(h))
    h = h + r * (MoE(RMSNorm(h)) + shared(RMSNorm(h)))

- Embedding: the table's row times ``embedding_multiplier`` (12).
- Mamba-2 mixer (kind ``ssm_moe``), heads H = d_inner / P of P =
  ``ssm_head_dim``, state N = ``ssm_state``, one B/C group:
  x = h W_x, z = h W_z, B = h W_B, C = h W_C, dt = h W_dt (no bias);
  [x, B, C] = silu(conv(x, B, C) + bias), a depthwise causal conv of
  width ``ssm_conv`` over all d_inner + 2N channels (the K-1 inputs
  before the sequence are zeros); dt = softplus(dt + dt_bias), A =
  -exp(A_log); the chunked SSD (chunks of ``ssm_chunk``) of
  s_t = exp(dt_t A) s_{t-1} + dt_t x_t B_t^T, y_t = s_t C_t, from a
  zero state, in the Mamba-2 paper's four steps (arXiv:2405.21060
  listing 1: within chunks, chunk states, the recurrence between
  chunks as a decay matrix, states to outputs); y = y + D x; the gated
  norm RMSNorm(y * silu(z)) over all d_inner channels; out = y W_out.
- Attention (kind ``moe``): q, k, v projections with no bias and no
  positional rotation (NoPE); causal softmax of q k^T times
  ``attention_multiplier`` (1/128, not head_dim^-0.5); key/value heads
  shared by ``n_heads / n_kv_heads`` query heads; the output
  projection.
- MoE: the router scores all ``n_experts``; the gates are the top
  ``top_k`` probabilities of a stable descending sort (the lower expert
  wins a tie) renormalised to sum to one, which is the softmax of the
  top-k logits; each expert is SwiGLU ``silu(x Wg) * (x Wi) Wo``.
- Shared expert: SwiGLU of width ``shared_ff`` on every token.
- Head: the tied embedding's transpose; the logits divided by
  ``logits_scaling`` (16); the loss is the mean NLL of the labels as
  given.

Departures from the published model (the configuration file lists
them):

- Capacity: the tokens are cut into ``gcd(moe_groups, tokens)`` groups
  where there are 2,048 tokens or more, and in each group an expert
  takes its first ``capacity`` assignments in token order (token-major,
  then rank) and drops the rest; the published MoE drops none.
- The auxiliary loss ``E * sum(mean probability x share of
  assignments)`` per layer, over the whole router, added to the loss at
  0.01.
- RMSNorm's gain is (1 + scale), the scale drawn at zero.
- The expert share: only the first ``experts_held`` experts of each
  layer are computed (one device's share under expert parallelism);
  what the others would add to each token is left out, here and in the
  program alike. Routing, capacity and the auxiliary loss stay those of
  all ``n_experts``.

AdamW as the port runs it: warmup-stable-decay learning rate, clipping
by the global float32 norm, weight decay on every leaf.

``quant=CONTROL`` is the control: every matrix product's operands are
rounded to float8 (e4m3 forward, e5m2 for the gradients, one scale per
tensor from its largest magnitude), the precision below the bfloat16
that the configuration states.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ATTN_CHUNK = 512        # query rows per attention block (memory only)
CONTROL = "fp8"         # the precision below the stated bfloat16
KINDS = ("ssm_moe", "moe")   # Mamba-2 then MoE, attention then MoE


# ------------------------------------------------------------- parameters


def _pattern(m: dict) -> list[str]:
    """The layer pattern, if this file covers the configuration."""
    pat = list(m.get("block_pattern") or ())
    covered = (m["family"] == "hybrid" and pat and set(pat) <= set(KINDS)
               and m["n_layers"] % len(pat) == 0
               and m["mlp_act"] == "swiglu" and m["norm"] == "rmsnorm"
               and m["n_experts"] > 0 and m["ssm_conv_xbc"]
               and m["position_embedding"] == "nope"
               and m["attention_multiplier"] and m["norm_eps"])
    if not covered:
        raise ValueError("the reference covers Granite 4.0 hybrids only: a "
                         "pattern of ssm_moe and moe layers, SwiGLU "
                         "experts, RMSNorm with its eps, the conv over x, B "
                         "and C, NoPE with its softmax scale")
    return pat


def _held(m: dict) -> int:
    return m["experts_held"] or m["n_experts"]


def _slot(i: int, kind: str) -> str:
    return f"blocks.sub{i}_{kind}"


def layout(m: dict) -> list[tuple[str, tuple, str, float]]:
    """(dotted path, shape, init, scale) of every parameter, sorted by
    path: the port's parameter tree. ``normal`` leaves are drawn at
    1/sqrt(fan-in) (the conv's weights and biases at 1/sqrt(width)),
    the embedding at 1."""
    pat = _pattern(m)
    rep = (m["n_layers"] // len(pat),)
    d, v, f, sf = m["d_model"], m["vocab_size"], m["d_ff"], m["shared_ff"]
    e, eh, k = m["n_experts"], _held(m), m["ssm_conv"]
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or d // nh
    di, n = m["ssm_expand"] * d, m["ssm_state"]
    h = di // m["ssm_head_dim"]
    out = [("embed.tok", (v, d), "normal", 1.0),
           ("final_norm.scale", (d,), "zeros", 0.0)]
    if not m["tie_embeddings"]:
        out.append(("embed.unembed", (d, v), "normal", d ** -0.5))
    for i, kind in enumerate(pat):
        leaves = [("ln1.scale", (d,), "zeros", 0.0),
                  ("ln2.scale", (d,), "zeros", 0.0),
                  ("moe.router", (d, e), "normal", d ** -0.5),
                  ("moe.wi", (eh, d, f), "normal", d ** -0.5),
                  ("moe.wg", (eh, d, f), "normal", d ** -0.5),
                  ("moe.wo", (eh, f, d), "normal", f ** -0.5)]
        if sf:
            leaves += [("moe.shared.wi", (d, sf), "normal", d ** -0.5),
                       ("moe.shared.wg", (d, sf), "normal", d ** -0.5),
                       ("moe.shared.wo", (sf, d), "normal", sf ** -0.5)]
        if kind == "ssm_moe":
            leaves += [("ssm.in_x", (d, di), "normal", d ** -0.5),
                       ("ssm.in_z", (d, di), "normal", d ** -0.5),
                       ("ssm.in_b", (d, n), "normal", d ** -0.5),
                       ("ssm.in_c", (d, n), "normal", d ** -0.5),
                       ("ssm.in_dt", (d, h), "normal", d ** -0.5),
                       ("ssm.dt_bias", (h,), "zeros", 0.0),
                       ("ssm.a_log", (h,), "zeros", 0.0),
                       ("ssm.d_skip", (h,), "ones", 0.0),
                       ("ssm.conv_w", (k, di), "normal", k ** -0.5),
                       ("ssm.conv_bias", (di,), "normal", k ** -0.5),
                       ("ssm.conv_bc_w", (k, 2 * n), "normal", k ** -0.5),
                       ("ssm.conv_bc_bias", (2 * n,), "normal", k ** -0.5),
                       ("ssm.norm_scale", (di,), "zeros", 0.0),
                       ("ssm.out", (di, d), "normal", di ** -0.5)]
        else:
            leaves += [("attn.wq", (d, nh, hd), "normal", d ** -0.5),
                       ("attn.wk", (d, nkv, hd), "normal", d ** -0.5),
                       ("attn.wv", (d, nkv, hd), "normal", d ** -0.5),
                       ("attn.wo", (nh, hd, d), "normal",
                        (nh * hd) ** -0.5)]
        out += [(f"{_slot(i, kind)}.{p}", (*rep, *shape), init, scale)
                for p, shape, init, scale in leaves]
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
            size = math.prod(shape)
            out[path] = flat[at:at + size].view(shape).mul_(scale)
            at += size
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


def matmul_params_per_token(m: dict):
    """Weights that one token multiplies by in a forward pass: each
    Mamba-2 layer's five input projections and its output projection;
    the attention layers' q, k, v and output projections; each layer's
    router, its held experts at their expected top_k x held / n_experts
    assignments a token (1.25 at 10 x 9 / 72) and its shared expert;
    the unembedding. The depthwise conv, the norms and the embedding
    lookup multiply by no matrix. An int where the expected assignments
    make one (every configuration here), else a float."""
    pat = _pattern(m)
    d, f, sf = m["d_model"], m["d_ff"], m["shared_ff"]
    e, k = m["n_experts"], m["top_k"]
    hd = m.get("head_dim") or d // m["n_heads"]
    di, n = m["ssm_expand"] * d, m["ssm_state"]
    h = di // m["ssm_head_dim"]
    mixer = {"ssm_moe": d * (2 * di + 2 * n + h) + di * d,
             "moe": d * hd * (m["n_heads"] + 2 * m["n_kv_heads"])
             + m["n_heads"] * hd * d}
    rep = m["n_layers"] // len(pat)
    whole = rep * sum(mixer[kind] + d * e + 3 * d * sf for kind in pat) \
        + d * m["vocab_size"]
    experts = m["n_layers"] * k * _held(m) * 3 * d * f    # x n_experts
    q, r = divmod(experts, e)
    return whole + q if r == 0 else whole + experts / e


def train_flops_per_token(m: dict, seq_len: int):
    """Model FLOPs of one trained token: 3 x the forward's (the backward
    twice the forward), which is

      6 x :func:`matmul_params_per_token`
      + 12 x attention layers x heads x head_dim x seq_len
      + Mamba-2 layers x (6 N Q + 6 H P Q + 12 H P N).

    The attention term counts the scores and values over the whole
    sequence, as PaLM (arXiv:2204.02311, app. B) and the dense and MoE
    cells count them. The SSD's, per token at chunk Q, state N, H heads
    of P: the within-chunk scores C B^T (2 N Q a token forward) and
    their product with x dt (2 H P Q), counted over the whole chunk as
    the attention term is over the sequence; the chunk state B x^T (2 H
    P N) and the state's output C s (2 H P N). The recurrence between
    chunks, the decays and the conv are elementwise work, and
    recomputation (remat) is not model work: neither is counted."""
    pat = _pattern(m)
    rep = m["n_layers"] // len(pat)
    d, nh = m["d_model"], m["n_heads"]
    hd = m.get("head_dim") or d // nh
    q, n, p = m["ssm_chunk"], m["ssm_state"], m["ssm_head_dim"]
    h = m["ssm_expand"] * d // p
    n_attn = rep * pat.count("moe")
    n_ssm = rep * pat.count("ssm_moe")
    return 6 * matmul_params_per_token(m) \
        + 12 * n_attn * nh * hd * seq_len \
        + n_ssm * (6 * n * q + 6 * h * p * q + 12 * h * p * n)


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


def _norm(x, scale, eps: float):
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * (1.0 + scale)


def _swiglu(x, wg, wi, wo, quant):
    g = _mm("...d,df->...f", x, wg, quant)
    u = _mm("...d,df->...f", x, wi, quant)
    return _mm("...f,fd->...d", F.silu(g) * u, wo, quant)


def _segsum(a):
    """(..., T) -> (..., T, T): out[i, j] = a[j+1] + ... + a[i] for
    i >= j, -inf above the diagonal (masked before any exp)."""
    t = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    seg = c[..., :, None] - c[..., None, :]
    below = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                  device=a.device))
    return seg.masked_fill(~below, float("-inf"))


def _ssd(x, dt, a, bmat, cmat, chunk: int, quant):
    """y of s_t = exp(dt_t a) s_{t-1} + dt_t x_t B_t^T, y_t = s_t C_t
    from a zero state. x (b, s, H, P), dt (b, s, H), a (H,), B and C
    (b, s, N); the sequence a whole number of chunks."""
    b, s, nh, p = x.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    c = s // chunk
    xs = (x * dt[..., None]).reshape(b, c, chunk, nh, p)
    ad = (dt * a).reshape(b, c, chunk, nh).permute(0, 3, 1, 2)  # b h c l
    bs = bmat.reshape(b, c, chunk, -1)
    cs = cmat.reshape(b, c, chunk, -1)
    cum = torch.cumsum(ad, dim=-1)
    # 1. within each chunk
    w = _mm("bcln,bcsn->bcls", cs, bs, quant)[:, None] * \
        torch.exp(_segsum(ad))                                 # b h c l s
    y_diag = _mm("bhcls,bcshp->bclhp", w, xs, quant)
    # 2. each chunk's final state from its own inputs
    decayed = xs * torch.exp(cum[..., -1:] - cum).permute(
        0, 2, 3, 1)[..., None]                                 # b c l h p
    states = _mm("bcln,bclhp->bchpn", bs, decayed, quant)
    # 3. the state entering each chunk: the recurrence between chunks
    zero = torch.zeros_like(states[:, :1])
    states = torch.cat([zero, states], dim=1)                  # b c+1 ...
    decay_chunk = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))
    entering = _mm("bhzc,bchpn->bzhpn", decay_chunk, states, quant)[:, :-1]
    # 4. the entering state's output within each chunk
    y_off = _mm("bcln,bchpn->bclhp", cs, entering, quant) * \
        torch.exp(cum).permute(0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(b, s, nh, p)


def _mamba(h, p: dict, m: dict, quant):
    b, s, _ = h.shape
    n, pdim = m["ssm_state"], m["ssm_head_dim"]
    di = m["ssm_expand"] * m["d_model"]
    x = _mm("bsd,dk->bsk", h, p["ssm.in_x"], quant)
    z = _mm("bsd,dk->bsk", h, p["ssm.in_z"], quant)
    bm = _mm("bsd,dk->bsk", h, p["ssm.in_b"], quant)
    cm = _mm("bsd,dk->bsk", h, p["ssm.in_c"], quant)
    dt = _mm("bsd,dk->bsk", h, p["ssm.in_dt"], quant)
    # the depthwise causal conv over x, B and C, as conv1d with K-1
    # leading zeros
    xbc = torch.cat([x, bm, cm], dim=-1).transpose(1, 2)
    w = torch.cat([p["ssm.conv_w"], p["ssm.conv_bc_w"]], dim=-1)
    bias = torch.cat([p["ssm.conv_bias"], p["ssm.conv_bc_bias"]])
    k = w.shape[0]
    xbc = F.conv1d(F.pad(xbc, (k - 1, 0)), w.T[:, None, :], bias,
                   groups=xbc.shape[1])
    xbc = F.silu(xbc).transpose(1, 2)
    x, bm, cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt + p["ssm.dt_bias"])
    a = -torch.exp(p["ssm.a_log"])
    xh = x.reshape(b, s, -1, pdim)
    y = _ssd(xh, dt, a, bm, cm, m["ssm_chunk"], quant)
    y = (y + xh * p["ssm.d_skip"][:, None]).reshape(b, s, di)
    y = _norm(y * F.silu(z), p["ssm.norm_scale"], m["norm_eps"])
    return _mm("bsk,kd->bsd", y, p["ssm.out"], quant)


def _attention(h, p: dict, m: dict, quant):
    nh, nkv = m["n_heads"], m["n_kv_heads"]
    q = _mm("bsd,dhk->bshk", h, p["attn.wq"], quant)
    k = _mm("bsd,dhk->bshk", h, p["attn.wk"], quant)
    v = _mm("bsd,dhk->bshk", h, p["attn.wv"], quant)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    s = h.shape[1]
    outs = []
    for i in range(0, s, ATTN_CHUNK):
        j = min(i + ATTN_CHUNK, s)
        sc = _mm("bqhd,bkhd->bhqk", q[:, i:j], k[:, :j], quant) * \
            m["attention_multiplier"]
        qpos = torch.arange(i, j, device=h.device)[:, None]
        kpos = torch.arange(j, device=h.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        outs.append(_mm("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1),
                        v[:, :j], quant))
    return _mm("bshk,hkd->bsd", torch.cat(outs, dim=1), p["attn.wo"], quant)


def capacity(m: dict, tokens_per_group: int) -> int:
    c = int(tokens_per_group * m["top_k"] * m["capacity_factor"]
            / m["n_experts"])
    return max(8, -(-c // 8) * 8)


def _moe(h, p: dict, m: dict, quant):
    """(the held experts' and the shared expert's sum, aux loss)."""
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
    for ex in range(_held(m)):
        tok, rank = ((ids == ex) & keep).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = _swiglu(x[tok], p["moe.wg"][ex], p["moe.wi"][ex],
                     p["moe.wo"][ex], quant)
        y = y.index_add(0, tok, ye * gates[tok, rank][:, None])
    if m["shared_ff"]:
        y = y + _swiglu(x, p["moe.shared.wg"], p["moe.shared.wi"],
                        p["moe.shared.wo"], quant)
    return y.reshape(b, s, d), aux


def _layer(x, p: dict, m: dict, kind: str, quant):
    r, eps = m["residual_multiplier"], m["norm_eps"]
    h = _norm(x, p["ln1.scale"], eps)
    mixer = _mamba if kind == "ssm_moe" else _attention
    x = x + r * mixer(h, p, m, quant)
    y, aux = _moe(_norm(x, p["ln2.scale"], eps), p, m, quant)
    return x + r * y, aux


def loss(params: dict, tokens, labels, m: dict, quant=None):
    """(mean NLL, summed auxiliary loss) of one batch; each layer is
    recomputed in the backward pass, so the reference fits beside the
    cell's sizes."""
    pat = _pattern(m)
    x = params["embed.tok"][tokens.long()] * m["embedding_multiplier"]
    aux = x.new_zeros(())
    for rep in range(m["n_layers"] // len(pat)):
        for i, kind in enumerate(pat):
            head = _slot(i, kind) + "."
            lp = {path[len(head):]: v[rep] for path, v in params.items()
                  if path.startswith(head)}
            x, a = checkpoint(_layer, x, lp, m, kind, quant,
                              use_reentrant=False)
            aux = aux + a
    x = _norm(x, params["final_norm.scale"], m["norm_eps"])
    w = params["embed.tok"].T if m["tie_embeddings"] \
        else params["embed.unembed"]
    logits = _mm("bsd,dv->bsv", x, w, quant) / m["logits_scaling"]
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
