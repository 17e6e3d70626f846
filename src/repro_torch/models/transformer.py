"""Model assembly: stacked-layer transformers for all families.

One ``LM`` class covers: dense/GQA decoders, MoE, SSM (mamba2), RG-LRU
hybrids (pattern blocks + unrolled tail), encoder-decoder (whisper-style,
frame-embedding stub), and VLM (patch-embedding prefix stub).

``LM`` is an ``nn.Module`` that owns the reference's parameter tree: the
same nested keys, every stacked block with its leading layer axis, in
``cfg.param_dtype``; each parameter's name is the tree's dotted path
(``blocks.attn.wq``). The forward runs plain functions over that tree,
module by module, as the reference does; :meth:`LM.apply_params` takes
any tree of the same shapes (the train step passes detached leaves).
The layer axis is walked by a Python loop (the reference's ``lax.scan``;
``cfg.unroll_layers``, a probe flag for XLA's cost analysis, changes
nothing here). ``cfg.remat == "full"`` wraps each layer body (a
hybrid's whole pattern), as the reference wraps its scan body in
``jax.checkpoint``, in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``;
``"layer"`` wraps each layer, in a hybrid's pattern too. Under a
traced training step (``probe.ACTIVE``) each region of the model is
marked for its device time: ``block.embed``, ``block.attention``,
``block.ffn`` (``block.ssm``, ``block.rec`` for those mixers; the MoE
after a Mamba-2 mixer is ``block.ffn``) and ``block.head``, the head
through the loss.

``sharding.constrain`` pins each layer's output to ("batch", "seq",
"embed") as the reference does; it does nothing outside
``sharding.use_rules``. :meth:`LM.param_axes` gives the tree's logical
axes and :meth:`LM.abstract_params` its ``meta`` tensors in
``cfg.param_dtype``. ``LM(cfg, device="meta")`` is the abstract model
(the dry-run's): it holds meta parameters and needs no device.
"""
from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .. import sharding
from ..hercule.checkpoint import state_from_numpy, state_to_numpy
from ..insitu.device import resolve_device
from . import attention, layers, moe, probe, rglru, ssm
from .config import ModelConfig
from .layers import ParamSpec


def _stack_specs(spec, n: int):
    """Prepend a layer axis to every ParamSpec in a nested dict."""
    return layers.map_specs(
        lambda _, s: ParamSpec((n, *s.shape), (None, *s.axes), s.init,
                               s.scale), spec)


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def map_paths(fn, tree, path: str = ""):
    """``tree`` with every leaf replaced by ``fn(dotted path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def tree_leaves(tree, path: str = "") -> list:
    """(dotted path, leaf) in sorted key order (``jax.tree_util``'s)."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    out = []
    for k in sorted(tree):
        out += tree_leaves(tree[k], f"{path}.{k}" if path else k)
    return out


def _unstack(tree) -> list:
    """A stacked tree as a list of per-layer trees of views (one
    ``unbind`` per leaf, so the backward stacks each leaf's grads once)."""
    parts = map_tree(sharding.unbind, tree)

    def pick(t, i):
        return {k: pick(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else t[i]
    return [pick(parts, i) for i in range(len(tree_leaves(parts)[0][1]))]


def params_from_numpy(tree, device=None):
    """The reference's parameters as numpy arrays
    (``jax.tree.map(np.asarray, params)``) as tensors on ``device``
    (``None``: the GPU, raising without one)."""
    return state_from_numpy(tree, resolve_device(device))


def params_to_numpy(tree):
    """A parameter tree of tensors as numpy arrays, for the reference."""
    return state_to_numpy(tree)


def _module(tree) -> nn.Module:
    m = nn.Module()
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            m.add_module(k, _module(v))
        else:
            m.register_parameter(k, nn.Parameter(v))
    return m


def _tree_of(m: nn.Module) -> dict:
    out = dict(m._parameters)
    out.update({k: _tree_of(c) for k, c in m._modules.items()})
    return out


def maybe_checkpoint(fn, remat: bool):
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


class LM(nn.Module):
    """A configured language model owning its parameter tree."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device("meta") if str(device) == "meta" \
            else resolve_device(device)
        self.kinds = cfg.layer_kinds()
        if cfg.block_pattern:
            pat = len(cfg.block_pattern)
            self.n_rep = cfg.n_layers // pat
            self.tail_kinds = self.kinds[self.n_rep * pat:]
        else:
            self.n_rep = cfg.n_layers
            self.tail_kinds = []
        dtype = layers.dtype_of(cfg.param_dtype)
        tree = layers.map_specs(
            lambda _, s: torch.zeros(s.shape, dtype=dtype, device=self.device),
            self.param_specs())
        for k, sub in tree.items():
            self.add_module(k, _module(sub))

    # ------------------------------------------------------------- specs
    def _block_spec(self, kind: str) -> dict:
        cfg = self.cfg
        if kind == "attn":
            return {"ln1": layers.norm_spec(cfg),
                    "attn": attention.attn_spec(cfg),
                    "ln2": layers.norm_spec(cfg),
                    "mlp": layers.mlp_spec(cfg)}
        if kind == "moe":
            return {"ln1": layers.norm_spec(cfg),
                    "attn": attention.attn_spec(cfg),
                    "ln2": layers.norm_spec(cfg),
                    "moe": moe.moe_spec(cfg)}
        if kind == "ssm":
            return {"ln1": layers.norm_spec(cfg), "ssm": ssm.ssm_spec(cfg)}
        if kind == "ssm_moe":
            return {"ln1": layers.norm_spec(cfg), "ssm": ssm.ssm_spec(cfg),
                    "ln2": layers.norm_spec(cfg),
                    "moe": moe.moe_spec(cfg)}
        if kind == "rec":
            return {"ln1": layers.norm_spec(cfg),
                    "rec": rglru.rglru_spec(cfg),
                    "ln2": layers.norm_spec(cfg),
                    "mlp": layers.mlp_spec(cfg)}
        if kind == "xattn":  # enc-dec decoder block
            return {"ln1": layers.norm_spec(cfg),
                    "attn": attention.attn_spec(cfg),
                    "lnx": layers.norm_spec(cfg),
                    "xattn": attention.attn_spec(cfg, cross=True),
                    "ln2": layers.norm_spec(cfg),
                    "mlp": layers.mlp_spec(cfg)}
        raise ValueError(kind)

    def param_specs(self) -> dict:
        cfg = self.cfg
        spec: dict = {"embed": layers.embed_spec(cfg),
                      "final_norm": layers.norm_spec(cfg)}
        if cfg.block_pattern:
            block = {f"sub{i}_{k}": self._block_spec(k)
                     for i, k in enumerate(cfg.block_pattern)}
            spec["blocks"] = _stack_specs(block, self.n_rep)
            for i, k in enumerate(self.tail_kinds):
                spec[f"tail{i}"] = self._block_spec(k)
        elif cfg.family == "encdec":
            spec["enc"] = _stack_specs(self._block_spec("attn"), cfg.n_enc_layers)
            spec["blocks"] = _stack_specs(self._block_spec("xattn"), cfg.n_layers)
            spec["enc_norm"] = layers.norm_spec(cfg)
        else:
            spec["blocks"] = _stack_specs(self._block_spec(self.kinds[0]),
                                          cfg.n_layers)
        return spec

    def param_axes(self) -> dict:
        return layers.axes_tree(self.param_specs())

    def abstract_params(self) -> dict:
        return layers.shapes_tree(self.param_specs(),
                                  layers.dtype_of(self.cfg.param_dtype))

    # -------------------------------------------------------- parameters
    def param_tree(self) -> dict:
        """The nested dict of this model's parameters (the tensors
        themselves, not copies)."""
        return _tree_of(self)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> dict:
        """Fill every parameter from ``generator`` (on this model's
        device type), leaf by leaf in sorted path order; returns
        :meth:`param_tree`. ``jax.random`` gives other numbers, so a
        comparison crosses parameters, never inits."""
        params = self.param_tree()
        specs = dict(tree_leaves(self.param_specs()))
        for path, p in tree_leaves(params):
            p.copy_(specs[path].initializer(generator, p.dtype, p.device))
        return params

    @torch.no_grad()
    def load_param_tree(self, tree) -> None:
        """Copy a tree of tensors of this model's paths and shapes (e.g.
        :func:`params_from_numpy` of the reference's) into it."""
        mine = dict(tree_leaves(self.param_tree()))
        theirs = dict(tree_leaves(tree))
        if mine.keys() != theirs.keys():
            raise KeyError(f"parameter paths differ: missing "
                           f"{sorted(mine.keys() - theirs.keys())}, extra "
                           f"{sorted(theirs.keys() - mine.keys())}")
        for path, p in mine.items():
            t = theirs[path]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {tuple(t.shape)} for a "
                                 f"parameter of shape {tuple(p.shape)}")
            p.copy_(t)

    # ------------------------------------------------------------ blocks
    def _apply_block(self, kind: str, p, x, positions, *, enc_out=None,
                     enc_pos=None):
        """One layer over the full sequence -> (x, aux, the layer's cache
        as prefill seeds it: attention's K/V over every position ("k",
        "v"; an enc-dec block also its cross K/V "xk", "xv"), or the SSM's
        or RG-LRU's final conv and state). ``positions`` are
        ``sharding.positions``' 0 … S-1, as every caller builds them,
        which attention states as ``index_positions``."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        pr = probe.ACTIVE
        if kind in ("attn", "moe", "xattn"):
            if pr:
                x = pr.enter("block.attention", x)
            h = layers.apply_norm(p["ln1"], x, cfg)
            y, (k, v) = attention.multihead(p["attn"], h, cfg=cfg,
                                            positions=positions,
                                            return_kv=True,
                                            index_positions=True)
            x = layers.residual(x, y, cfg)
            cache = {"k": k, "v": v}
            if kind == "xattn":
                h = layers.apply_norm(p["lnx"], x, cfg)
                y, (cache["xk"], cache["xv"]) = attention.multihead(
                    p["xattn"], h, cfg=cfg, positions=positions,
                    kv_x=enc_out, kv_positions=enc_pos, causal=False,
                    return_kv=True)
                x = layers.residual(x, y, cfg)
            if pr:
                x = pr.enter("block.ffn", pr.exit("block.attention", x))
            h = layers.apply_norm(p["ln2"], x, cfg)
            if kind == "moe":
                y, aux = moe.moe_mlp(p["moe"], h, cfg)
                x = layers.residual(x, y, cfg)
            else:
                x = layers.residual(x, layers.mlp(p["mlp"], h, cfg), cfg)
            if pr:
                x = pr.exit("block.ffn", x)
        elif kind in ("ssm", "ssm_moe"):
            if pr:
                x = pr.enter("block.ssm", x)
            h = layers.apply_norm(p["ln1"], x, cfg)
            y, cache = ssm.ssm_block(p["ssm"], h, cfg)
            x = layers.residual(x, y, cfg)
            if kind == "ssm_moe":
                if pr:
                    x = pr.enter("block.ffn", pr.exit("block.ssm", x))
                h = layers.apply_norm(p["ln2"], x, cfg)
                y, aux = moe.moe_mlp(p["moe"], h, cfg)
                x = layers.residual(x, y, cfg)
                if pr:
                    x = pr.exit("block.ffn", x)
            elif pr:
                x = pr.exit("block.ssm", x)
        elif kind == "rec":
            if pr:
                x = pr.enter("block.rec", x)
            h = layers.apply_norm(p["ln1"], x, cfg)
            y, cache = rglru.rglru_block(p["rec"], h, cfg)
            x = layers.residual(x, y, cfg)
            if pr:
                x = pr.enter("block.ffn", pr.exit("block.rec", x))
            h = layers.apply_norm(p["ln2"], x, cfg)
            x = layers.residual(x, layers.mlp(p["mlp"], h, cfg), cfg)
            if pr:
                x = pr.exit("block.ffn", x)
        else:
            raise ValueError(kind)
        x = sharding.constrain(x, "batch", "seq", "embed")
        return x, aux, cache

    # ----------------------------------------------------------- forward
    def forward(self, tokens, extras=None):
        """Full-sequence forward of this model's own parameters ->
        (logits (B, S, V) float32, aux scalar)."""
        return self.apply_params(self.param_tree(), tokens, extras=extras)

    def apply_params(self, params, tokens, extras=None):
        """The forward over ``params``, a tree of this model's paths.

        ``extras``: {"patch_embeds": (B,P,D)} for vlm, {"frames": (B,F,D)}
        for encdec.
        """
        cfg = self.cfg
        extras = extras or {}
        b, s = tokens.shape
        pr = probe.ACTIVE
        if pr:
            # the embedding's own path to the table, which a tied head
            # reaches apart
            table = pr.enter("block.embed", params["embed"]["tok"])
            x = pr.exit("block.embed", layers.embed({"tok": table}, tokens,
                                                    cfg))
        else:
            x = layers.embed(params["embed"], tokens, cfg)
        if cfg.family == "vlm" and "patch_embeds" in extras:
            pe = extras["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:, :]], dim=1)
        # split like the tokens: each rank's RoPE tables cover its rows
        positions = sharding.positions(b, s, tokens)
        remat = cfg.remat != "none"

        enc_out = enc_pos = None
        if cfg.family == "encdec":
            enc_out, enc_pos = self._encode(params, extras["frames"])

        if cfg.block_pattern:
            x, aux_total = self._hybrid_forward(params, x, positions)
        else:
            kind = "xattn" if cfg.family == "encdec" else self.kinds[0]
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
            for lp in _unstack(params["blocks"]):
                body = maybe_checkpoint(
                    lambda h, lp=lp: self._apply_block(
                        kind, lp, h, positions, enc_out=enc_out,
                        enc_pos=enc_pos)[:2], remat)
                x, a = body(x)
                aux_total = aux_total + a
        if pr:
            x = pr.enter("block.head", x)
        x = layers.apply_norm(params["final_norm"], x, cfg)
        logits = layers.unembed(params["embed"], x, cfg)
        return logits, aux_total

    def _encode(self, params, frames):
        cfg = self.cfg
        x = frames.to(layers.dtype_of(cfg.compute_dtype))
        b, f, _ = x.shape
        pos = sharding.positions(b, f, x)

        def body(h, lp):
            pr = probe.ACTIVE
            if pr:
                h = pr.enter("block.attention", h)
            h1 = layers.apply_norm(lp["ln1"], h, cfg)
            h = h + attention.multihead(lp["attn"], h1, cfg=cfg,
                                        positions=pos, causal=False)
            if pr:
                h = pr.enter("block.ffn", pr.exit("block.attention", h))
            h2 = layers.apply_norm(lp["ln2"], h, cfg)
            h = h + layers.mlp(lp["mlp"], h2, cfg)
            return pr.exit("block.ffn", h) if pr else h
        for lp in _unstack(params["enc"]):
            x = maybe_checkpoint(lambda h, lp=lp: body(h, lp),
                                 cfg.remat != "none")(x)
        x = layers.apply_norm(params["enc_norm"], x, cfg)
        return x, pos

    def _hybrid_forward(self, params, x, positions):
        """The pattern's layers, under ``remat: full`` recomputed a
        pattern at a time, under ``remat: layer`` a layer at a time (the
        same values; one layer's recompute is live in the backward, not
        the pattern's)."""
        cfg = self.cfg
        slots = list(enumerate(cfg.block_pattern))
        units = [[slot] for slot in slots] if cfg.remat == "layer" \
            else [slots]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(h, lp, unit):
            a = torch.zeros((), dtype=torch.float32, device=h.device)
            for i, k in unit:
                h, ai, _ = self._apply_block(k, lp[f"sub{i}_{k}"], h,
                                             positions)
                a = a + ai
            return h, a
        for lp in _unstack(params["blocks"]):
            for unit in units:
                x, a = maybe_checkpoint(
                    lambda h, lp=lp, unit=unit: body(h, lp, unit),
                    cfg.remat != "none")(x)
                aux = aux + a
        for i, k in enumerate(self.tail_kinds):
            x, ai, _ = self._apply_block(k, params[f"tail{i}"], x,
                                         positions)
            aux = aux + ai
        return x, aux

    # ------------------------------------------------- loss (next token)
    def loss_fn(self, params, batch):
        """Mean float32 NLL of ``batch["labels"]`` (taken as given, no
        shift; labels < 0 are masked) + 0.01 aux -> (loss, metrics)."""
        logits, aux = self.apply_params(
            params, batch["tokens"],
            extras={k: v for k, v in batch.items()
                    if k in ("patch_embeds", "frames")})
        labels = batch["labels"].long()
        logits = logits.float()
        lse = sharding.logsumexp(logits)
        # a vocab-sharded take is a partial sum: reduced here
        ll = sharding.constrain(sharding.take(logits, labels.clamp(min=0)),
                                "batch", "seq")
        mask = (labels >= 0).float()
        # each rank sums its own tokens; the sums are reduced explicitly
        # before the quotient
        rows = sharding.layout(tuple(labels.shape), "batch", "seq")
        total = sharding.summed(sharding.summed(rows, 0), 1)
        nll_sum, count = sharding.per_rank(
            lambda a, b, m: (torch.sum((a - b) * m), m.sum()),
            (lse, ll, mask), (rows,) * 3, (total, total))
        nll = sharding.reduce_by(nll_sum) / \
            torch.clamp(sharding.reduce_by(count), min=1.0)
        loss = nll + 0.01 * aux
        pr = probe.ACTIVE
        if pr:
            loss = pr.exit("block.head", loss)
        return loss, {"loss": nll, "aux": aux}
