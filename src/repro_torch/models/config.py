"""Model configuration covering all assigned architecture families."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int | None = None

    # MLP
    mlp_act: str = "swiglu"      # swiglu | relu2 | gelu | geglu

    # attention
    rope_theta: float = 10_000.0
    window: int | None = None    # sliding-window size (SWA / local attn)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1          # dispatch groups (ride the data axis)

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (recurrentgemma): repeating layer pattern
    block_pattern: tuple = ()    # e.g. ("rec", "rec", "attn")
    lru_width: int | None = None

    # enc-dec (whisper): encoder stub gets precomputed frame embeddings
    n_enc_layers: int = 0
    n_frames: int = 1500

    # vlm (llava): precomputed patch embeddings prefix
    n_patches: int = 0

    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    # unroll the layer loop (cost-analysis probes: XLA counts scan bodies
    # once, so dryrun probes compile unrolled shallow variants)
    unroll_layers: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # training-step behaviour
    num_microbatches: int = 1
    remat: str = "full"          # none | full
    attn_chunk: int = 1024       # flash-style query block for long sequences

    def kv_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> list[str]:
        """Per-layer kind sequence for hybrid models."""
        if not self.block_pattern:
            kind = {"ssm": "ssm", "moe": "moe"}.get(self.family, "attn")
            return [kind] * self.n_layers
        pat = list(self.block_pattern)
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND roofline cross-check)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * hd * (nh + 2 * nkv) + nh * hd * d
        if self.mlp_act in ("swiglu", "geglu"):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            mlp = mlp * self.n_experts + d * self.n_experts
        ssm = 0
        if self.family == "ssm":
            di, n = self.d_inner, self.ssm_state
            ssm = d * (2 * di + 2 * n) + di * d + self.ssm_heads * 2
            attn = mlp = 0
        per_kind = {"attn": attn + mlp, "moe": attn + mlp, "ssm": ssm,
                    "rec": (self.lru_width or d) * d * 3 + mlp}
        total = 0
        for kind in self.layer_kinds():
            total += per_kind.get(kind, attn + mlp)
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            enc_layer = attn + mlp
            dec_cross = d * hd * (nh + 2 * nkv) + nh * hd * d
            total += self.n_enc_layers * enc_layer + self.n_layers * dec_cross
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_one = (3 if self.mlp_act in ("swiglu", "geglu") else 2) * d * f
        dense = self.param_count() - self.n_layers * self.n_experts * mlp_one
        return int(dense + self.n_layers * self.top_k * mlp_one)
