"""granite-4.0-h-small [hybrid]: 40L d_model=4096, a period of 10 layers:
Mamba-2 (128 heads of 64, d_state 128, conv 4 over x, B and C with a
bias) at 0-4 and 6-9, NoPE GQA attention (32 heads, kv 8, hd 128,
softmax scale 1/128) at 5; every layer's mixer is followed by 72 experts
of SwiGLU 768 (top-10) and a shared SwiGLU expert of 1,536.
Multipliers: embedding 12, residual 0.22, logits / 16; RMSNorm eps 1e-5;
vocab=100352, tied. 32B-A9B.
[hf:ibm-granite/granite-4.0-h-small config.json]

``SHARE`` is one device's share under 8-way expert parallelism of one
period: the published layers 0-9 at every published width, each layer
holding its experts 0-8 of 72 (the router keeps its 72 outputs and
top-10; the other 63 experts' part of each layer's result is not
computed here). The deployment it stands for: 4 pipeline stages of 10
layers, 8 devices sharing each layer's experts. 2,414,692,992
parameters; it trains on one 80 GB H100."""
import dataclasses

from ..models.config import ModelConfig

#: layer_types of one period: attention at 5 (and 15, 25, 35)
PATTERN = ("ssm_moe",) * 5 + ("moe",) + ("ssm_moe",) * 4

CONFIG = ModelConfig(
    name="granite-4.0-h-small", family="hybrid",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=768,
    vocab_size=100352, mlp_act="swiglu", block_pattern=PATTERN,
    n_experts=72, top_k=10, capacity_factor=1.25, moe_groups=16,
    shared_ff=1536,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    ssm_conv=4, ssm_conv_xbc=True,
    position_embedding="nope", attention_multiplier=0.0078125,
    norm_eps=1e-5, embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, tie_embeddings=True, remat="layer",
)

SMOKE = ModelConfig(
    name="granite-4.0-h-small-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, mlp_act="swiglu",
    block_pattern=("ssm_moe", "ssm_moe", "moe", "ssm_moe", "ssm_moe"),
    n_experts=16, top_k=4, capacity_factor=1.25, moe_groups=2,
    shared_ff=48,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8,
    ssm_conv=4, ssm_conv_xbc=True,
    position_embedding="nope", attention_multiplier=0.0625,
    norm_eps=1e-5, embedding_multiplier=12.0, residual_multiplier=0.22,
    logits_scaling=16.0, tie_embeddings=True, remat="none",
)

SHARE = dataclasses.replace(CONFIG, name="granite-4.0-h-small-ep8",
                            n_layers=10, experts_held=9)
