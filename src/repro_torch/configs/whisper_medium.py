"""whisper-medium [audio]: enc-dec, conv frontend stubbed to precomputed
frame embeddings (B, 1500, d). 24L decoder (+24L encoder), d_model=1024,
16H (kv=16), d_ff=4096, vocab=51865. [arXiv:2212.04356]

Deviation note (DESIGN.md §5): RoPE replaces whisper's sinusoidal/learned
positions; LayerNorm kept.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab_size=51865, n_frames=1500,
    mlp_act="gelu", norm="layernorm",
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke", family="encdec",
    n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, n_frames=16,
    mlp_act="gelu", norm="layernorm", remat="none",
)
