"""mamba2-1.3b [ssm]: 48L d_model=2048, attn-free, ssm_state=128 (SSD).
vocab=50280. O(1)-state decode -> runs the long_500k cell.
[arXiv:2405.21060]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=256, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    ssm_chunk=8, tie_embeddings=True, remat="none",
)
