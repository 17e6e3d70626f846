"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab_size=49155, mlp_act="swiglu",
    n_experts=32, top_k=8, capacity_factor=1.25, moe_groups=16,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, mlp_act="swiglu",
    n_experts=8, top_k=4, capacity_factor=1.25,
    tie_embeddings=True, remat="none",
)
