"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, SWA window 4096. The windowed KV cache is
what lets long_500k run for this arch. [arXiv:2401.04088; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, mlp_act="swiglu",
    n_experts=8, top_k=2, capacity_factor=1.25, window=4096,
    moe_groups=16, num_microbatches=4,
)

SMOKE = ModelConfig(
    name="mixtral-8x22b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, mlp_act="swiglu",
    n_experts=4, top_k=2, capacity_factor=1.25, window=16,
    remat="none",
)
