"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000; anyres tiling stubbed to precomputed patch embeddings
(B, 2880, d) prefix. [hf:llava-hf/llava-v1.6]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, mlp_act="swiglu",
    n_patches=2880,  # anyres: 5 tiles x 576 patches
    num_microbatches=4,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=7, d_ff=112,
    vocab_size=256, mlp_act="swiglu", n_patches=8, remat="none",
)
