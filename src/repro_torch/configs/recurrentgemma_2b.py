"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680,
vocab=256000; RG-LRU + local attention (window 2048), pattern
(rec, rec, attn) -> 8 macro blocks + 2 rec tail layers. O(1)/windowed
state -> runs long_500k. [arXiv:2402.19427; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, mlp_act="geglu", head_dim=256,
    block_pattern=("rec", "rec", "attn"), lru_width=2560, window=2048,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab_size=256, mlp_act="geglu", head_dim=32,
    block_pattern=("rec", "rec", "attn"), lru_width=64, window=8,
    tie_embeddings=True, remat="none",
)
