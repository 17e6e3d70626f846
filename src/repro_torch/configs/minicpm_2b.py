"""minicpm-2b [dense]: 40L d_model=2304 36H (kv=36) d_ff=5760
vocab=122753; llama-like with the WSD schedule (train/optim.py).
[arXiv:2404.06395; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753, mlp_act="swiglu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="minicpm-2b-smoke", family="dense",
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, d_ff=144,
    vocab_size=256, mlp_act="swiglu", tie_embeddings=True, remat="none",
)
