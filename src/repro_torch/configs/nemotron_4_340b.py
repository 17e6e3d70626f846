"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000; squared-ReLU MLP. [arXiv:2402.16819]

The largest assigned arch: train_4k requires FSDP+TP and gradient
accumulation (num_microbatches=8) to fit; see EXPERIMENTS.md §Dry-run.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab_size=256000, mlp_act="relu2", head_dim=192,
    num_microbatches=8,
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=384,
    vocab_size=256, mlp_act="relu2", head_dim=16,
    num_microbatches=2, remat="none",
)
