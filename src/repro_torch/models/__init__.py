"""LM model zoo: dense/GQA, MoE, SSM (mamba2), RG-LRU hybrid, enc-dec, VLM."""
from .config import ModelConfig  # noqa: F401
