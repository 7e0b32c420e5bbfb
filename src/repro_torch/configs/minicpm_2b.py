"""MiniCPM-2B: llama-like dense (WSD schedule) [arXiv:2404.06395; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv_heads=36, d_head=64, d_ff=5760, vocab=122753,
    source="arXiv:2404.06395; hf",
))
