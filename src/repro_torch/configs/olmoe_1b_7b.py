"""OLMoE-1B-7B: 64 experts top-8 [arXiv:2409.02060; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_head=128, d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, n_shared_experts=0, d_expert=1024,
    source="arXiv:2409.02060; hf",
))
