"""Zamba2-2.7B: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].  Simplifications noted in DESIGN.md: the shared
block's per-invocation LoRA adapters and the embedding-concat input are
omitted; the shared transformer block (tied weights) fires every 6 mamba
layers."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_head=80, d_ff=10240, vocab=32000,
    ssm_version=2, d_state=64, expand=2, head_dim=64, shared_attn_every=6,
    source="arXiv:2411.15242; hf",
))
