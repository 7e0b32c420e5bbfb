"""Falcon-Mamba-7B: attention-free Mamba1 [arXiv:2410.05355; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab=65024,
    ssm_version=1, d_state=16, expand=2,
    source="arXiv:2410.05355; unverified",
))
