"""InternVL2-76B backbone (InternLM2-76B-ish dense GQA). The InternViT
frontend is a stub: input_specs() provides precomputed patch embeddings
[arXiv:2404.16821; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=28672, vocab=128256,
    embed_inputs=True, source="arXiv:2404.16821; unverified",
))
