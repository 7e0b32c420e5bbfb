"""MusicGen-medium: decoder-only over EnCodec tokens. The EnCodec frontend
is a stub: input_specs() provides precomputed frame embeddings
[arXiv:2306.05284; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium", family="dense", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_head=64, d_ff=6144, vocab=2048,
    embed_inputs=True, source="arXiv:2306.05284; hf",
))
