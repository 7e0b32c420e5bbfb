"""Gemma2-2B: local+global alternating attention, logit softcaps
[arXiv:2408.00118; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304,
    n_heads=8, n_kv_heads=4, d_head=256, d_ff=9216, vocab=256000,
    local_window=4096, alt_local_global=True,
    attn_softcap=50.0, final_softcap=30.0,
    source="arXiv:2408.00118; hf",
))
