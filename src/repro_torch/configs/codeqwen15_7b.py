"""CodeQwen1.5-7B: qwen1.5-arch dense [hf:Qwen/CodeQwen1.5-7B]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_head=128, d_ff=13440, vocab=92416,
    source="hf:Qwen/CodeQwen1.5-7B",
))
