"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="rwkv6-3b", family="rwkv6",
    n_layers=32, d_model=2560,
    n_heads=40, n_kv_heads=40, d_head=64,   # wkv head size 64
    d_ff=8960, vocab=65536,
    tie_embeddings=False,
))
