"""Mixtral 8x7B — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000,
    n_experts=8, top_k=2,
    attn_pattern=("local",), window=4096,   # SWA on every layer
    tie_embeddings=False,
))
