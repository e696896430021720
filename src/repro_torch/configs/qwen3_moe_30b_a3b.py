"""Qwen3-MoE 30B-A3B — 128 experts top-8, GQA kv=4 [hf:Qwen/Qwen3-30B-A3B]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab=151936,
    n_experts=128, top_k=8,
    qk_norm=True, rope_theta=1e6,
    tie_embeddings=False,
))
