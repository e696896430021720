"""Qwen2-VL 7B — M-RoPE, dynamic-resolution ViT stubbed (precomputed patch
embeddings via input_specs) [arXiv:2409.12191]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="qwen2-vl-7b", family="dense",
    n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_head=128,
    d_ff=18944, vocab=152064,
    m_rope=True, n_vision_tokens=1024,
    rope_theta=1e6, tie_embeddings=False,
))
