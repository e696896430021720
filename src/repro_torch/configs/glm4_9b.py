"""GLM-4 9B — RoPE + GQA (kv=2) [hf:THUDM/glm-4-9b]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_head=128,
    d_ff=13696, vocab=151552,
    tie_embeddings=False,
))
