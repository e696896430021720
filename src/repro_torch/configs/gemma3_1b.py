"""Gemma-3 1B — 5:1 local:global attention, 128k ctx [hf:google/gemma-3-1b-pt]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152,
    n_heads=4, n_kv_heads=1, d_head=256,
    d_ff=6912, vocab=262144,
    attn_pattern=("local",) * 5 + ("global",),
    window=512, qk_norm=True, rope_theta=1e6,
))
