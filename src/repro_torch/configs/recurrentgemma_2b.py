"""RecurrentGemma-2B — Griffin: RG-LRU blocks + local attention, 2:1 pattern
(recurrent, recurrent, local-attn) [arXiv:2402.19427]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="recurrentgemma-2b", family="rglru",
    n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_head=256,
    d_ff=7680, vocab=256000,
    attn_pattern=("recurrent", "recurrent", "local"),
    window=2048, lru_width=2560, conv1d_width=4,
))
