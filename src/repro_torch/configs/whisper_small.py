"""Whisper-small — enc-dec audio; conv frontend stubbed (precomputed frame
embeddings via input_specs) [arXiv:2212.04356]."""
from .base import ModelConfig, register

register(ModelConfig(
    name="whisper-small", family="whisper",
    n_layers=12, n_enc_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_head=64,
    d_ff=3072, vocab=51865,
    n_audio_frames=1500,
    tie_embeddings=True,
))
