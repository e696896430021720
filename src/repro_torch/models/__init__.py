"""Model code of the port: every family of the JAX package (dense and MoE
transformers, RWKV-6, RG-LRU, Whisper), for serving (prefill and one-token
decode)."""
from .model_api import (DenseLM, ModelBundle, RGLRULM, RWKV6LM, WhisperLM,
                        get_model, lm_logits, state_from_flat)

__all__ = ["DenseLM", "ModelBundle", "RGLRULM", "RWKV6LM", "WhisperLM",
           "get_model", "lm_logits", "state_from_flat"]
