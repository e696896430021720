"""Model code of the port: every family of the JAX package (dense and MoE
transformers, RWKV-6, RG-LRU, Whisper), for serving (prefill and one-token
decode), and the dense family's training forward and loss."""
from .model_api import (DenseLM, ModelBundle, RGLRULM, RWKV6LM, WhisperLM,
                        chunked_xent_loss, get_model, lm_logits, param_view,
                        state_from_flat, train_forward)

__all__ = ["DenseLM", "ModelBundle", "RGLRULM", "RWKV6LM", "WhisperLM",
           "chunked_xent_loss", "get_model", "lm_logits", "param_view",
           "state_from_flat", "train_forward"]
