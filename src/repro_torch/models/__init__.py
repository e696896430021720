"""Model code of the port: the dense transformer and RWKV-6 families, for
serving (prefill and one-token decode)."""
from .model_api import (DenseLM, ModelBundle, RWKV6LM, get_model, lm_logits,
                        state_from_flat)

__all__ = ["DenseLM", "ModelBundle", "RWKV6LM", "get_model", "lm_logits",
           "state_from_flat"]
