"""Architecture registry of the port: the same ten configs as the JAX
package's (dense: gemma3-1b, glm4-9b, granite-3-8b, yi-34b, qwen2-vl-7b with
M-RoPE; moe: qwen3-moe-30b-a3b, mixtral-8x7b; rwkv6-3b; recurrentgemma-2b;
whisper-small), all of which serve here."""
from .base import (ModelConfig, ShapeSpec, SHAPES, get_config, list_archs,
                   register)

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs",
           "register"]

_LOADED = False

_ARCH_MODULES = [
    "rwkv6_3b", "gemma3_1b", "glm4_9b", "granite_3_8b", "yi_34b",
    "whisper_small", "qwen3_moe_30b_a3b", "mixtral_8x7b",
    "recurrentgemma_2b", "qwen2_vl_7b",
]


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
