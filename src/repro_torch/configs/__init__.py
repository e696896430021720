"""Architecture registry of the port: the dense and RWKV-6 models whose
serving path runs here (gemma3-1b, glm4-9b, granite-3-8b, yi-34b, rwkv6-3b).
The JAX package's MoE, RG-LRU, Whisper and M-RoPE (qwen2-vl) configs are not
registered: their model code is not ported."""
from .base import (ModelConfig, ShapeSpec, SHAPES, get_config, list_archs,
                   register)

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs",
           "register"]

_LOADED = False

_ARCH_MODULES = ["rwkv6_3b", "gemma3_1b", "glm4_9b", "granite_3_8b", "yi_34b"]


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
