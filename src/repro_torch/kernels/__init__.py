"""Hand-written GPU kernels of the port, each beside its plain PyTorch version.

Each wrapper module keeps a ``launch_counts`` dict that its wrappers add one
to where they launch their kernel on the card, and nowhere else;
``launch_counts()`` and ``reset_launch_counts()`` here read and zero all of
them at once.
"""
from __future__ import annotations

__all__ = ["launch_counts", "reset_launch_counts"]


def _counting_modules() -> tuple:
    from .amp_fused import amp_fused, col
    from .decode_attn import decode_attn
    from .quantize import quantize
    from .wkv6 import wkv6
    return amp_fused, col, quantize, decode_attn, wkv6


def launch_counts() -> dict:
    """Every wrapper's launches in this process since the last reset, by
    kernel."""
    return {k: v for mod in _counting_modules()
            for k, v in mod.launch_counts.items()}


def reset_launch_counts() -> None:
    """Sets every wrapper's launch count to 0."""
    for mod in _counting_modules():
        mod.reset_launch_counts()
