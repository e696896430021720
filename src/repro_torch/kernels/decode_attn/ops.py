"""Dispatch for decode attention: the device of the tensors decides.

A CUDA tensor goes to the hand-written kernel (``decode_attn.py``) and
either launches or raises; a CPU tensor goes to the plain version
(``ref.py``). There is no switch and no fallback.

Unlike the reference's ``ops.decode_attention``, which pads the cache to
its 512-row TPU blocks, nothing is padded: both versions mask the rows past
``pos`` themselves.
"""
from __future__ import annotations

from .decode_attn import decode_attn_cuda
from .ref import decode_attn_ref

__all__ = ["decode_attention"]


def decode_attention(q, k_cache, v_cache, pos: int, window: int = 0):
    """q (B, H, Dh) against caches (B, S, KV, Dh) at position ``pos`` (a
    Python int) -> (B, H, Dh) in ``q.dtype``; ``window > 0`` keeps only the
    last ``window`` positions."""
    if q.is_cuda:
        return decode_attn_cuda(q, k_cache, v_cache, pos, window)
    return decode_attn_ref(q, k_cache, v_cache, pos, window)
