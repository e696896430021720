"""Dispatch for the WKV6 recurrence: the device of the tensors decides.

A CUDA tensor goes to the hand-written kernel (``wkv6.py``) and either
launches or raises; a CPU tensor goes to the plain chunked version
(``ref.py::wkv_chunked``). There is no switch and no fallback.

Unlike the reference's ``ops.wkv6``, which starts from a zero state and
returns y alone, this takes the model's initial state and returns the final
one beside y (what ``models/rwkv6.py`` needs to hand prefill on to decode);
and it pads nothing on the card (the kernel masks the ragged last chunk).
"""
from __future__ import annotations

from .ref import wkv_chunked
from .wkv6 import wkv6_cuda

__all__ = ["wkv6"]


def wkv6(r, k, v, logw, u, state0=None):
    """WKV6 sequence mix. r, k, v, logw (B, T, H, Dh) with logw >= -2,
    u (H, Dh), state0 (B, H, Dh, Dh) or None. Returns (y (B, T, H, Dh)
    float32, final state (B, H, Dh, Dh) float32)."""
    if r.is_cuda:
        return wkv6_cuda(r, k, v, logw, u, state0)
    return wkv_chunked(r, k, v, logw, u, state0)
