"""Dispatch for decode attention: the device of the tensors decides.

A CUDA tensor goes to the hand-written kernel (``decode_attn.py``) and
either launches or raises; a CPU tensor goes to the plain version
(``ref.py``); a meta tensor (the dry run) to the kernel's meta form
(``kernels/meta.py``: the output's shape and the kernel's count). There is
no switch and no fallback: any other device raises.

Unlike the reference's ``ops.decode_attention``, which pads the cache to
its 512-row TPU blocks, nothing is padded: both versions mask the rows past
``pos`` themselves.
"""
from __future__ import annotations

from .. import meta
from .decode_attn import decode_attn_cuda, decode_attn_slice_cuda
from .ref import decode_attn_ref, decode_attn_slice_ref

__all__ = ["decode_attention", "decode_attention_slice"]


def _route(q):
    kind = q.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"decode attention on {q.device}: the kernel takes "
                         "CUDA tensors, its plain version CPU ones, its "
                         "meta form meta ones")
    return kind


def decode_attention(q, k_cache, v_cache, pos: int, window: int = 0):
    """q (B, H, Dh) against caches (B, S, KV, Dh) at position ``pos`` (a
    Python int) -> (B, H, Dh) in ``q.dtype``; ``window > 0`` keeps only the
    last ``window`` positions."""
    kind = _route(q)
    if kind == "cuda":
        return decode_attn_cuda(q, k_cache, v_cache, pos, window)
    if kind == "meta":
        return meta.decode_attention(q, k_cache, v_cache, pos, window)
    return decode_attn_ref(q, k_cache, v_cache, pos, window)


def decode_attention_slice(q, k_slice, v_slice, pos: int, window: int = 0,
                           row0: int = 0):
    """q (B, H, Dh) against a rank's rows ``row0 .. row0 + S_r - 1`` (B,
    S_r, KV, Dh) of a cache sharded along its sequence, at global position
    ``pos`` -> (out (B, H, Dh), lse (B, H)), float32; a slice with no row
    that ``pos`` attends to gives (0, -inf)."""
    kind = _route(q)
    if kind == "cuda":
        return decode_attn_slice_cuda(q, k_slice, v_slice, pos, window, row0)
    if kind == "meta":
        return meta.decode_attention_slice(q, k_slice, v_slice, pos, window,
                                           row0)
    return decode_attn_slice_ref(q, k_slice, v_slice, pos, window, row0)
