"""Plain PyTorch version of the decode-attention kernel
(``csrc/decode_attn.cu``).

It computes what the JAX package's ``kernels/decode_attn/ref.py::
decode_attn_ref`` computes — one query token per head against a KV cache,
GQA, causal to ``pos`` and optionally banded to the last ``window``
positions, softmax in float32 — and returns it in ``q.dtype``, the contract
of the TPU kernel (the JAX oracle itself returns float32). A ragged cache
length needs no padding: rows past ``pos`` are masked. The CUDA kernel is
held against this function on the card, and it is what runs when the
tensors lie on the CPU.
"""
from __future__ import annotations

import math

import torch

__all__ = ["decode_attn_ref", "valid_rows"]


def valid_rows(s: int, pos: int, window: int = 0) -> tuple[int, int]:
    """First and last cache row (inclusive) that position ``pos`` attends
    to in a cache of ``s`` rows: ``max(0, pos - window + 1)`` (0 without a
    window) to ``min(pos, s - 1)``."""
    if pos < 0:
        raise ValueError(f"pos={pos}: need pos >= 0")
    if window < 0:
        raise ValueError(f"window={window}: need window >= 0")
    lo = max(0, pos - window + 1) if window > 0 else 0
    return lo, min(pos, s - 1)


def decode_attn_ref(q, k_cache, v_cache, pos: int, window: int = 0):
    """q (B, H, Dh); caches (B, S, KV, Dh) with H % KV == 0; ``pos`` a
    Python int. Returns (B, H, Dh) in ``q.dtype``.

    Heads are grouped KV-major: head ``h`` reads KV head ``h // (H / KV)``.
    Cache row ``t`` is seen when ``t <= pos`` and, if ``window > 0``,
    ``t > pos - window``."""
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    valid_rows(s, pos, window)
    qg = q.reshape(b, kv, h // kv, dh).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg,
                          k_cache.float()) / math.sqrt(dh)
    t = torch.arange(s, device=q.device)
    ok = t <= pos
    if window > 0:
        ok &= t > pos - window
    scores = scores.masked_fill(~ok, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)
