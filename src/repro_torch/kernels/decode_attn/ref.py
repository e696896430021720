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

``decode_attn_slice_ref`` is the plain version of the kernel's slice form:
the same attention over one rank's rows of a cache sharded along its
sequence, returning the normalised float32 output and each head's
log-sum-exp, which the ranks fold (``tensor_parallel.fold_attention``).
"""
from __future__ import annotations

import math

import torch

__all__ = ["decode_attn_ref", "decode_attn_slice_ref", "valid_rows",
           "slice_rows"]


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


def slice_rows(s_r: int, row0: int, pos: int,
               window: int = 0) -> tuple[int, int] | None:
    """The local rows (inclusive) of a slice holding global cache rows
    ``row0 .. row0 + s_r - 1`` that position ``pos`` attends to, or None
    when it holds none of them."""
    if pos < 0 or window < 0 or row0 < 0:
        raise ValueError(f"pos={pos}, window={window}, row0={row0}: need "
                         "all >= 0")
    lo_g = max(0, pos - window + 1) if window > 0 else 0
    lo, hi = max(lo_g - row0, 0), min(pos - row0, s_r - 1)
    return (lo, hi) if lo <= hi else None


def decode_attn_slice_ref(q, k_slice, v_slice, pos: int, window: int = 0,
                          row0: int = 0):
    """q (B, H, Dh) against the slice (B, S_r, KV, Dh) of a cache that
    holds its global rows ``row0 .. row0 + S_r - 1``, at global position
    ``pos``: (out (B, H, Dh), lse (B, H)), both float32, out normalised
    over the slice's rows alone and lse the natural log of the sum of
    their exp(scores). A slice with no row that ``pos`` attends to gives
    out 0 and lse -inf."""
    b, h, dh = q.shape
    s_r, kv = k_slice.shape[1], k_slice.shape[2]
    rows = slice_rows(s_r, row0, pos, window)
    if rows is None:
        return (torch.zeros((b, h, dh), dtype=torch.float32, device=q.device),
                torch.full((b, h), float("-inf"), dtype=torch.float32,
                           device=q.device))
    qg = q.reshape(b, kv, h // kv, dh).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg,
                          k_slice.float()) / math.sqrt(dh)
    t = torch.arange(s_r, device=q.device)
    ok = (t >= rows[0]) & (t <= rows[1])
    scores = scores.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    out = torch.einsum("bkgt,btkd->bkgd", p, v_slice.float())
    return out.reshape(b, h, dh), lse.reshape(b, h)
