"""Shared neural layers of the port's model code (PyTorch; the counterpart of
the JAX package's ``models/layers.py``, the parts the serving path uses).

Conventions, as in the reference:
  * Parameters follow a flat schema of '/'-joined paths; per-layer weights
    are stacked on a leading ``layers`` axis in the schema and split per
    layer in the modules (``model_api``).
  * Tensor layout: activations (B, S, D); attention heads (B, S, H, Dh);
    KV caches (B, S_max, KV, Dh).
  * Norms and softmax in float32; matrix products take bf16 operands and
    accumulate in float32 (``mm``: bf16 result; ``mm_f32``: float32 result,
    the reference's ``preferred_element_type=float32``).
  * A Python number that multiplies a bf16 tensor is rounded to bf16 first
    (``weak_scalar``): JAX does so with a weakly typed scalar, PyTorch would
    keep it in float32.

``shard()`` of the reference is the identity on one device and has no
counterpart here.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

__all__ = ["ParamSchema", "Schema", "init_from_schema", "head_mask",
           "rms_norm", "rope_cache", "apply_rope", "swiglu", "embed_tokens",
           "mm", "mm_f32", "weak_scalar"]

Schema = dict  # path -> ParamSchema


class ParamSchema(NamedTuple):
    shape: tuple
    axes: tuple            # logical axis names, len == len(shape)
    std: float = 0.02
    init: str = "normal"   # normal | zeros | ones


def init_from_schema(schema: Schema, generator: torch.Generator,
                     device, dtype=torch.bfloat16) -> dict:
    """A flat parameter dict from a schema: the reference's shapes, std and
    zeros/ones, drawn path by path in sorted order from ``generator`` (which
    lives on ``device``). The numbers are not JAX's: the two generators
    differ, so tests carry the reference's parameters across instead
    (``convert.lm_params_from_arrays``)."""
    params = {}
    for path, ps in sorted(schema.items()):
        if ps.init == "zeros":
            params[path] = torch.zeros(ps.shape, dtype=dtype, device=device)
        elif ps.init == "ones":
            params[path] = torch.ones(ps.shape, dtype=dtype, device=device)
        else:
            w = torch.randn(ps.shape, generator=generator, device=device,
                            dtype=torch.float32)
            params[path] = (w * ps.std).to(dtype)
    return params


@functools.lru_cache(maxsize=None)
def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: what a JAX weakly
    typed scalar becomes when it meets a tensor of that dtype. Cached, so a
    decode step makes no tensor for it."""
    return float(torch.tensor(value, dtype=dtype))


# ---------------------------------------------------------------------------
# products, norms, rope
# ---------------------------------------------------------------------------

def mm(x, w):
    """``x (..., K) @ w (K, ...)`` with bf16 operands, f32 accumulation and
    a result in x's dtype; w's trailing dims are flattened and restored."""
    out = torch.matmul(x, w.reshape(w.shape[0], -1))
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def mm_f32(x, w):
    """``mm`` with a float32 result (the products of two bf16 numbers are
    exact in float32, so this is the reference's bf16 x bf16 -> f32)."""
    out = torch.matmul(x.float(), w.reshape(w.shape[0], -1).float())
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def head_mask(cfg, dtype=torch.float32, device=None):
    """Activity mask (h_eff,) for padded attention heads, None when no head
    is padded (see the reference's docstring)."""
    h_eff, kv_eff = cfg.h_eff, cfg.kv_eff
    if h_eff == cfg.n_heads and kv_eff == cfg.n_kv_heads:
        return None
    g_eff = h_eff // kv_eff
    g_real = cfg.n_heads // cfg.n_kv_heads
    idx = torch.arange(h_eff, device=device)
    active = ((idx // g_eff) < cfg.n_kv_heads) & ((idx % g_eff) < g_real)
    return active.to(dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(x.dtype)


def rope_cache(seq_len: int, d_head: int, theta: float, device=None,
               pos0: int = 0):
    """(sin, cos) of shape (S, Dh/2), float32, for positions
    ``pos0 .. pos0 + S - 1`` — split-half rotary convention. ``pos0`` is a
    Python int (a decode step's position), so no number is copied from the
    host."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=device) / half)
    positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    if pos0:
        positions = positions + pos0
    ang = positions[:, None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (B, S, H, Dh); sin/cos: (S, Dh/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# mlp / embedding
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    gate = mm(x, w_gate)
    up = mm(x, w_up)
    act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return mm(act, w_down)


def embed_tokens(table, tokens, scale: bool = False):
    out = table[tokens]
    if scale:
        out = out * weak_scalar(math.sqrt(table.shape[1]), out.dtype)
    return out
