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
           "rms_norm", "rope_cache", "apply_rope", "mrope_positions",
           "mrope_cache", "mrope_sections", "dense_attention",
           "causal_attention", "streaming_attention", "cross_attention",
           "out_proj", "DENSE_MAX", "swiglu", "gelu", "embed_tokens", "mm",
           "mm_f32", "weak_scalar"]

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
    lives on ``device``). A path stacked on a leading ``layers`` axis is
    drawn one slice at a time, so no float32 temporary of its whole shape
    exists (qwen3-moe's ``layers/we_gate`` would need 38.7 GB). The numbers
    are not JAX's: the two generators differ, so tests carry the
    reference's parameters across instead (``convert.lm_params_from_arrays``)."""
    params = {}
    for path, ps in sorted(schema.items()):
        if ps.init == "zeros":
            params[path] = torch.zeros(ps.shape, dtype=dtype, device=device)
        elif ps.init == "ones":
            params[path] = torch.ones(ps.shape, dtype=dtype, device=device)
        else:
            out = torch.empty(ps.shape, dtype=dtype, device=device)
            for part in (out.unbind(0) if ps.axes[:1] == ("layers",)
                         else [out]):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=device, dtype=torch.float32)
                           * ps.std)
            params[path] = out
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
    """x: (B, S, H, Dh); sin/cos: (S, Dh/2), or (B, S, Dh/2) (M-RoPE)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if sin.ndim == 2:
        sin, cos = sin[None], cos[None]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_positions(batch: int, seq_len: int, n_vision: int, device=None,
                    pos0: int = 0):
    """Qwen2-VL M-RoPE position ids (3, B, S), float32: (temporal, height,
    width) of the tokens at indices ``pos0 .. pos0 + S - 1``.

    The first ``n_vision`` indices are vision tokens on a sqrt grid of side
    g: (0, i // g, i % g). Text follows, all three components equal, from
    g on: index i >= n_vision sits at g + (i - n_vision). The reference's
    rule (``layers.mrope_positions``), written per index so that a decode
    step (``pos0`` = its position, S = 1) continues its own prefill; the
    reference's decode step puts the raw index there instead (ROADMAP
    Queue 3). ``pos0`` is a Python int: no number is copied from the
    host."""
    idx = torch.arange(seq_len, device=device)
    if pos0:
        idx = idx + pos0
    if n_vision == 0:
        pos3 = idx.float().expand(3, seq_len)
    else:
        g = max(int(math.sqrt(n_vision)), 1)
        vis = idx < n_vision
        txt = idx + (g - n_vision)
        pos3 = torch.stack([torch.where(vis, 0, txt),
                            torch.where(vis, idx // g, txt),
                            torch.where(vis, idx % g, txt)]).float()
    return pos3[:, None, :].expand(3, batch, seq_len)


def mrope_sections(d_head: int) -> tuple[int, int, int]:
    """Frequency slots of the (temporal, height, width) components: the
    reference's split of Dh/2 (``transformer._ropes_for``), (16, 24, 24) at
    Dh 128."""
    half = d_head // 2
    return half - 2 * (half * 3 // 8), half * 3 // 8, half * 3 // 8


def mrope_cache(positions3, d_head: int, theta: float,
                sections=(16, 24, 24)):
    """Per-token (sin, cos) of (B, S, Dh/2), float32, from 3-component
    positions (3, B, S): frequency slot j takes the position of the
    component its section belongs to."""
    half = d_head // 2
    assert sum(sections) == half, (sections, half)
    dev = positions3.device
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=dev) / half)
    slot = torch.arange(half, device=dev)
    comp = (slot >= sections[0]).long() + (slot >= sections[0] + sections[1])
    ang = positions3[comp].permute(1, 2, 0) * freqs
    return torch.sin(ang), torch.cos(ang)


# ---------------------------------------------------------------------------
# attention (prefill)
# ---------------------------------------------------------------------------

DENSE_MAX = 2048     # longer sequences take the streaming attention


def dense_attention(qg, k, v, ok=None):
    """Attention of grouped queries qg (B, S, KV, G, Dh) over k, v (B, T,
    KV, Dh) with the scores materialised: float32 scores and softmax, the
    probabilities rounded to v's dtype before PV, as the reference's
    einsums do. ``ok`` (S, T) masks the scores (None: every pair). Returns
    (B, S, KV, G, Dh) in v's dtype."""
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) / math.sqrt(qg.shape[-1])
    if ok is not None:
        scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def causal_attention(qg, k, v, window: int = 0, q_chunk: int = 512,
                     kv_chunk: int = 1024, scores_bf16: bool = False):
    """Causal self-attention of a prefill, banded to the last ``window``
    positions if ``window > 0``: ``dense_attention`` up to ``DENSE_MAX``
    positions, ``streaming_attention`` past it (the reference's switch,
    ``transformer._attention_flagged``). Returns (B, S, KV, G, Dh) in v's
    dtype."""
    s = qg.shape[1]
    if s > DENSE_MAX:
        out = streaming_attention(qg, k, v, window > 0, window,
                                  1.0 / math.sqrt(qg.shape[-1]), q_chunk,
                                  kv_chunk, scores_bf16)
        return out.to(v.dtype)
    qi = torch.arange(s, device=qg.device)[:, None]
    kj = torch.arange(s, device=qg.device)[None, :]
    ok = kj <= qi
    if window > 0:
        ok &= kj > qi - window
    return dense_attention(qg, k, v, ok)


def streaming_attention(qg, k, v, is_local: bool, window: int, scale: float,
                        q_chunk: int = 512, kv_chunk: int = 1024,
                        scores_bf16: bool = False):
    """Causal attention with a streaming (online) softmax, block by block:
    the reference's ``layers.streaming_attention`` (Rabe-Staats /
    flash-style), in plain torch as the reference computes it in jnp.

    qg: (B, S, KV, G, Dh) grouped queries; k, v: (B, T, KV, Dh). Query
    chunks (outer) against KV chunks (inner), each of the size asked for
    but the last, which is ragged. (The reference shrinks each chunk until
    it divides its length, which at a prime length past a chunk leaves
    chunks of one row; the function is the same, the sums' order differs.)
    ``is_local`` (a host bool) with ``window > 0`` bands the mask to the
    last ``window`` keys. Scores in float32 (rounded to bf16 first with
    ``scores_bf16``), probabilities rounded to v's dtype before PV. Returns
    (B, S, KV, G, Dh) float32.

    A block pair wholly masked (in the causal future, or wholly outside the
    band) is skipped: once the running max m is finite such a pair leaves
    the state as it was bit for bit (corr = 1, p = 0), and before that
    every term is 0, so the result is the reference's."""
    b, s, kvh, g, dh = qg.shape
    t = k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, s), min(kv_chunk, t)
    band = is_local and window > 0
    dev = qg.device
    kf, vf = k.float(), v.float()
    out = torch.empty((b, s, kvh, g, dh), dtype=torch.float32, device=dev)
    for i0 in range(0, s, q_chunk):
        i1 = min(i0 + q_chunk, s)
        qi = qg[:, i0:i1].float()
        qidx = torch.arange(i0, i1, device=dev)[:, None]
        m = torch.full((b, kvh, g, i1 - i0), float("-inf"), device=dev)
        l = torch.zeros((b, kvh, g, i1 - i0), device=dev)
        acc = torch.zeros((b, kvh, g, i1 - i0, dh), device=dev)
        for j0 in range(0, t, kv_chunk):
            j1 = min(j0 + kv_chunk, t)
            if j0 > i1 - 1:                       # the causal future
                break
            if band and j1 - 1 <= i0 - window:    # before the band
                continue
            kidx = torch.arange(j0, j1, device=dev)[None, :]
            sc = torch.einsum("bqkgd,btkd->bkgqt", qi, kf[:, j0:j1])
            if scores_bf16:
                sc = sc.to(torch.bfloat16)
            sc = sc.float() * scale
            ok = kidx <= qidx
            if band:
                ok &= kidx > qidx - window
            sc = sc.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            # guard fully masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(sc - m_safe[..., None]).masked_fill(~ok, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(v.dtype).float(), vf[:, j0:j1])
            m = m_new
        out[:, i0:i1] = (acc / torch.clamp(l, min=1e-30)[..., None]
                         ).permute(0, 3, 1, 2, 4)
    return out


def cross_attention(x, enc_kv, wq, wo, cfg):
    """Decoder cross-attention (prefill) of x (B, S, D) against the encoder's
    precomputed (k, v) (B, T, KV, Dh): no mask, padded heads zeroed. The
    reference's ``layers.cross_attention``, with the KV head count taken
    from k (whisper's K/V have as many heads as q, whatever
    ``cfg.n_kv_heads`` says)."""
    b, s, _ = x.shape
    k, v = enc_kv
    nh, kvh = cfg.h_eff, k.shape[2]
    q = mm(x, wq).reshape(b, s, kvh, nh // kvh, cfg.d_head)
    return out_proj(dense_attention(q, k, v).reshape(b, s, nh, cfg.d_head),
                    wo, cfg)


def out_proj(ctx, wo, cfg):
    """Padded heads zeroed (``head_mask``), then the output projection of
    ctx (B, S, H, Dh) by wo (H, Dh, D)."""
    hm = head_mask(cfg, ctx.dtype, ctx.device)
    if hm is not None:
        ctx = ctx * hm[None, None, :, None]
    return mm(ctx.flatten(-2), wo.flatten(0, 1))


# ---------------------------------------------------------------------------
# mlp / embedding
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down, down=mm):
    """The gated MLP; ``down`` makes its last product (the "model" axis's
    row-parallel partial sum, ``tensor_parallel.row_mm``)."""
    gate = mm(x, w_gate)
    up = mm(x, w_up)
    act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return down(act, w_down)


def gelu(x):
    """GELU in its tanh form: ``jax.nn.gelu``'s default."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def embed_tokens(table, tokens, scale: bool = False):
    out = table[tokens]
    if scale:
        out = out * weak_scalar(math.sqrt(table.shape[1]), out.dtype)
    return out
