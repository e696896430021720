"""Decoder-only transformer, dense family (gemma3, glm4, granite, yi): the
port of the JAX package's ``models/transformer.py`` for serving — prefill
(``dense_forward``, mode "prefill") and one-token decode
(``dense_decode_step``) against a KV cache.

The reference scans over stacked layers and carries gemma3's 5:1
local:global pattern as a traced flag; here the layer loop is a Python
loop and the flag a host bool, so choosing the mask, the RoPE table and the
decode window costs nothing on the device. Decode attention goes through the
decode-attention kernel (``kernels/decode_attn``, the TPU kernel K5's
counterpart) with ``window = cfg.window`` on local layers and 0 on global
ones; the reference computes the same function in jnp. The decode cache is
updated in place at ``pos`` (the reference returns it anew; the values are
the same).

Not ported: MoE experts (``moe.py``), M-RoPE (qwen2-vl) and the streaming
attention of prompts over 2048 tokens; each raises.
"""
from __future__ import annotations

import math

import torch

from ..kernels.decode_attn.ops import decode_attention
from .layers import (ParamSchema, Schema, apply_rope, embed_tokens, head_mask,
                     mm, rms_norm, rope_cache, swiglu)

__all__ = ["dense_schema", "dense_forward", "dense_decode_step", "init_cache",
           "check_dense", "MAX_PREFILL"]

MAX_PREFILL = 2048   # longer prompts take the reference's streaming attention


def check_dense(cfg) -> None:
    """Raise for the parts of the dense family this package does not run."""
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE models (models/moe.py) are not ported")
    if cfg.m_rope or cfg.n_vision_tokens:
        raise NotImplementedError(f"{cfg.name}: M-RoPE / vision inputs are "
                                  "not ported")


def dense_schema(cfg) -> Schema:
    check_dense(cfg)
    l, d, h, kv, dh, f, vp = (cfg.n_layers, cfg.d_model, cfg.h_eff,
                              cfg.kv_eff, cfg.d_head, cfg.d_ff,
                              cfg.vocab_padded)
    s: Schema = {
        "embed/table": ParamSchema((vp, d), ("vocab", "embed")),
        "final_norm/w": ParamSchema((d,), (None,), init="zeros"),
        "layers/pre_attn_norm": ParamSchema((l, d), ("layers", None), init="zeros"),
        "layers/pre_mlp_norm": ParamSchema((l, d), ("layers", None), init="zeros"),
        "layers/wq": ParamSchema((l, d, h, dh), ("layers", "embed", "heads", "head_dim"),
                                 std=0.02),
        "layers/wk": ParamSchema((l, d, kv, dh), ("layers", "embed", "kv_heads", "head_dim")),
        "layers/wv": ParamSchema((l, d, kv, dh), ("layers", "embed", "kv_heads", "head_dim")),
        "layers/wo": ParamSchema((l, h, dh, d), ("layers", "heads", "head_dim", "embed"),
                                 std=0.02 / math.sqrt(2 * l)),
        "layers/w_gate": ParamSchema((l, d, f), ("layers", "embed", "mlp")),
        "layers/w_up": ParamSchema((l, d, f), ("layers", "embed", "mlp")),
        "layers/w_down": ParamSchema((l, f, d), ("layers", "mlp", "embed"),
                                     std=0.02 / math.sqrt(2 * l)),
    }
    if cfg.qk_norm:
        s["layers/q_norm"] = ParamSchema((l, dh), ("layers", None), init="zeros")
        s["layers/k_norm"] = ParamSchema((l, dh), ("layers", None), init="zeros")
    if not cfg.tie_embeddings:
        s["lm_head/table"] = ParamSchema((vp, d), ("vocab", "embed"))
    return s


def _is_local_flags(cfg) -> list[bool]:
    return [k == "local" for k in cfg.attn_kinds]


def _embed_scale(cfg) -> bool:
    return cfg.family == "dense" and cfg.vocab > 200_000


def _ropes_for(cfg, seq: int, device, pos0: int = 0):
    """RoPE tables (sin_g, cos_g, sin_l, cos_l) for positions pos0.. ;
    gemma3-style dual theta: local layers use 1e4 when the global theta is
    another."""
    sin_g, cos_g = rope_cache(seq, cfg.d_head, cfg.rope_theta, device, pos0)
    if cfg.rope_theta != 1e4 and "local" in cfg.attn_pattern:
        sin_l, cos_l = rope_cache(seq, cfg.d_head, 1e4, device, pos0)
    else:
        sin_l = cos_l = None
    return sin_g, cos_g, sin_l, cos_l


def _rope_of(ropes, is_local: bool):
    sin_g, cos_g, sin_l, cos_l = ropes
    if is_local and sin_l is not None:
        return sin_l, cos_l
    return sin_g, cos_g


def _qkv(h, lp, cfg, sin, cos):
    """Projections, qk-norm and RoPE of the normed input h (B, S, D)."""
    q, k, v = mm(h, lp.wq), mm(h, lp.wk), mm(h, lp.wv)
    if cfg.qk_norm:
        q = rms_norm(q, lp.q_norm, cfg.norm_eps)
        k = rms_norm(k, lp.k_norm, cfg.norm_eps)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _out_proj(ctx, lp, cfg):
    """Head mask and output projection of ctx (B, S, H, Dh)."""
    hm = head_mask(cfg, ctx.dtype, ctx.device)
    if hm is not None:
        ctx = ctx * hm[None, None, :, None]
    return mm(ctx.flatten(-2), lp.wo.flatten(0, 1))


def _attention_flagged(h, lp, cfg, is_local: bool, sin, cos):
    """Full-sequence causal attention (prefill), banded to ``cfg.window`` on
    local layers; the scores are materialised (prompts up to 2048).
    Returns (out (B, S, D), (k, v))."""
    b, s, _ = h.shape
    nh, kv, dh = cfg.h_eff, cfg.kv_eff, cfg.d_head
    if s > MAX_PREFILL:
        raise NotImplementedError(
            f"a prompt of {s} tokens needs the streaming attention of the "
            f"reference (over {MAX_PREFILL}), which is not ported")
    q, k, v = _qkv(h, lp, cfg, sin, cos)
    qg = q.reshape(b, s, kv, nh // kv, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) / math.sqrt(dh)
    qi = torch.arange(s, device=h.device)[:, None]
    kj = torch.arange(s, device=h.device)[None, :]
    ok = kj <= qi
    if is_local and cfg.window > 0:
        ok &= kj > qi - cfg.window
    scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(h.dtype)
    ctx = torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(b, s, nh, dh)
    return _out_proj(ctx, lp, cfg).to(h.dtype), (k, v)


def _layer_body(x, lp, cfg, is_local: bool, ropes):
    """One transformer block over the whole sequence. Returns (x', (k, v))."""
    sin, cos = _rope_of(ropes, is_local)
    h = rms_norm(x, lp.pre_attn_norm, cfg.norm_eps)
    attn_out, kv_out = _attention_flagged(h, lp, cfg, is_local, sin, cos)
    x = x + attn_out
    h = rms_norm(x, lp.pre_mlp_norm, cfg.norm_eps)
    x = x + swiglu(h, lp.w_gate, lp.w_up, lp.w_down)
    return x, kv_out


def dense_forward(model, tokens, cfg, mode: str = "prefill"):
    """Full-sequence forward of ``model`` (a ``DenseLM``). Returns (hidden
    (B, S, D), (k, v) caches (L, B, S, KV, Dh)). Only mode "prefill" is
    ported: training is not."""
    if mode != "prefill":
        raise ValueError(f"mode={mode!r}: need 'prefill'")
    b, s = tokens.shape
    x = embed_tokens(model.embed.table, tokens, scale=_embed_scale(cfg))
    ropes = _ropes_for(cfg, s, x.device)
    ks, vs = [], []
    for lp, is_local in zip(model.layers, _is_local_flags(cfg)):
        x, (k, v) = _layer_body(x, lp, cfg, is_local, ropes)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, model.final_norm.w, cfg.norm_eps)
    return x, (torch.stack(ks), torch.stack(vs))


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    shape = (cfg.n_layers, batch, max_len, cfg.kv_eff, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def dense_decode_step(model, tokens, cache, pos: int, cfg):
    """One decode step. tokens (B, 1); cache {"k", "v"} of (L, B, S, KV,
    Dh), written in place at row ``pos`` (a Python int). Returns (hidden
    (B, 1, D), cache)."""
    x = embed_tokens(model.embed.table, tokens, scale=_embed_scale(cfg))
    ropes = _ropes_for(cfg, 1, x.device, pos0=pos)
    for i, (lp, is_local) in enumerate(zip(model.layers,
                                           _is_local_flags(cfg))):
        sin, cos = _rope_of(ropes, is_local)
        h = rms_norm(x, lp.pre_attn_norm, cfg.norm_eps)
        q, k, v = _qkv(h, lp, cfg, sin, cos)
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[:, pos] = k[:, 0].to(k_c.dtype)
        v_c[:, pos] = v[:, 0].to(v_c.dtype)
        window = cfg.window if is_local else 0
        ctx = decode_attention(q[:, 0], k_c, v_c, pos, window)[:, None]
        x = x + _out_proj(ctx, lp, cfg).to(x.dtype)
        h2 = rms_norm(x, lp.pre_mlp_norm, cfg.norm_eps)
        x = x + swiglu(h2, lp.w_gate, lp.w_up, lp.w_down)
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), cache
