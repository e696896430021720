"""Decoder-only transformer, dense and MoE families (gemma3, glm4, granite,
yi, qwen2-vl with M-RoPE; qwen3-moe, mixtral with sliding-window attention):
the port of the JAX package's ``models/transformer.py`` — prefill
(``dense_forward``, mode "prefill"), one-token decode
(``dense_decode_step``) against a KV cache, and training (mode "train": no
caches, each layer recomputed in backward under ``remat``, the reference's
``jax.checkpoint`` of its scan body; MoE layers cut the tokens into the
step's ``n_groups``).

The reference scans over stacked layers and carries gemma3's 5:1
local:global pattern as a traced flag; here the layer loop is a Python
loop and the flag a host bool, so choosing the mask, the RoPE table and the
decode window costs nothing on the device. Prefill attention is
``layers.causal_attention``: the scores materialised up to 2048 positions,
the streaming softmax past it. Decode attention goes through the
decode-attention kernel (``kernels/decode_attn``, the TPU kernel K5's
counterpart) with ``window = cfg.window`` on local layers and 0 on global
ones; the reference computes the same function in jnp. The decode cache is
updated in place at ``pos`` (the reference returns it anew; the values are
the same).

M-RoPE (qwen2-vl): a decode step takes the position its own prefill gives
that index (``layers.mrope_positions``), where the reference's decode step
puts the raw index (ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attn.ops import decode_attention
from .layers import (ParamSchema, Schema, apply_rope, causal_attention,
                     embed_tokens, mm, mrope_cache, mrope_positions,
                     mrope_sections, out_proj, rms_norm, rope_cache, swiglu)
from .moe import moe_mlp

__all__ = ["dense_schema", "dense_forward", "dense_decode_step", "init_cache"]

N_GROUPS = 16   # MoE token groups when serving (the reference's default)


def dense_schema(cfg) -> Schema:
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
    }
    if cfg.n_experts:
        e, fe = cfg.n_experts, cfg.d_ff
        s.update({
            "layers/router": ParamSchema((l, d, e), ("layers", "embed", None)),
            "layers/we_gate": ParamSchema((l, e, d, fe), ("layers", "experts", "embed", "expert_mlp")),
            "layers/we_up": ParamSchema((l, e, d, fe), ("layers", "experts", "embed", "expert_mlp")),
            "layers/we_down": ParamSchema((l, e, fe, d), ("layers", "experts", "expert_mlp", "embed"),
                                          std=0.02 / math.sqrt(2 * l)),
        })
    else:
        s.update({
            "layers/w_gate": ParamSchema((l, d, f), ("layers", "embed", "mlp")),
            "layers/w_up": ParamSchema((l, d, f), ("layers", "embed", "mlp")),
            "layers/w_down": ParamSchema((l, f, d), ("layers", "mlp", "embed"),
                                         std=0.02 / math.sqrt(2 * l)),
        })
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


def _ropes_for(cfg, seq: int, device, pos0: int = 0, batch: int = 1):
    """RoPE tables (sin_g, cos_g, sin_l, cos_l) for positions pos0.. ;
    gemma3-style dual theta: local layers use 1e4 when the global theta is
    another. M-RoPE: (B, S, Dh/2) tables of the 3-component positions."""
    if cfg.m_rope:
        pos3 = mrope_positions(batch, seq, cfg.n_vision_tokens, device, pos0)
        sin, cos = mrope_cache(pos3, cfg.d_head, cfg.rope_theta,
                               mrope_sections(cfg.d_head))
        return sin, cos, None, None
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


def _attention_flagged(h, lp, cfg, is_local: bool, sin, cos):
    """Causal attention over the whole sequence (prefill), banded to
    ``cfg.window`` on local layers (``layers.causal_attention``). Returns
    (out (B, S, D), (k, v))."""
    b, s, _ = h.shape
    nh, kv, dh = cfg.h_eff, cfg.kv_eff, cfg.d_head
    q, k, v = _qkv(h, lp, cfg, sin, cos)
    qg = q.reshape(b, s, kv, nh // kv, dh)
    ctx = causal_attention(qg, k, v, cfg.window if is_local else 0,
                           cfg.attn_q_chunk, cfg.attn_kv_chunk,
                           cfg.scores_bf16)
    ctx = ctx.to(h.dtype).reshape(b, s, nh, dh)
    return out_proj(ctx, lp.wo, cfg).to(h.dtype), (k, v)


def _mlp(x, lp, cfg, n_groups: int = N_GROUPS):
    if cfg.n_experts:
        return moe_mlp(x, lp.router, lp.we_gate, lp.we_up, lp.we_down, cfg,
                       n_groups)
    return swiglu(x, lp.w_gate, lp.w_up, lp.w_down)


def _layer_body(x, lp, cfg, is_local: bool, ropes, n_groups: int = N_GROUPS):
    """One transformer block over the whole sequence. Returns (x', (k, v))."""
    sin, cos = _rope_of(ropes, is_local)
    h = rms_norm(x, lp.pre_attn_norm, cfg.norm_eps)
    attn_out, kv_out = _attention_flagged(h, lp, cfg, is_local, sin, cos)
    x = x + attn_out
    h = rms_norm(x, lp.pre_mlp_norm, cfg.norm_eps)
    x = x + _mlp(h, lp, cfg, n_groups)
    return x, kv_out


def _train_layer(x, lp, cfg, is_local: bool, ropes, n_groups: int):
    return _layer_body(x, lp, cfg, is_local, ropes, n_groups)[0]


def dense_forward(model, tokens, cfg, mode: str = "prefill",
                  vision_embeds=None, remat: bool = True,
                  n_groups: int = N_GROUPS):
    """Full-sequence forward of ``model`` (a ``DenseLM``, or a parameter
    view of one: ``model_api.param_view``). Returns (hidden (B, S, D), (k,
    v) caches (L, B, S, KV, Dh)), in mode "train" (hidden, None), each
    layer recomputed in backward when ``remat`` (no activation of a layer
    is kept but its input). ``vision_embeds`` (B, n_vision, D), if given,
    replace the first embeddings (qwen2-vl's stubbed vision tower). MoE
    layers cut the tokens into ``n_groups`` groups."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode={mode!r}: need 'prefill' or 'train'")
    b, s = tokens.shape
    x = embed_tokens(model.embed.table, tokens, scale=_embed_scale(cfg))
    if vision_embeds is not None and cfg.n_vision_tokens:
        if s < vision_embeds.shape[1]:
            raise ValueError(f"{cfg.name}: a prompt of {s} tokens cannot hold "
                             f"{vision_embeds.shape[1]} vision embeddings")
        x[:, :vision_embeds.shape[1]] = vision_embeds.to(x.dtype)
    ropes = _ropes_for(cfg, s, x.device, batch=b)
    ks, vs = [], []
    for lp, is_local in zip(model.layers, _is_local_flags(cfg)):
        if mode == "train" and remat:
            x = checkpoint(_train_layer, x, lp, cfg, is_local, ropes,
                           n_groups, use_reentrant=False,
                           preserve_rng_state=False)
        elif mode == "train":
            x = _train_layer(x, lp, cfg, is_local, ropes, n_groups)
        else:
            x, (k, v) = _layer_body(x, lp, cfg, is_local, ropes, n_groups)
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, model.final_norm.w, cfg.norm_eps)
    if mode == "train":
        return x, None
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
    ropes = _ropes_for(cfg, 1, x.device, pos0=pos, batch=x.shape[0])
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
        x = x + out_proj(ctx, lp.wo, cfg).to(x.dtype)
        h2 = rms_norm(x, lp.pre_mlp_norm, cfg.norm_eps)
        x = x + _mlp(h2, lp, cfg)
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), cache
