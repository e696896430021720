"""Whisper-small encoder-decoder backbone [arXiv:2212.04356]: the port of
the JAX package's ``models/whisper.py``: prefill, decode and training (mode
"train": no caches, each encoder and decoder layer recomputed in backward
under ``remat``).

The conv frontend is a stub, as in the reference: the caller supplies
post-conv frame embeddings (B, n_frames, D) (``WhisperLM.aux_inputs``).
Encoder: non-causal self-attention over the frames with fixed sinusoidal
positions. Decoder: causal self-attention with RoPE (the reference's
deviation from Whisper's learned 448-position table), cross-attention into
the encoder output and a GELU MLP.

A decode step runs the decode-attention kernel (K5) twice a layer: for the
self-attention at ``pos`` with no window, and for the cross-attention
against the fixed encoder caches (B, n_frames, H, Dh), which is the same
function at ``pos = n_frames - 1`` (every frame seen). The self-attention
cache is written in place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attn.ops import decode_attention
from .layers import (ParamSchema, Schema, apply_rope, causal_attention,
                     cross_attention, dense_attention, embed_tokens, gelu, mm,
                     out_proj, rms_norm, rope_cache)

__all__ = ["whisper_schema", "whisper_encode", "whisper_forward",
           "whisper_decode_step", "whisper_init_cache"]


def _attn_schema(l, d, h, dh, prefix) -> Schema:
    return {
        f"{prefix}/pre_norm": ParamSchema((l, d), ("layers", None), init="zeros"),
        f"{prefix}/wq": ParamSchema((l, d, h, dh), ("layers", "embed", "heads", "head_dim")),
        f"{prefix}/wo": ParamSchema((l, h, dh, d), ("layers", "heads", "head_dim", "embed")),
        f"{prefix}/wk": ParamSchema((l, d, h, dh), ("layers", "embed", "heads", "head_dim")),
        f"{prefix}/wv": ParamSchema((l, d, h, dh), ("layers", "embed", "heads", "head_dim")),
    }


def _mlp_schema(l, d, f, prefix) -> Schema:
    return {
        f"{prefix}/pre_norm": ParamSchema((l, d), ("layers", None), init="zeros"),
        f"{prefix}/w_up": ParamSchema((l, d, f), ("layers", "embed", "mlp")),
        f"{prefix}/w_down": ParamSchema((l, f, d), ("layers", "mlp", "embed")),
    }


def whisper_schema(cfg) -> Schema:
    d, h, dh, f = cfg.d_model, cfg.h_eff, cfg.d_head, cfg.d_ff
    le, ld, vp = cfg.n_enc_layers, cfg.n_layers, cfg.vocab_padded
    s: Schema = {
        "embed/table": ParamSchema((vp, d), ("vocab", "embed")),
        "enc_final_norm/w": ParamSchema((d,), (None,), init="zeros"),
        "final_norm/w": ParamSchema((d,), (None,), init="zeros"),
    }
    s.update(_attn_schema(le, d, h, dh, "enc/attn"))
    s.update(_mlp_schema(le, d, f, "enc/mlp"))
    s.update(_attn_schema(ld, d, h, dh, "dec/self"))
    # cross K/V projections read the encoder output
    s.update(_attn_schema(ld, d, h, dh, "dec/cross"))
    s.update(_mlp_schema(ld, d, f, "dec/mlp"))
    return s


def _sinusoid(n: int, d: int, device=None):
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mha(x, p, cfg, causal: bool = False, sin=None, cos=None):
    """Self-attention (kv heads = heads): non-causal (encoder) or causal
    with RoPE (decoder; ``layers.causal_attention``, streaming past 2048
    positions). Returns (out (B, S, D), (k, v))."""
    q, k, v = mm(x, p.wq), mm(x, p.wk), mm(x, p.wv)
    if sin is not None:
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    attend = causal_attention if causal else dense_attention
    ctx = attend(q[:, :, :, None], k, v)[:, :, :, 0].to(x.dtype)
    return out_proj(ctx, p.wo, cfg).to(x.dtype), (k, v)


def _gelu_mlp(x, p, cfg):
    u = rms_norm(x, p.pre_norm, cfg.norm_eps)
    hdn = gelu(mm(u, p.w_up).float()).to(x.dtype)
    return mm(hdn, p.w_down)


def _enc_layer(x, pa, pm, cfg):
    a, _ = _mha(rms_norm(x, pa.pre_norm, cfg.norm_eps), pa, cfg)
    x = x + a
    return x + _gelu_mlp(x, pm, cfg)


def whisper_encode(model, frames, cfg, remat: bool = False):
    """frames: (B, n_frames, D) post-conv embeddings (the stub). Each layer
    recomputed in backward when ``remat``."""
    x = frames.to(model.embed.table.dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    for pa, pm in zip(model.enc.attn, model.enc.mlp):
        x = (checkpoint(_enc_layer, x, pa, pm, cfg, use_reentrant=False,
                        preserve_rng_state=False) if remat
             else _enc_layer(x, pa, pm, cfg))
    return rms_norm(x, model.enc_final_norm.w, cfg.norm_eps)


def _dec_layer(x, enc, ps, pc, pm, cfg, sin, cos):
    """A decoder layer: (x', (k, v), (ck, cv))."""
    h = rms_norm(x, ps.pre_norm, cfg.norm_eps)
    a, kv = _mha(h, ps, cfg, causal=True, sin=sin, cos=cos)
    x = x + a
    h = rms_norm(x, pc.pre_norm, cfg.norm_eps)
    ck, cv = mm(enc, pc.wk), mm(enc, pc.wv)
    x = x + cross_attention(h, (ck, cv), pc.wq, pc.wo, cfg).to(x.dtype)
    return x + _gelu_mlp(x, pm, cfg), kv, (ck, cv)


def _dec_train_layer(x, enc, ps, pc, pm, cfg, sin, cos):
    return _dec_layer(x, enc, ps, pc, pm, cfg, sin, cos)[0]


def whisper_forward(model, tokens, cfg, mode: str = "prefill", frames=None,
                    remat: bool = True):
    """Encoder over ``frames``, then the decoder over tokens (B, S).
    Returns (hidden (B, S, D), caches {"k", "v": the decoder's self K/V
    (L, B, S, H, Dh); "ck", "cv": the cross K/V of the encoder output
    (L, B, n_frames, H, Dh)}); in mode "train" (hidden, None), each layer
    recomputed in backward when ``remat``."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode={mode!r}: need 'prefill' or 'train'")
    if frames is None:
        raise ValueError("whisper needs frames (B, n_frames, D): the "
                         "stubbed frontend's output (aux_inputs)")
    train = mode == "train"
    enc = whisper_encode(model, frames, cfg, remat=train and remat)
    x = embed_tokens(model.embed.table, tokens)
    sin, cos = rope_cache(tokens.shape[1], cfg.d_head, cfg.rope_theta,
                          x.device)
    caches = {"k": [], "v": [], "ck": [], "cv": []}
    for ps, pc, pm in zip(model.dec.self, model.dec.cross, model.dec.mlp):
        args = (x, enc, ps, pc, pm, cfg, sin, cos)
        if train:
            x = (checkpoint(_dec_train_layer, *args, use_reentrant=False,
                            preserve_rng_state=False) if remat
                 else _dec_train_layer(*args))
            continue
        x, (k, v), (ck, cv) = _dec_layer(*args)
        for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
            caches[name].append(t)
    x = rms_norm(x, model.final_norm.w, cfg.norm_eps)
    if train:
        return x, None
    return x, {name: torch.stack(ts) for name, ts in caches.items()}


def whisper_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                       device="cuda") -> dict:
    l, h, dh = cfg.n_layers, cfg.h_eff, cfg.d_head
    zeros = lambda s: torch.zeros((l, batch, s, h, dh), dtype=dtype,
                                  device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "ck": zeros(cfg.n_audio_frames), "cv": zeros(cfg.n_audio_frames)}


def whisper_decode_step(model, tokens, cache, pos: int, cfg):
    """One decoder token against the self K/V cache (written in place at
    row ``pos``, a Python int) and the precomputed cross K/V. Returns
    (hidden (B, 1, D), cache)."""
    x = embed_tokens(model.embed.table, tokens)
    sin, cos = rope_cache(1, cfg.d_head, cfg.rope_theta, x.device, pos)
    last_frame = cache["ck"].shape[2] - 1
    for i, (ps, pc, pm) in enumerate(zip(model.dec.self, model.dec.cross,
                                         model.dec.mlp)):
        h = rms_norm(x, ps.pre_norm, cfg.norm_eps)
        q, k, v = mm(h, ps.wq), mm(h, ps.wk), mm(h, ps.wv)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[:, pos] = k[:, 0].to(k_c.dtype)
        v_c[:, pos] = v[:, 0].to(v_c.dtype)
        ctx = decode_attention(q[:, 0], k_c, v_c, pos)[:, None]
        x = x + mm(ctx.flatten(-2), ps.wo.flatten(0, 1)).to(x.dtype)
        # cross-attention against the fixed encoder K/V: every frame seen
        h = rms_norm(x, pc.pre_norm, cfg.norm_eps)
        qc = mm(h, pc.wq)
        cx = decode_attention(qc[:, 0], cache["ck"][i], cache["cv"][i],
                              last_frame)[:, None]
        x = x + mm(cx.flatten(-2), pc.wo.flatten(0, 1)).to(x.dtype)
        x = x + _gelu_mlp(x, pm, cfg)
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), cache
