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

Under a "model" axis (``tp``, ``tensor_parallel.py``) every attention runs
on the rank's heads, or where 12 heads do not divide on every head with
q, k, v gathered over the rank's head_dim columns, and the MLPs on their
mlp columns; the encoder's output is whole on every rank. In a decode
step the self and cross caches are the rank's rows where the decode rules'
"kv_seq" slices them (K5's slice form, folded).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..tensor_parallel import TensorParallel, row_mm
from .layers import (ParamSchema, Schema, apply_rope, causal_attention,
                     cross_attention, dense_attention, embed_tokens, gelu, mm,
                     out_proj, rms_norm, rope_cache)
from .transformer import _out_tp, attend_cache, attention_decode, decode_out

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


def _mha(x, p, cfg, causal: bool = False, sin=None, cos=None, tp=None):
    """Self-attention (kv heads = heads): non-causal (encoder) or causal
    with RoPE (decoder; ``layers.causal_attention``, streaming past 2048
    positions). Returns (out (B, S, D), (k, v)). Under ``tp`` (x the
    region's input) on the rank's heads, or under the head_dim fallback
    every head with q, k, v gathered over "model" (k, v returned as the
    rank's head_dim columns); out the partial sum in float32."""
    q, k, v = mm(x, p.wq), mm(x, p.wk), mm(x, p.wv)
    hd = tp is not None and tp.head_dim_sliced(cfg.d_head, p.wq.shape[-1])
    if hd:
        q, k, v = (tp.gather_head_dim(t) for t in (q, k, v))
    if sin is not None:
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    attend = causal_attention if causal else dense_attention
    ctx = attend(q[:, :, :, None], k, v)[:, :, :, 0].to(x.dtype)
    if tp is None:
        return out_proj(ctx, p.wo, cfg).to(x.dtype), (k, v)
    if hd:
        k, v = tp.own_head_dim(k), tp.own_head_dim(v)
    return _out_tp(ctx, p.wo, cfg, tp), (k, v)


def _cross(x, enc, p, cfg, tp):
    """Cross-attention (prefill, ``tp``: x the region's input, enc the
    encoder's output, whole on every rank) on the rank's heads or, under
    the head_dim fallback, every head: (out partial sum, (ck, cv) of the
    rank's heads or head_dim columns)."""
    q, ck, cv = mm(x, p.wq), mm(enc, p.wk), mm(enc, p.wv)
    hd = tp.head_dim_sliced(cfg.d_head, p.wq.shape[-1])
    if hd:
        q, k, v = (tp.gather_head_dim(t) for t in (q, ck, cv))
    else:
        k, v = ck, cv
    ctx = dense_attention(q[:, :, :, None], k, v)[:, :, :, 0].to(x.dtype)
    return _out_tp(ctx, p.wo, cfg, tp), (ck, cv)


def _gelu_mlp(x, p, cfg, tp=None):
    """The GELU MLP of the residual x; under ``tp`` a region of the rank's
    mlp columns (whole weights, d_ff not dividing: as at model = 1)."""
    if tp is None:
        u = rms_norm(x, p.pre_norm, cfg.norm_eps)
        hdn = gelu(mm(u, p.w_up).float()).to(x.dtype)
        return mm(hdn, p.w_down)
    nw = tp.norm_weight
    u = rms_norm(x, nw(p.pre_norm), cfg.norm_eps)
    if p.w_up.shape[-1] == cfg.d_ff:
        hdn = gelu(mm(u, nw(p.w_up)).float()).to(x.dtype)
        return mm(hdn, nw(p.w_down))
    hdn = gelu(mm(tp.enter(u), p.w_up).float()).to(x.dtype)
    return tp.leave(row_mm(hdn, p.w_down), x.dtype)


def _enc_layer(x, pa, pm, cfg, tp=None):
    if tp is None:
        a, _ = _mha(rms_norm(x, pa.pre_norm, cfg.norm_eps), pa, cfg)
        x = x + a
        return x + _gelu_mlp(x, pm, cfg)
    h = rms_norm(x, tp.norm_weight(pa.pre_norm), cfg.norm_eps)
    x = x + tp.leave(_mha(tp.enter(h), pa, cfg, tp=tp)[0], x.dtype)
    return x + _gelu_mlp(x, pm, cfg, tp)


def whisper_encode(model, frames, cfg, remat: bool = False, tp=None):
    """frames: (B, n_frames, D) post-conv embeddings (the stub). Each layer
    recomputed in backward when ``remat``. ``tp``: a 'tp' "model" axis
    (the frames whole on every rank), ``model`` the rank's slices."""
    x = frames.to(model.embed.table.dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    for pa, pm in zip(model.enc.attn, model.enc.mlp):
        x = (checkpoint(_enc_layer, x, pa, pm, cfg, tp, use_reentrant=False,
                        preserve_rng_state=False) if remat
             else _enc_layer(x, pa, pm, cfg, tp))
    return rms_norm(x, model.enc_final_norm.w, cfg.norm_eps)


def _dec_layer(x, enc, ps, pc, pm, cfg, sin, cos, tp=None):
    """A decoder layer: (x', (k, v), (ck, cv)); under ``tp`` its three
    regions, the encoder's output entering the cross-attention's through
    ``tp.rep`` (each rank's heads' share of its gradient is summed)."""
    if tp is None:
        h = rms_norm(x, ps.pre_norm, cfg.norm_eps)
        a, kv = _mha(h, ps, cfg, causal=True, sin=sin, cos=cos)
        x = x + a
        h = rms_norm(x, pc.pre_norm, cfg.norm_eps)
        ck, cv = mm(enc, pc.wk), mm(enc, pc.wv)
        x = x + cross_attention(h, (ck, cv), pc.wq, pc.wo, cfg).to(x.dtype)
        return x + _gelu_mlp(x, pm, cfg), kv, (ck, cv)
    nw = tp.norm_weight
    h = rms_norm(x, nw(ps.pre_norm), cfg.norm_eps)
    a, kv = _mha(tp.enter(h), ps, cfg, True, sin, cos, tp)
    x = x + tp.leave(a, x.dtype)
    h = rms_norm(x, nw(pc.pre_norm), cfg.norm_eps)
    c, ckv = _cross(tp.enter(h), tp.rep(enc), pc, cfg, tp)
    x = x + tp.leave(c, x.dtype)
    return x + _gelu_mlp(x, pm, cfg, tp), kv, ckv


def _dec_train_layer(x, enc, ps, pc, pm, cfg, sin, cos, tp=None):
    return _dec_layer(x, enc, ps, pc, pm, cfg, sin, cos, tp)[0]


def whisper_forward(model, tokens, cfg, mode: str = "prefill", frames=None,
                    remat: bool = True, tp=None):
    """Encoder over ``frames``, then the decoder over tokens (B, S).
    Returns (hidden (B, S, D), caches {"k", "v": the decoder's self K/V
    (L, B, S, H, Dh); "ck", "cv": the cross K/V of the encoder output
    (L, B, n_frames, H, Dh)}); in mode "train" (hidden, None), each layer
    recomputed in backward when ``remat``. ``tp``: the "model" axis,
    ``model`` the rank's slices; the caches are then of the rank's heads
    (or head_dim columns). The encoder runs 'tp' regions on whole frames
    under 'tp_sp' too (its residual is not the decoder's sequence)."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode={mode!r}: need 'prefill' or 'train'")
    if frames is None:
        raise ValueError("whisper needs frames (B, n_frames, D): the "
                         "stubbed frontend's output (aux_inputs)")
    train = mode == "train"
    if tp is not None:
        x = tp.embed(model.embed.table, tokens)
        tp = tp.layers
    else:
        x = embed_tokens(model.embed.table, tokens)
    enc_tp = tp
    if tp is not None and tp.sp:
        enc_tp = TensorParallel(tp.mesh, "tp", tp.dims)
    enc = whisper_encode(model, frames, cfg, train and remat, enc_tp)
    sin, cos = rope_cache(tokens.shape[1], cfg.d_head, cfg.rope_theta,
                          x.device)
    caches = {"k": [], "v": [], "ck": [], "cv": []}
    for ps, pc, pm in zip(model.dec.self, model.dec.cross, model.dec.mlp):
        args = (x, enc, ps, pc, pm, cfg, sin, cos, tp)
        if train:
            x = (checkpoint(_dec_train_layer, *args, use_reentrant=False,
                            preserve_rng_state=False) if remat
                 else _dec_train_layer(*args))
            continue
        x, (k, v), (ck, cv) = _dec_layer(*args)
        for name, t in (("k", k), ("v", v), ("ck", ck), ("cv", cv)):
            caches[name].append(t)
    w = model.final_norm.w if tp is None else tp.norm_weight(
        model.final_norm.w)
    x = rms_norm(x, w, cfg.norm_eps)
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


@functools.lru_cache(maxsize=None)
def _self_cfg(cfg):
    """``cfg`` with as many K/V heads as q heads, what whisper's attention
    has whatever ``cfg.n_kv_heads`` says (``transformer``'s helpers read
    the K/V heads from the config)."""
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_heads,
                               n_kv_heads_padded=cfg.n_heads_padded)


def whisper_decode_step(model, tokens, cache, pos: int, cfg, tp=None,
                        kv=None, kv_cross=None):
    """One decoder token against the self K/V cache (written in place at
    row ``pos``, a Python int) and the precomputed cross K/V. Returns
    (hidden (B, 1, D), cache). ``tp`` ('tp') and ``kv`` / ``kv_cross``
    (``KVSlice``: the self and cross caches the rank's rows) as in
    ``transformer.dense_decode_step``: q gathered over every head, K5's
    slice form on the rank's rows of each cache, folded."""
    x = (embed_tokens(model.embed.table, tokens) if tp is None
         else tp.embed(model.embed.table, tokens))
    sin, cos = rope_cache(1, cfg.d_head, cfg.rope_theta, x.device, pos)
    sliced = kv_cross is not None and kv_cross.mesh is not None
    last_frame = (cfg.n_audio_frames if sliced else cache["ck"].shape[2]) - 1
    mcfg = _self_cfg(cfg)
    for i, (ps, pc, pm) in enumerate(zip(model.dec.self, model.dec.cross,
                                         model.dec.mlp)):
        h = rms_norm(x, ps.pre_norm, cfg.norm_eps)
        x = x + attention_decode(h, ps, mcfg, sin, cos, cache["k"][i],
                                 cache["v"][i], pos, 0, tp, kv)
        # cross-attention against the fixed encoder K/V: every frame seen
        h = rms_norm(x, pc.pre_norm, cfg.norm_eps)
        qc = mm(h, pc.wq)
        if tp is not None:
            qc = tp.whole_heads(qc, cfg.h_eff, cfg.d_head)
        cx = attend_cache(qc[:, 0], cache["ck"][i], cache["cv"][i],
                          last_frame, 0, kv_cross)
        x = x + decode_out(cx.to(x.dtype)[:, None], pc.wo, cfg, tp, x.dtype)
        x = x + _gelu_mlp(x, pm, cfg, tp)
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), cache
