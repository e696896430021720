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

Training under a "model" axis (``tp``, ``tensor_parallel.py``) runs each
block as one region on the rank's q heads (K/V heads where they divide;
where they do not, every K/V head, each local q head meeting the one it
meets at model = 1, by global index), mlp columns or experts, the residual
whole ('tp') or the rank's rows of the sequence ('tp_sp'); under 'fsdp'
only the embedding and the loss are vocab-parallel. Where the heads do not
divide the axis, the rules slice the head_dim: q, k and v are gathered
whole over "model" before qk-norm and RoPE, every rank attends with every
head, and its head_dim columns of the context enter ``wo``'s row product
(``_out_tp``).

Serving under "model" (``launch/steps.py::ServeStep``, 'tp', no autograd):
prefill runs the same regions and returns the caches of the rank's K/V
heads (whole K/V where they do not divide). A decode step takes the
decode rules' cache, a rank's rows of it (``tensor_parallel.KVSlice``):
per layer q on the rank's heads (or head_dim columns) and K/V on its
K/V heads, q and the new K/V row gathered whole over "model", the row
written by the rank whose rows hold ``pos``, K5's slice form on the rank's
rows and the partials folded over the "kv_seq" axes
(``tensor_parallel.fold_attention``), then the rank's heads (or columns)
of the context into ``wo`` summed over "model", and the MLP or MoE region
as in training (``attention_decode``, which recurrentgemma and whisper
share).
A cache whole on every rank (the "kv_seq" axes do not divide its length)
takes K5's one-device form, no fold.

M-RoPE (qwen2-vl): a decode step takes the position its own prefill gives
that index (``layers.mrope_positions``), where the reference's decode step
puts the raw index (ROADMAP Queue 3).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.decode_attn.ops import decode_attention, decode_attention_slice
from ..tensor_parallel import fold_attention, row_mm
from .layers import (ParamSchema, Schema, apply_rope, causal_attention,
                     embed_tokens, head_mask, mm, mrope_cache,
                     mrope_positions, mrope_sections, out_proj, rms_norm,
                     rope_cache, swiglu, weak_scalar)
from .moe import moe_mlp

__all__ = ["dense_schema", "dense_forward", "dense_decode_step", "init_cache",
           "attention_decode", "attend_cache", "write_row", "decode_out",
           "swiglu_tp"]

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
    """Whether the embeddings are scaled by sqrt(D): gemma's (a dense
    vocabulary past 200k) and recurrentgemma's."""
    return cfg.family == "rglru" or (cfg.family == "dense"
                                     and cfg.vocab > 200_000)


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


def _kv_whole(lp, cfg) -> bool:
    """Whether the K/V weights are whole on every rank (their heads do not
    divide the "model" axis and the heads do: the rules slice neither
    their heads nor their head_dim)."""
    return tuple(lp.wk.shape[-2:]) == (cfg.kv_eff, cfg.d_head)


def _hd(lp, cfg, tp) -> bool:
    """Whether ``tp`` slices the attention's head_dim (the fallback)."""
    return tp is not None and tp.head_dim_sliced(cfg.d_head,
                                                 lp.wq.shape[-1])


def _qkv(h, lp, cfg, sin, cos, tp=None):
    """Projections, qk-norm and RoPE of the normed input h (B, S, D). Under
    ``tp`` (h the region's input) whole K/V weights and the qk-norm weights
    enter through ``tp.rep``; under the head_dim fallback q, k and v are
    gathered whole over "model" first (``TensorParallel.gather_head_dim``):
    qk-norm and the split-half RoPE need whole heads."""
    rep = (lambda w: w) if tp is None else tp.rep
    wk, wv = lp.wk, lp.wv
    if tp is not None and _kv_whole(lp, cfg):
        wk, wv = rep(wk), rep(wv)
    q, k, v = mm(h, lp.wq), mm(h, wk), mm(h, wv)
    if _hd(lp, cfg, tp):
        q, k, v = (tp.gather_head_dim(t) for t in (q, k, v))
    if cfg.qk_norm:
        q = rms_norm(q, rep(lp.q_norm), cfg.norm_eps)
        k = rms_norm(k, rep(lp.k_norm), cfg.norm_eps)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _attention_flagged(h, lp, cfg, is_local: bool, sin, cos, tp=None):
    """Causal attention over the whole sequence (prefill), banded to
    ``cfg.window`` on local layers (``layers.causal_attention``). Returns
    (out (B, S, D), (k, v)); under ``tp`` on this rank's q heads (its K/V
    heads where they divide, else the whole K/V heads each meets at
    model = 1), out the output projection's partial sum in float32 and
    (k, v) the rank's K/V heads (whole where they do not divide). Under
    the head_dim fallback every rank attends with every head and (k, v)
    are the rank's head_dim columns."""
    b, s, _ = h.shape
    dh = cfg.d_head
    q, k, v = _qkv(h, lp, cfg, sin, cos, tp)
    hd = _hd(lp, cfg, tp)
    heads = (range(cfg.h_eff) if tp is None or hd
             else tp.local_heads(cfg.h_eff, lp.wq.shape[-2]))
    ka, va = k, v
    if tp is not None and not hd and _kv_whole(lp, cfg):
        ka, va, (nkv, g) = _kv_for_heads(k, v, heads, cfg)
    else:
        nkv = k.shape[2]
        g = len(heads) // nkv
    ctx = causal_attention(q.reshape(b, s, nkv, g, dh), ka, va,
                           cfg.window if is_local else 0, cfg.attn_q_chunk,
                           cfg.attn_kv_chunk, cfg.scores_bf16)
    ctx = ctx.to(h.dtype).reshape(b, s, len(heads), dh)
    if tp is None:
        return out_proj(ctx, lp.wo, cfg).to(h.dtype), (k, v)
    if hd:
        k, v = tp.own_head_dim(k), tp.own_head_dim(v)
    return _out_tp(ctx, lp.wo, cfg, tp), (k, v)


def _out_tp(ctx, wo, cfg, tp):
    """The output projection's partial sum (float32) of the context ctx
    (B, S, H', Dh'), whole or already the rank's heads: the rank's heads of
    it, or under the head_dim fallback its head_dim columns, padded heads
    zeroed, against its slice ``wo`` (H/m, Dh, D) or (H, Dh/m, D)."""
    hl, dl = wo.shape[0], wo.shape[1]
    heads = (range(cfg.h_eff) if hl == cfg.h_eff
             else tp.local_heads(cfg.h_eff, hl))
    if ctx.shape[-2] != hl:
        ctx = ctx[:, :, heads.start:heads.stop]
    if ctx.shape[-1] != dl:
        ctx = tp.own_head_dim(ctx)
    hm = head_mask(cfg, ctx.dtype, ctx.device)
    if hm is not None:
        ctx = ctx * hm[heads.start:heads.stop][None, None, :, None]
    return row_mm(ctx.flatten(-2), wo.flatten(0, 1))


def attend_cache(q, k_c, v_c, pos: int, window: int, kv):
    """K5 over a decode cache for q (B, H, Dh) of whole heads: the slice
    form on the rank's rows, folded over ``kv.mesh``
    (``tensor_parallel.fold_attention``), where ``kv`` (a ``KVSlice``)
    slices the cache; else the one-device form. Float32 or q's dtype."""
    if kv is not None and kv.mesh is not None:
        o, lse = decode_attention_slice(q, k_c, v_c, pos, window, kv.row0)
        return fold_attention(o, lse, kv.mesh)
    return decode_attention(q, k_c, v_c, pos, window)


def write_row(c, row, pos: int, kv) -> None:
    """Row ``pos`` of the cache ``c`` (B, S, ...) set to ``row`` (B, ...),
    by the rank whose rows hold it (every rank where ``kv`` does not
    slice the cache)."""
    if kv is None or kv.mesh is None:
        c[:, pos] = row.to(c.dtype)
    elif kv.holds(pos):
        c[:, pos - kv.row0] = row.to(c.dtype)


def decode_out(ctx, wo, cfg, tp, dtype):
    """The output projection of a decode step's context ctx (B, 1, H, Dh)
    of every head: whole, or under ``tp`` the rank's part of it summed
    over "model"."""
    if tp is None:
        return out_proj(ctx, wo, cfg).to(dtype)
    return tp.leave(_out_tp(ctx, wo, cfg, tp), dtype)


def attention_decode(h, lp, cfg, sin, cos, k_c, v_c, pos: int, window: int,
                     tp=None, kv=None):
    """The self-attention of one decode step from the normed input h (B, 1,
    D): q, k, v on the rank's heads or head_dim columns gathered whole
    over "model", the new K/V row written at ``pos``, K5 (``attend_cache``)
    and the output projection (``decode_out``). Returns its output (B, 1,
    D) in h's dtype."""
    q, k, v = _qkv(h, lp, cfg, sin, cos, tp)
    if tp is not None:
        q = tp.whole_heads(q, cfg.h_eff, cfg.d_head)
        k = tp.whole_heads(k, cfg.kv_eff, cfg.d_head)
        v = tp.whole_heads(v, cfg.kv_eff, cfg.d_head)
    write_row(k_c, k[:, 0], pos, kv)
    write_row(v_c, v[:, 0], pos, kv)
    ctx = attend_cache(q[:, 0], k_c, v_c, pos, window, kv)
    return decode_out(ctx.to(h.dtype)[:, None], lp.wo, cfg, tp, h.dtype)


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


def _train_layer(x, lp, cfg, is_local: bool, ropes, n_groups: int,
                 tp=None):
    if tp is not None:
        return _layer_tp(x, lp, cfg, is_local, ropes, n_groups, tp)[0]
    return _layer_body(x, lp, cfg, is_local, ropes, n_groups)[0]


# -- the "model" axis (tensor_parallel.py) --------------------------------------

def _kv_for_heads(k, v, heads: range, cfg):
    """The K/V heads (whole on every rank: their count does not divide)
    that the q heads ``heads`` meet at model = 1, by global index (q head i
    meets kv head i // G), and the grouped shape of the local q heads."""
    g = cfg.h_eff // cfg.kv_eff
    n = len(heads)
    if n % g == 0:                           # whole groups
        kv0, nkv = heads.start // g, n // g
        return k.narrow(2, kv0, nkv), v.narrow(2, kv0, nkv), (nkv, g)
    if g % n == 0:                           # a part of one group
        kv0 = heads.start // g
        return k.narrow(2, kv0, 1), v.narrow(2, kv0, 1), (1, n)
    idx = torch.tensor([i // g for i in heads], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx), (n, 1)


def swiglu_tp(h, w_gate, w_up, w_down, d_ff: int, tp):
    """The gated MLP of the normed residual h under the "model" axis: its
    mlp columns sliced, a region; whole weights (d_ff does not divide)
    computed as at model = 1 on the rows the rank holds, their gradients
    summed under 'tp_sp' (``norm_weight``), where those are its rows."""
    if w_gate.shape[-1] == d_ff:
        nw = tp.norm_weight
        return swiglu(h, nw(w_gate), nw(w_up), nw(w_down))
    return tp.leave(swiglu(tp.enter(h), w_gate, w_up, w_down, down=row_mm),
                    h.dtype)


def moe_whole_tp(h, lp, cfg, n_groups: int, tp):
    """The MoE of the normed residual h with whole experts (neither
    "experts" nor "expert_mlp" divides "model"): under 'tp' h is whole and
    the layer runs as at model = 1; under 'tp_sp' the rank's rows are
    gathered, the layer runs on the whole token set, as the reference's
    does whatever the residual's sharding (so the routing groups and the
    capacity drops are the world of one's), and the rank keeps its rows
    of the output by a split that does not sum (every rank computed the
    whole of it). The weights enter through ``rep``: each rank's gradient
    of them is its rows' share, summed over "model"."""
    if not tp.sp:
        return moe_mlp(h, lp.router, lp.we_gate, lp.we_up, lp.we_down, cfg,
                       n_groups)
    hin = tp.enter(h)
    out = moe_mlp(hin, tp.rep(lp.router), tp.rep(lp.we_gate),
                  tp.rep(lp.we_up), tp.rep(lp.we_down), cfg, n_groups)
    rows = tp.seq_rows(hin.shape[1])
    return out.narrow(1, rows.start, len(rows))


def _mlp_tp(h, lp, cfg, n_groups: int, tp):
    """The MLP of the normed residual h under the "model" axis: experts
    (or each expert's d_ff) or the mlp columns sliced, as a region; whole
    weights (d_ff does not divide) computed as at model = 1 on the rows
    the rank holds, whole experts on every row (``moe_whole_tp``)."""
    if cfg.n_experts:
        if tp.sliced("layers/we_gate"):
            hin = tp.enter(h)
            return tp.leave(moe_mlp(hin, tp.rep(lp.router), lp.we_gate,
                                    lp.we_up, lp.we_down, cfg, n_groups,
                                    tp=tp), h.dtype)
        return moe_whole_tp(h, lp, cfg, n_groups, tp)
    return swiglu_tp(h, lp.w_gate, lp.w_up, lp.w_down, cfg.d_ff, tp)


def _layer_tp(x, lp, cfg, is_local: bool, ropes, n_groups: int, tp):
    """``_layer_body`` on the rank's slices: x is (B, S, D) under 'tp', the
    rank's (B, S/m, D) rows under 'tp_sp'. Returns (x', (k, v) of the
    rank's K/V heads)."""
    sin, cos = _rope_of(ropes, is_local)
    h = rms_norm(x, tp.norm_weight(lp.pre_attn_norm), cfg.norm_eps)
    out, kv = _attention_flagged(tp.enter(h), lp, cfg, is_local, sin, cos,
                                 tp)
    x = x + tp.leave(out, x.dtype)
    h = rms_norm(x, tp.norm_weight(lp.pre_mlp_norm), cfg.norm_eps)
    return x + _mlp_tp(h, lp, cfg, n_groups, tp), kv


def _embed_tp(model, tokens, cfg, vision_embeds, tp):
    """The embeddings of the rank's part (``TensorParallel.embed``),
    scaled after the vocab sum, the vision stub written in after it."""
    x = tp.embed(model.embed.table, tokens)
    if _embed_scale(cfg):
        x = x * weak_scalar(math.sqrt(model.embed.table.shape[1]), x.dtype)
    if vision_embeds is None or not cfg.n_vision_tokens:
        return x
    nv, s = vision_embeds.shape[1], tokens.shape[1]
    if s < nv:
        raise ValueError(f"{cfg.name}: a prompt of {s} tokens cannot hold "
                         f"{nv} vision embeddings")
    rows = tp.seq_rows(s) if tp.sp else range(s)
    n = max(min(nv, rows.stop) - rows.start, 0)
    if n == 0:
        return x
    vis = vision_embeds[:, rows.start:rows.start + n].to(x.dtype)
    return torch.cat([vis, x[:, n:]], dim=1)


def dense_forward(model, tokens, cfg, mode: str = "prefill",
                  vision_embeds=None, remat: bool = True,
                  n_groups: int = N_GROUPS, tp=None):
    """Full-sequence forward of ``model`` (a ``DenseLM``, or a parameter
    view of one: ``model_api.param_view``). Returns (hidden (B, S, D), (k,
    v) caches (L, B, S, KV, Dh)), in mode "train" (hidden, None), each
    layer recomputed in backward when ``remat`` (no activation of a layer
    is kept but its input). ``vision_embeds`` (B, n_vision, D), if given,
    replace the first embeddings (qwen2-vl's stubbed vision tower). MoE
    layers cut the tokens into ``n_groups`` groups. ``tp``: the "model"
    axis, ``model`` holding the rank's slices (``model_api.train_forward``,
    ``model_api.serve_forward``); prefill's caches are then of the rank's
    K/V heads (whole where they do not divide), or under the head_dim
    fallback its head_dim columns."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode={mode!r}: need 'prefill' or 'train'")
    b, s = tokens.shape
    if tp is not None:
        x = _embed_tp(model, tokens, cfg, vision_embeds, tp)
        tp = tp.layers
    else:
        x = embed_tokens(model.embed.table, tokens, scale=_embed_scale(cfg))
        if vision_embeds is not None and cfg.n_vision_tokens:
            if s < vision_embeds.shape[1]:
                raise ValueError(f"{cfg.name}: a prompt of {s} tokens cannot "
                                 f"hold {vision_embeds.shape[1]} vision "
                                 "embeddings")
            x[:, :vision_embeds.shape[1]] = vision_embeds.to(x.dtype)
    ropes = _ropes_for(cfg, s, x.device, batch=b)
    ks, vs = [], []
    for lp, is_local in zip(model.layers, _is_local_flags(cfg)):
        if mode == "train" and remat:
            x = checkpoint(_train_layer, x, lp, cfg, is_local, ropes,
                           n_groups, tp, use_reentrant=False,
                           preserve_rng_state=False)
        elif mode == "train":
            x = _train_layer(x, lp, cfg, is_local, ropes, n_groups, tp)
        else:
            x, (k, v) = (_layer_body(x, lp, cfg, is_local, ropes, n_groups)
                         if tp is None else
                         _layer_tp(x, lp, cfg, is_local, ropes, n_groups, tp))
            ks.append(k)
            vs.append(v)
    w = model.final_norm.w if tp is None else tp.norm_weight(
        model.final_norm.w)
    x = rms_norm(x, w, cfg.norm_eps)
    if mode == "train":
        return x, None
    return x, (torch.stack(ks), torch.stack(vs))


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    shape = (cfg.n_layers, batch, max_len, cfg.kv_eff, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def dense_decode_step(model, tokens, cache, pos: int, cfg, tp=None, kv=None,
                      n_groups: int = N_GROUPS):
    """One decode step. tokens (B, 1); cache {"k", "v"} of (L, B, S, KV,
    Dh), written in place at row ``pos`` (a Python int). Returns (hidden
    (B, 1, D), cache).

    ``tp`` (the "model" axis, 'tp'; ``model`` the rank's slices) and ``kv``
    (``tensor_parallel.KVSlice``: the cache is the rank's rows of it, S its
    rows) give the sharded step of the module docstring; either may be None
    (a "model" axis of one; a cache whole on every rank)."""
    x = (embed_tokens(model.embed.table, tokens, scale=_embed_scale(cfg))
         if tp is None else _embed_tp(model, tokens, cfg, None, tp))
    ropes = _ropes_for(cfg, 1, x.device, pos0=pos, batch=x.shape[0])
    for i, (lp, is_local) in enumerate(zip(model.layers,
                                           _is_local_flags(cfg))):
        sin, cos = _rope_of(ropes, is_local)
        h = rms_norm(x, lp.pre_attn_norm, cfg.norm_eps)
        x = x + attention_decode(h, lp, cfg, sin, cos, cache["k"][i],
                                 cache["v"][i], pos,
                                 cfg.window if is_local else 0, tp, kv)
        h2 = rms_norm(x, lp.pre_mlp_norm, cfg.norm_eps)
        x = x + (_mlp(h2, lp, cfg, n_groups) if tp is None
                 else _mlp_tp(h2, lp, cfg, n_groups, tp))
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), cache
