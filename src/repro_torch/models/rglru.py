"""RecurrentGemma (Griffin) — RG-LRU recurrent blocks + local attention
[arXiv:2402.19427]: the port of the JAX package's ``models/rglru.py``:
prefill, decode and training (mode "train": from the zero state, no K/V
stacked, each macro-block recomputed in backward under ``remat``, the
recurrent tail not, as the reference checkpoints its scan body only).

Block pattern (recurrent, recurrent, local-attn) repeating; 26 layers =
8 full macro-blocks + 2 trailing recurrent layers. The macro-blocks' params
are stacked on a leading axis of 8 (``macro/{rec0,rec1,attn}/*``,
``model.macro.rec0[i]``); the tail has its own (``tail{i}/*``).

RG-LRU: a_t = exp(-8 softplus(Lambda) r_t),
        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t),
over a prefill as a log-depth scan of the associative combine
(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2) in float32 (a closed form through
exp(cumsum(log a)) would underflow), one step in decode. A depthwise causal
conv1d (width 4) precedes it. The attention sub-layer is the dense
family's banded one (``transformer._attention_flagged``, local); its
decode step runs the decode-attention kernel (K5) with ``window =
cfg.window``. Decode states are written in place.

Under a "model" axis (``tp``, ``tensor_parallel.py``) the recurrent block
runs on the rank's LRU columns (the rules' "mlp"), the MLPs on their d_ff
columns and the local attention on its heads, or where 10 heads do not
divide on its head_dim columns (``transformer._attention_flagged``); in a
decode step the K/V cache is the rank's rows (K5's slice form, folded).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..tensor_parallel import row_mm
from .layers import (ParamSchema, Schema, embed_tokens, gelu, mm, mm_f32,
                     rms_norm, rope_cache, swiglu)
from .transformer import (_attention_flagged, _embed_tp, attention_decode,
                          swiglu_tp)

__all__ = ["rglru_schema", "rglru_forward", "rglru_decode_step",
           "rglru_init_state", "rg_lru_scan", "macro_count"]

_C_FACTOR = 8.0


def macro_count(cfg) -> tuple[int, int]:
    """(macro-blocks, trailing recurrent layers) of ``cfg.n_layers``."""
    n_macro = cfg.n_layers // 3
    return n_macro, cfg.n_layers - 3 * n_macro


def _rec_schema(l: int, cfg, prefix: str, stacked: bool = True) -> Schema:
    d, w = cfg.d_model, cfg.lru_width
    cw = cfg.conv1d_width
    sh = (lambda *s: (l, *s)) if stacked else (lambda *s: s)
    ax = (lambda *a: ("layers", *a)) if stacked else (lambda *a: a)
    return {
        f"{prefix}/pre_norm": ParamSchema(sh(d), ax(None), init="zeros"),
        f"{prefix}/w_gate": ParamSchema(sh(d, w), ax("embed", "mlp")),
        f"{prefix}/w_in": ParamSchema(sh(d, w), ax("embed", "mlp")),
        f"{prefix}/conv_w": ParamSchema(sh(cw, w), ax(None, "mlp")),
        f"{prefix}/conv_b": ParamSchema(sh(w), ax("mlp"), init="zeros"),
        f"{prefix}/lambda": ParamSchema(sh(w), ax("mlp"), init="ones"),
        f"{prefix}/wa": ParamSchema(sh(w, w), ax("mlp", None)),
        f"{prefix}/wx": ParamSchema(sh(w, w), ax("mlp", None)),
        f"{prefix}/w_out": ParamSchema(sh(w, d), ax("mlp", "embed")),
        f"{prefix}/mlp_pre_norm": ParamSchema(sh(d), ax(None), init="zeros"),
        f"{prefix}/mlp_gate": ParamSchema(sh(d, cfg.d_ff), ax("embed", "mlp")),
        f"{prefix}/mlp_up": ParamSchema(sh(d, cfg.d_ff), ax("embed", "mlp")),
        f"{prefix}/mlp_down": ParamSchema(sh(cfg.d_ff, d), ax("mlp", "embed")),
    }


def rglru_schema(cfg) -> Schema:
    n_macro, n_tail = macro_count(cfg)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    vp = cfg.vocab_padded
    s: Schema = {
        "embed/table": ParamSchema((vp, d), ("vocab", "embed")),
        "final_norm/w": ParamSchema((d,), (None,), init="zeros"),
    }
    # two recurrent sub-layers per macro-block (stacked n_macro)
    for sub in ("rec0", "rec1"):
        s.update(_rec_schema(n_macro, cfg, f"macro/{sub}"))
    # one local-attention sub-layer per macro-block
    s.update({
        "macro/attn/pre_norm": ParamSchema((n_macro, d), ("layers", None), init="zeros"),
        "macro/attn/wq": ParamSchema((n_macro, d, h, dh), ("layers", "embed", "heads", "head_dim")),
        "macro/attn/wk": ParamSchema((n_macro, d, kv, dh), ("layers", "embed", "kv_heads", "head_dim")),
        "macro/attn/wv": ParamSchema((n_macro, d, kv, dh), ("layers", "embed", "kv_heads", "head_dim")),
        "macro/attn/wo": ParamSchema((n_macro, h, dh, d), ("layers", "heads", "head_dim", "embed")),
        "macro/attn/mlp_pre_norm": ParamSchema((n_macro, d), ("layers", None), init="zeros"),
        "macro/attn/mlp_gate": ParamSchema((n_macro, d, cfg.d_ff), ("layers", "embed", "mlp")),
        "macro/attn/mlp_up": ParamSchema((n_macro, d, cfg.d_ff), ("layers", "embed", "mlp")),
        "macro/attn/mlp_down": ParamSchema((n_macro, cfg.d_ff, d), ("layers", "mlp", "embed")),
    })
    for i in range(n_tail):
        s.update(_rec_schema(0, cfg, f"tail{i}", stacked=False))
    return s


def rg_lru_scan(x, a_log, gate_in):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * x_t) from h_0 = 0, as a
    log-depth (Hillis-Steele) scan of the associative combine over the time
    axis, float32. x, a_log (= log a_t), gate_in: (B, T, W). Returns (h,
    last_h)."""
    a = torch.exp(a_log)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gate_in * x
    d, t = 1, x.shape[1]
    while d < t:
        # element i takes the prefix ending at i - d: (a', b') after (a, b)
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def _rec_block(x, p, cfg, conv_buf, h_prev, decode: bool = False, tp=None):
    """Griffin recurrent block + MLP over x (B, T, D) from the state
    (conv_buf (B, cw-1, W), h_prev (B, W) float32). Returns (x', conv_buf',
    h').

    Under ``tp`` (``p`` the rank's slices: the rules put "mlp" on the LRU
    width) the block is a region on the rank's W/m columns: w_gate / w_in
    column products, the depthwise conv, lambda and the scan on its
    columns, the gates' wa / wx row products summed over "model" with the
    rank keeping its columns (``TensorParallel.scatter_cols``), w_out's
    row product the partial sum; the state is the rank's columns. The MLP
    is the dense family's under "model" (``transformer.swiglu_tp``)."""
    u = rms_norm(x, p.pre_norm if tp is None else tp.norm_weight(p.pre_norm),
                 cfg.norm_eps)
    if tp is not None:
        u = tp.enter(u)
    gate = gelu(mm_f32(u, p.w_gate))
    xin = mm(u, p.w_in)

    # depthwise causal conv1d (width cw)
    cw, t = p.conv_w.shape[0], xin.shape[1]
    seq = torch.cat([conv_buf.to(xin.dtype), xin], dim=1)
    conv = sum(seq[:, i:i + t] * p.conv_w[i] for i in range(cw))
    conv = conv + p.conv_b
    new_conv_buf = seq[:, -(cw - 1):] if cw > 1 else conv_buf

    # RG-LRU gates
    conv_f = conv.float()
    ra, rx = mm_f32(conv, p.wa), mm_f32(conv, p.wx)
    if tp is not None:
        ra, rx = tp.scatter_cols(ra), tp.scatter_cols(rx)
    r_gate, i_gate = torch.sigmoid(ra), torch.sigmoid(rx)
    log_a_base = -_C_FACTOR * torch.nn.functional.softplus(
        getattr(p, "lambda").float())
    a_log = log_a_base * r_gate

    if decode:
        a = torch.exp(a_log[:, 0])
        h_new = a * h_prev + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * \
            (i_gate[:, 0] * conv_f[:, 0])
        h_seq = h_new[:, None]
    else:
        h_seq, _ = rg_lru_scan(conv_f, a_log, i_gate)
        # fold in the carried state: h_t += (prod_{s<=t} a_s) * h_prev
        h_seq = h_seq + torch.exp(torch.cumsum(a_log, dim=1)) * h_prev[:, None]
        h_new = h_seq[:, -1]

    y = (gate * h_seq).to(x.dtype)
    if tp is None:
        x = x + mm(y, p.w_out).to(x.dtype)
        u = rms_norm(x, p.mlp_pre_norm, cfg.norm_eps)
        x = x + swiglu(u, p.mlp_gate, p.mlp_up, p.mlp_down)
        return x, new_conv_buf, h_new
    x = x + tp.leave(row_mm(y, p.w_out), x.dtype)
    return _mlp_tail(x, p, cfg, tp), new_conv_buf, h_new


def rglru_init_state(cfg, batch: int, max_len: int, device="cuda",
                     dtype=torch.bfloat16, width: int | None = None) -> dict:
    """Zero decode state: conv buffers (n, B, cw-1, W) and K/V caches
    (n_macro, B, max_len, KV, Dh) in ``dtype`` (bf16 as the reference's),
    recurrent h (n, B, W) float32; ``width``: W (a rank's LRU columns)."""
    n_macro, n_tail = macro_count(cfg)
    w, cw = width or cfg.lru_width, cfg.conv1d_width
    rec = lambda n: {
        "conv": torch.zeros((n, batch, cw - 1, w), dtype=dtype, device=device),
        "h": torch.zeros((n, batch, w), dtype=torch.float32, device=device),
    }
    kv_shape = (n_macro, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"rec0": rec(n_macro), "rec1": rec(n_macro),
            "k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "v": torch.zeros(kv_shape, dtype=dtype, device=device),
            "tail": rec(n_tail)}


def _sub_states(state):
    """The (conv, h) of every recurrent sub-layer in model order: per
    macro-block rec0 and rec1, then the tail."""
    n_macro = state["rec0"]["h"].shape[0]
    blocks = [[(state[r]["conv"][i], state[r]["h"][i])
               for r in ("rec0", "rec1")] for i in range(n_macro)]
    tail = [(state["tail"]["conv"][i], state["tail"]["h"][i])
            for i in range(state["tail"]["h"].shape[0])]
    return blocks, tail


def _mlp_tail(x, pa, cfg, tp=None):
    if tp is None:
        u = rms_norm(x, pa.mlp_pre_norm, cfg.norm_eps)
        return x + swiglu(u, pa.mlp_gate, pa.mlp_up, pa.mlp_down)
    u = rms_norm(x, tp.norm_weight(pa.mlp_pre_norm), cfg.norm_eps)
    return x + swiglu_tp(u, pa.mlp_gate, pa.mlp_up, pa.mlp_down, cfg.d_ff,
                         tp)


def _attn_block(x, pa, cfg, sin, cos, tp=None):
    """The local-attention sub-layer and its MLP: (x', (k, v)); under
    ``tp`` a region of the rank's heads (or head_dim columns)."""
    if tp is None:
        hn = rms_norm(x, pa.pre_norm, cfg.norm_eps)
        a_out, kv = _attention_flagged(hn, pa, cfg, True, sin, cos)
        return _mlp_tail(x + a_out, pa, cfg), kv
    hn = rms_norm(x, tp.norm_weight(pa.pre_norm), cfg.norm_eps)
    a_out, kv = _attention_flagged(tp.enter(hn), pa, cfg, True, sin, cos, tp)
    return _mlp_tail(x + tp.leave(a_out, x.dtype), pa, cfg, tp), kv


def _train_macro(x, p0, p1, pa, cfg, sin, cos, conv0, h0, tp=None):
    """A macro-block of the training forward from the zero state ``conv0``,
    ``h0``: x' alone."""
    x, _, _ = _rec_block(x, p0, cfg, conv0, h0, tp=tp)
    x, _, _ = _rec_block(x, p1, cfg, conv0, h0, tp=tp)
    return _attn_block(x, pa, cfg, sin, cos, tp)[0]


def _zero_rec(model, x, cfg):
    """The zero (conv, h) of a recurrent sub-layer of ``model``'s width
    (the rank's LRU columns under "model")."""
    b, w = x.shape[0], model.macro.rec0[0].w_in.shape[-1]
    conv0 = torch.zeros((b, cfg.conv1d_width - 1, w), dtype=x.dtype,
                        device=x.device)
    return conv0, torch.zeros((b, w), dtype=torch.float32, device=x.device)


def _train_forward(model, x, cfg, sin, cos, remat: bool, tp=None):
    n_macro, n_tail = macro_count(cfg)
    conv0, h0 = _zero_rec(model, x, cfg)
    for p0, p1, pa in zip(model.macro.rec0, model.macro.rec1,
                          model.macro.attn):
        args = (x, p0, p1, pa, cfg, sin, cos, conv0, h0, tp)
        x = (checkpoint(_train_macro, *args, use_reentrant=False,
                        preserve_rng_state=False) if remat
             else _train_macro(*args))
    for i in range(n_tail):
        x, _, _ = _rec_block(x, getattr(model, f"tail{i}"), cfg, conv0, h0,
                             tp=tp)
    w = model.final_norm.w if tp is None else tp.norm_weight(
        model.final_norm.w)
    return rms_norm(x, w, cfg.norm_eps)


def _embed(model, tokens, cfg, tp):
    """The embeddings scaled by sqrt(D): under ``tp`` the dense family's
    vocab-parallel lookup (``transformer._embed_tp``)."""
    if tp is None:
        return embed_tokens(model.embed.table, tokens, scale=True)
    return _embed_tp(model, tokens, cfg, None, tp)


def rglru_forward(model, tokens, cfg, mode: str = "prefill", state=None,
                  remat: bool = True, tp=None):
    """Prefill of ``model`` (an ``RGLRULM``, or a parameter view of one:
    ``model_api.param_view``) over tokens (B, T), from ``state`` (zero if
    None). Returns (hidden (B, T, D), the state after the prompt: conv
    buffers and h, and the prompt's K/V (n_macro, B, T, KV, Dh)); in mode
    "train" (hidden, None) from the zero state. ``tp``: the "model" axis,
    ``model`` the rank's slices; the state is then of the rank's LRU
    columns and its K/V whole (the one K/V head) or, under the head_dim
    fallback, the rank's head_dim columns."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"mode={mode!r}: need 'prefill' or 'train'")
    b, t = tokens.shape
    x = _embed(model, tokens, cfg, tp)
    if tp is not None:
        tp = tp.layers
    sin, cos = rope_cache(t, cfg.d_head, cfg.rope_theta, x.device)
    if mode == "train":
        return _train_forward(model, x, cfg, sin, cos, remat, tp), None
    w = model.macro.rec0[0].w_in.shape[-1]
    if state is None:
        state = rglru_init_state(cfg, b, t, x.device, x.dtype, w)
    blocks, tail = _sub_states(state)
    new = rglru_init_state(cfg, b, 0, x.device, x.dtype, w)
    ks, vs = [], []
    for i, (p0, p1, pa) in enumerate(zip(model.macro.rec0, model.macro.rec1,
                                         model.macro.attn)):
        for r, p in ((0, p0), (1, p1)):
            x, conv, h = _rec_block(x, p, cfg, *blocks[i][r], tp=tp)
            new[f"rec{r}"]["conv"][i] = conv
            new[f"rec{r}"]["h"][i] = h
        x, (k, v) = _attn_block(x, pa, cfg, sin, cos, tp)
        ks.append(k)
        vs.append(v)
    for i, st in enumerate(tail):
        x, conv, h = _rec_block(x, getattr(model, f"tail{i}"), cfg, *st,
                                tp=tp)
        new["tail"]["conv"][i] = conv
        new["tail"]["h"][i] = h
    new["k"], new["v"] = torch.stack(ks), torch.stack(vs)
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), new


def rglru_decode_step(model, tokens, state, pos: int, cfg, tp=None, kv=None):
    """One decode step. tokens (B, 1); ``state`` as ``rglru_init_state``
    gives it, its K/V caches of at least pos + 1 rows, written in place at
    row ``pos`` (a Python int), as are the conv buffers and h. Returns
    (hidden (B, 1, D), state). ``tp`` ('tp') and ``kv`` (a ``KVSlice``) as
    in ``transformer.dense_decode_step``: the recurrent states are the
    rank's LRU columns, the K/V caches the rank's rows."""
    x = _embed(model, tokens, cfg, tp)
    sin, cos = rope_cache(1, cfg.d_head, cfg.rope_theta, x.device, pos)
    blocks, tail = _sub_states(state)
    for i, (p0, p1, pa) in enumerate(zip(model.macro.rec0, model.macro.rec1,
                                         model.macro.attn)):
        for (conv_c, h_c), p in zip(blocks[i], (p0, p1)):
            x, conv, h = _rec_block(x, p, cfg, conv_c, h_c, decode=True,
                                    tp=tp)
            conv_c.copy_(conv)
            h_c.copy_(h)
        hn = rms_norm(x, pa.pre_norm, cfg.norm_eps)
        x = x + attention_decode(hn, pa, cfg, sin, cos, state["k"][i],
                                 state["v"][i], pos, cfg.window, tp, kv)
        x = _mlp_tail(x, pa, cfg, tp)
    for i, (conv_c, h_c) in enumerate(tail):
        x, conv, h = _rec_block(x, getattr(model, f"tail{i}"), cfg, conv_c,
                                h_c, decode=True, tp=tp)
        conv_c.copy_(conv)
        h_c.copy_(h)
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), state
