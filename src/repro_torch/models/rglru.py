"""RecurrentGemma (Griffin) — RG-LRU recurrent blocks + local attention
[arXiv:2402.19427]: the port of the JAX package's ``models/rglru.py`` for
serving.

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
"""
from __future__ import annotations

import torch

from ..kernels.decode_attn.ops import decode_attention
from .layers import (ParamSchema, Schema, apply_rope, embed_tokens, gelu, mm,
                     mm_f32, out_proj, rms_norm, rope_cache, swiglu)
from .transformer import _attention_flagged

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


def _rec_block(x, p, cfg, conv_buf, h_prev, decode: bool = False):
    """Griffin recurrent block + MLP over x (B, T, D) from the state
    (conv_buf (B, cw-1, W), h_prev (B, W) float32). Returns (x', conv_buf',
    h')."""
    u = rms_norm(x, p.pre_norm, cfg.norm_eps)
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
    r_gate = torch.sigmoid(mm_f32(conv, p.wa))
    i_gate = torch.sigmoid(mm_f32(conv, p.wx))
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
    x = x + mm(y, p.w_out).to(x.dtype)
    u = rms_norm(x, p.mlp_pre_norm, cfg.norm_eps)
    x = x + swiglu(u, p.mlp_gate, p.mlp_up, p.mlp_down)
    return x, new_conv_buf, h_new


def rglru_init_state(cfg, batch: int, max_len: int, device="cuda",
                     dtype=torch.bfloat16) -> dict:
    """Zero decode state: conv buffers (n, B, cw-1, W) and K/V caches
    (n_macro, B, max_len, KV, Dh) in ``dtype`` (bf16 as the reference's),
    recurrent h (n, B, W) float32."""
    n_macro, n_tail = macro_count(cfg)
    w, cw = cfg.lru_width, cfg.conv1d_width
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


def _mlp_tail(x, pa, cfg):
    u = rms_norm(x, pa.mlp_pre_norm, cfg.norm_eps)
    return x + swiglu(u, pa.mlp_gate, pa.mlp_up, pa.mlp_down)


def rglru_forward(model, tokens, cfg, mode: str = "prefill", state=None):
    """Prefill of ``model`` (an ``RGLRULM``) over tokens (B, T), from
    ``state`` (zero if None). Returns (hidden (B, T, D), the state after
    the prompt: conv buffers and h, and the prompt's K/V (n_macro, B, T,
    KV, Dh))."""
    if mode != "prefill":
        raise ValueError(f"mode={mode!r}: need 'prefill' (training is not "
                         "ported)")
    b, t = tokens.shape
    x = embed_tokens(model.embed.table, tokens, scale=True)
    sin, cos = rope_cache(t, cfg.d_head, cfg.rope_theta, x.device)
    if state is None:
        state = rglru_init_state(cfg, b, t, x.device, x.dtype)
    blocks, tail = _sub_states(state)
    new = rglru_init_state(cfg, b, 0, x.device, x.dtype)
    ks, vs = [], []
    for i, (p0, p1, pa) in enumerate(zip(model.macro.rec0, model.macro.rec1,
                                         model.macro.attn)):
        for r, p in ((0, p0), (1, p1)):
            x, conv, h = _rec_block(x, p, cfg, *blocks[i][r])
            new[f"rec{r}"]["conv"][i] = conv
            new[f"rec{r}"]["h"][i] = h
        hn = rms_norm(x, pa.pre_norm, cfg.norm_eps)
        a_out, (k, v) = _attention_flagged(hn, pa, cfg, True, sin, cos)
        x = _mlp_tail(x + a_out, pa, cfg)
        ks.append(k)
        vs.append(v)
    for i, st in enumerate(tail):
        x, conv, h = _rec_block(x, getattr(model, f"tail{i}"), cfg, *st)
        new["tail"]["conv"][i] = conv
        new["tail"]["h"][i] = h
    new["k"], new["v"] = torch.stack(ks), torch.stack(vs)
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), new


def rglru_decode_step(model, tokens, state, pos: int, cfg):
    """One decode step. tokens (B, 1); ``state`` as ``rglru_init_state``
    gives it, its K/V caches of at least pos + 1 rows, written in place at
    row ``pos`` (a Python int), as are the conv buffers and h. Returns
    (hidden (B, 1, D), state)."""
    x = embed_tokens(model.embed.table, tokens, scale=True)
    sin, cos = rope_cache(1, cfg.d_head, cfg.rope_theta, x.device, pos)
    blocks, tail = _sub_states(state)
    for i, (p0, p1, pa) in enumerate(zip(model.macro.rec0, model.macro.rec1,
                                         model.macro.attn)):
        for (conv_c, h_c), p in zip(blocks[i], (p0, p1)):
            x, conv, h = _rec_block(x, p, cfg, conv_c, h_c, decode=True)
            conv_c.copy_(conv)
            h_c.copy_(h)
        hn = rms_norm(x, pa.pre_norm, cfg.norm_eps)
        q, k, v = mm(hn, pa.wq), mm(hn, pa.wk), mm(hn, pa.wv)
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        k_c, v_c = state["k"][i], state["v"][i]
        k_c[:, pos] = k[:, 0].to(k_c.dtype)
        v_c[:, pos] = v[:, 0].to(v_c.dtype)
        ctx = decode_attention(q[:, 0], k_c, v_c, pos, cfg.window)[:, None]
        x = _mlp_tail(x + out_proj(ctx, pa.wo, cfg).to(x.dtype), pa, cfg)
    for i, (conv_c, h_c) in enumerate(tail):
        x, conv, h = _rec_block(x, getattr(model, f"tail{i}"), cfg, conv_c,
                                h_c, decode=True)
        conv_c.copy_(conv)
        h_c.copy_(h)
    return rms_norm(x, model.final_norm.w, cfg.norm_eps), state
