"""RWKV-6 "Finch" — attention-free LM with data-dependent decay
[arXiv:2404.05892]: the port of the JAX package's ``models/rwkv6.py``.

Per layer: time-mix (the WKV recurrence with per-channel, per-token decay
w_t = exp(-exp(ww_t)), LoRA-produced from the token stream) and channel-mix
(squared-ReLU FFN). The recurrence over more than two steps (prefill,
training) goes through ``WKV6Function``: the WKV6 kernel (``kernels/wkv6``,
the TPU kernel K6's counterpart) on the card, where the reference calls its
jnp ``wkv_chunked`` (the same function); one or two steps (decode) take the
plain step-by-step ``wkv_scan_ref``, as the reference does. The per-step log-decay is clamped
to >= -2 (``_LOGW_MIN``), which the chunked form needs.

Training (mode "train") runs the same layers from a zero state, each layer
recomputed in backward under ``remat`` (the reference's ``jax.checkpoint``
of its scan body), here as two regions, its time mix and its channel mix:
the same values, and a layer's backward holds the activations of one half
at a time (at rwkv6-3b's 2 x 4096 tokens a half saves 2.4-2.7 GB).
``WKV6Function``'s backward is the WKV6 backward kernel on the card (the
reference lets ``jax.grad`` differentiate its jnp ``wkv_chunked``).

Under a "model" axis (``tp``, ``tensor_parallel.py``) a rank runs its
H/m heads (K6 and its backward on (B, T, H/m, Dh)) and its d_ff/m columns
of the channel mix; the decay is computed for the rank's channels only.
Where the heads do not divide (rwkv6-3b's 40 on 16) the rules slice the
head_dim: a rank runs every head on its Dh/m value columns (K6's
value-column form, v (B, T, H, Dh/m) against whole r, k, logw and u).
Serving under it ('tp', no autograd) runs the same regions: prefill with
K6 at H/m and a decode step on the rank's heads (or value columns), the
state's ``wkv`` of those and its shift states whole
(``launch/steps.py::ServeStep`` places the decode rules' slices).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.wkv6.ops import WKV6Function
from ..kernels.wkv6.ref import wkv_chunked, wkv_scan_ref
from ..tensor_parallel import all_reduce, row_mm
from .layers import ParamSchema, Schema, embed_tokens, mm, mm_f32, rms_norm

__all__ = ["rwkv6_schema", "rwkv6_forward", "rwkv6_decode_step",
           "rwkv6_init_state", "wkv_chunked", "wkv_scan_ref"]

_LORA_MIX = 32
_LORA_W = 64
_LOGW_MIN = -2.0  # per-step log-decay clamp (fp32 safety of the rebased basis)


def rwkv6_schema(cfg) -> Schema:
    l, d, f, vp = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_padded
    h, dh = cfg.n_heads, cfg.d_head
    la = ("layers", None)
    return {
        "embed/table": ParamSchema((vp, d), ("vocab", "embed")),
        "final_norm/w": ParamSchema((d,), (None,), init="zeros"),
        "lm_head/table": ParamSchema((vp, d), ("vocab", "embed")),
        # time-mix
        "layers/ln1": ParamSchema((l, d), la, init="zeros"),
        "layers/mu_x": ParamSchema((l, d), la),
        "layers/mu_rkvwg": ParamSchema((l, 5, d), ("layers", None, None)),
        "layers/mix_w1": ParamSchema((l, d, 5 * _LORA_MIX), ("layers", "embed", None)),
        "layers/mix_w2": ParamSchema((l, 5, _LORA_MIX, d), ("layers", None, None, "embed")),
        "layers/w0": ParamSchema((l, d), la, init="zeros"),
        "layers/w_lora1": ParamSchema((l, d, _LORA_W), ("layers", "embed", None)),
        "layers/w_lora2": ParamSchema((l, _LORA_W, d), ("layers", None, "embed")),
        "layers/u": ParamSchema((l, h, dh), ("layers", "heads", "head_dim")),
        "layers/wr": ParamSchema((l, d, h, dh), ("layers", "embed", "heads", "head_dim")),
        "layers/wk": ParamSchema((l, d, h, dh), ("layers", "embed", "heads", "head_dim")),
        "layers/wv": ParamSchema((l, d, h, dh), ("layers", "embed", "heads", "head_dim")),
        "layers/wg": ParamSchema((l, d, h, dh), ("layers", "embed", "heads", "head_dim")),
        "layers/wo": ParamSchema((l, h, dh, d), ("layers", "heads", "head_dim", "embed"),
                                 std=0.02 / math.sqrt(2 * l)),
        "layers/ln_x": ParamSchema((l, h, dh), ("layers", "heads", "head_dim"), init="zeros"),
        # channel-mix
        "layers/ln2": ParamSchema((l, d), la, init="zeros"),
        "layers/cmix_mu_k": ParamSchema((l, d), la),
        "layers/cmix_mu_r": ParamSchema((l, d), la),
        "layers/cmix_wk": ParamSchema((l, d, f), ("layers", "embed", "mlp")),
        "layers/cmix_wv": ParamSchema((l, f, d), ("layers", "mlp", "embed"),
                                      std=0.02 / math.sqrt(2 * l)),
        "layers/cmix_wr": ParamSchema((l, d, d), ("layers", "embed", None)),
    }


def _token_shift(x, last):
    """x_{t-1} stream: (B, T, D) with carry-in ``last`` (B, 1, D)."""
    return torch.cat([last, x[:, :-1]], dim=1)


def _head_norm(y, scale, eps, tp=None):
    """Per-head RMS norm of (B, T, H, Dh) (RWKV GroupNorm analogue); under
    ``tp`` y is the rank's value columns of each head, whose moment sums
    over "model" (``tensor_parallel.all_reduce``)."""
    yf = y.float()
    if tp is None:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        var = all_reduce((yf * yf).sum(-1, keepdim=True), tp.mesh) / (
            yf.shape[-1] * tp.size)
    return yf * torch.rsqrt(var + eps) * (1.0 + scale.float())


def _time_mix(x, lp, cfg, shift_last, wkv_state, tp=None):
    """The time mix of x (B, T, D). Under ``tp`` (x the region's input,
    ``lp`` the rank's slices) on this rank's heads: r/k/v/g column
    products, the decay of the rank's channels only, K6 on (B, T, H/m,
    Dh), u and ln_x the rank's heads, and the output wo's partial sum in
    float32. Under the head_dim fallback (the heads do not divide) the
    column products give the rank's head_dim columns: r, k and u are
    gathered whole over "model", the decay is every channel's, and K6 runs
    on the rank's value columns of v (the state (B, H, Dh, Dh/m)): the
    recurrence is exact per value column; ln_x's moment sums over "model".
    The token-shift mix and the decay LoRAs are whole leaves feeding every
    head: they enter through ``tp.rep``, so their gradients are summed
    over "model" and whole."""
    b, t, d = x.shape
    dh = cfg.d_head
    rep, cols = (lambda w: w), slice(None)
    h = lp.wr.shape[-2]
    hd = tp is not None and tp.head_dim_sliced(dh, lp.wr.shape[-1])
    if tp is not None:
        rep = tp.rep
        if not hd:
            heads = tp.local_heads(cfg.n_heads, h)
            cols = slice(heads.start * dh, heads.stop * dh)
    xx = _token_shift(x, shift_last) - x
    xxx = x + xx * rep(lp.mu_x)
    # LoRA projections in float32
    s5 = torch.tanh(mm_f32(xxx, rep(lp.mix_w1))).reshape(b, t, 5, _LORA_MIX)
    mu_dyn = torch.einsum("btfr,frd->btfd", s5, rep(lp.mix_w2).float())
    mu = rep(lp.mu_rkvwg).float()[None, None] + mu_dyn          # (B, T, 5, D)
    xr, xk, xv, xw, xg = (x + xx * mu[:, :, i].to(x.dtype) for i in range(5))

    r, k, v = mm(xr, lp.wr), mm(xk, lp.wk), mm(xv, lp.wv)
    g = torch.nn.functional.silu(mm(xg, lp.wg).float())
    u = lp.u
    if hd:
        r, k, u = (tp.gather_head_dim(a) for a in (r, k, u))

    # Finch data-dependent decay, clamped for the chunked float32 basis
    ww = rep(lp.w0)[cols].float() + mm_f32(mm_f32(xw, rep(lp.w_lora1)),
                                           rep(lp.w_lora2)[:, cols])
    logw = -torch.exp(torch.clamp(ww, max=math.log(-_LOGW_MIN)))
    logw = logw.reshape(b, t, h, dh)

    if t <= 2:                                   # decode: step by step
        y, wkv_new = wkv_scan_ref(r, k, v, logw, u, wkv_state)
    else:
        y, wkv_new = WKV6Function.apply(r, k, v, logw, u, wkv_state)
    y = _head_norm(y, lp.ln_x, cfg.norm_eps, tp if hd else None) * g
    if tp is not None:
        return row_mm(y.to(x.dtype).flatten(-2), lp.wo.flatten(0, 1)), \
            x[:, -1:], wkv_new
    out = mm(y.to(x.dtype).flatten(-2), lp.wo.flatten(0, 1))
    return out.to(x.dtype), x[:, -1:], wkv_new


def _channel_mix(x, lp, shift_last, tp=None):
    """The channel mix of x; under ``tp`` on the rank's d_ff columns
    (cmix_wk column-, cmix_wv row-parallel, cmix_wr and the mix weights
    whole through ``tp.rep``), the partial sum of rr * vv in float32."""
    rep = (lambda w: w) if tp is None else tp.rep
    xx = _token_shift(x, shift_last) - x
    xk = x + xx * rep(lp.cmix_mu_k)
    xr = x + xx * rep(lp.cmix_mu_r)
    kk = mm(xk, lp.cmix_wk)
    kk = torch.square(torch.relu(kk.float())).to(x.dtype)
    rr = torch.sigmoid(mm_f32(xr, rep(lp.cmix_wr)))
    if tp is not None:
        return rr.to(x.dtype).float() * row_mm(kk, lp.cmix_wv), x[:, -1:]
    return rr.to(x.dtype) * mm(kk, lp.cmix_wv), x[:, -1:]


def _layer(x, lp, cfg, state, tp=None):
    """One layer from ``state`` (shift_t, wkv, shift_c); under ``tp`` its
    two halves are regions of the rank's heads and d_ff columns, wkv the
    rank's heads."""
    shift_t, wkv, shift_c = state
    if tp is None:
        h, s_t_new, wkv_new = _time_mix(rms_norm(x, lp.ln1, cfg.norm_eps),
                                        lp, cfg, shift_t, wkv)
        x = x + h
        h, s_c_new = _channel_mix(rms_norm(x, lp.ln2, cfg.norm_eps), lp,
                                  shift_c)
        return x + h, (s_t_new, wkv_new, s_c_new)
    h, s_t_new, wkv_new = _time_mix(
        tp.enter(rms_norm(x, lp.ln1, cfg.norm_eps)), lp, cfg, shift_t, wkv,
        tp)
    x = x + tp.leave(h, x.dtype)
    h, s_c_new = _channel_mix(tp.enter(rms_norm(x, lp.ln2, cfg.norm_eps)),
                              lp, shift_c, tp)
    return x + tp.leave(h, x.dtype), (s_t_new, wkv_new, s_c_new)


def rwkv6_init_state(cfg, batch: int, device="cuda", dtype=torch.bfloat16):
    """Zero state; the token-shift carries are in the activations' dtype
    (bf16 as in the reference; float32 for a float32 model)."""
    l, d, h, dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head
    return {
        "shift_t": torch.zeros((l, batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((l, batch, h, dh, dh), dtype=torch.float32, device=device),
        "shift_c": torch.zeros((l, batch, 1, d), dtype=dtype, device=device),
    }


def _zero_shift(x):
    return torch.zeros((x.shape[0], 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)


def _train_time(x, lp, cfg, tp=None):
    """The time-mix half of a training layer from the zero state; under
    ``tp`` the region of the rank's heads."""
    if tp is None:
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        return x + _time_mix(h, lp, cfg, _zero_shift(h), None)[0]
    h = tp.enter(rms_norm(x, tp.norm_weight(lp.ln1), cfg.norm_eps))
    return x + tp.leave(_time_mix(h, lp, cfg, _zero_shift(h), None, tp)[0],
                        x.dtype)


def _train_channel(x, lp, cfg, tp=None):
    """The channel-mix half of a training layer from the zero state; under
    ``tp`` the region of the rank's d_ff columns."""
    if tp is None:
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        return x + _channel_mix(h, lp, _zero_shift(h))[0]
    h = tp.enter(rms_norm(x, tp.norm_weight(lp.ln2), cfg.norm_eps))
    return x + tp.leave(_channel_mix(h, lp, _zero_shift(h), tp)[0], x.dtype)


def rwkv6_forward(model, tokens, cfg, mode: str = "prefill", state=None,
                  remat: bool = True, tp=None):
    """Full-sequence forward of ``model`` (an ``RWKV6LM``, or a parameter
    view of one: ``model_api.param_view``). Returns (hidden (B, T, D), the
    new state); in mode "train" (hidden, None) from the zero state, each
    layer's two halves recomputed in backward when ``remat``. ``tp``: the
    "model" axis, ``model`` holding the rank's slices
    (``model_api.train_forward``, ``model_api.serve_forward``); a state's
    ``wkv`` is then of the rank's heads."""
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode={mode!r}: need 'prefill', 'decode' or "
                         "'train'")
    b, _ = tokens.shape
    if tp is not None:
        x = tp.embed(model.embed.table, tokens)
        tp = tp.layers
    else:
        x = embed_tokens(model.embed.table, tokens)
    if mode == "train":
        for lp in model.layers:
            for half in (_train_time, _train_channel):
                x = (checkpoint(half, x, lp, cfg, tp, use_reentrant=False,
                                preserve_rng_state=False) if remat
                     else half(x, lp, cfg, tp))
        w = model.final_norm.w if tp is None else tp.norm_weight(
            model.final_norm.w)
        return rms_norm(x, w, cfg.norm_eps), None
    if state is None:
        state = rwkv6_init_state(cfg, b, x.device, x.dtype)
        if tp is not None:          # the rank's heads or value columns
            wkv, wr = state["wkv"], model.layers[0].wr
            state["wkv"] = wkv.new_zeros(wkv.shape[:2] + (wr.shape[-2],
                                                          cfg.d_head,
                                                          wr.shape[-1]))
    new = ([], [], [])
    for i, lp in enumerate(model.layers):
        x, layer_state = _layer(x, lp, cfg, (state["shift_t"][i],
                                             state["wkv"][i],
                                             state["shift_c"][i]), tp)
        for acc, s in zip(new, layer_state):
            acc.append(s)
    x = rms_norm(x, model.final_norm.w, cfg.norm_eps)
    return x, {"shift_t": torch.stack(new[0]), "wkv": torch.stack(new[1]),
               "shift_c": torch.stack(new[2])}


def rwkv6_decode_step(model, tokens, state, pos: int, cfg, tp=None):
    """One-token step; the recurrence makes this O(1) in context length."""
    del pos
    return rwkv6_forward(model, tokens, cfg, mode="decode", state=state,
                         tp=tp)
