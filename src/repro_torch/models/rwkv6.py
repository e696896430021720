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
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.wkv6.ops import WKV6Function
from ..kernels.wkv6.ref import wkv_chunked, wkv_scan_ref
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


def _head_norm(y, scale, eps):
    """Per-head RMS norm of (B, T, H, Dh) (RWKV GroupNorm analogue)."""
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return yf * torch.rsqrt(var + eps) * (1.0 + scale.float())


def _time_mix(x, lp, cfg, shift_last, wkv_state):
    b, t, d = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    xx = _token_shift(x, shift_last) - x
    xxx = x + xx * lp.mu_x
    # LoRA projections in float32
    s5 = torch.tanh(mm_f32(xxx, lp.mix_w1)).reshape(b, t, 5, _LORA_MIX)
    mu_dyn = torch.einsum("btfr,frd->btfd", s5, lp.mix_w2.float())
    mu = lp.mu_rkvwg.float()[None, None] + mu_dyn               # (B, T, 5, D)
    xr, xk, xv, xw, xg = (x + xx * mu[:, :, i].to(x.dtype) for i in range(5))

    r, k, v = mm(xr, lp.wr), mm(xk, lp.wk), mm(xv, lp.wv)
    g = torch.nn.functional.silu(mm(xg, lp.wg).float())

    # Finch data-dependent decay, clamped for the chunked float32 basis
    ww = lp.w0.float() + mm_f32(mm_f32(xw, lp.w_lora1), lp.w_lora2)
    logw = -torch.exp(torch.clamp(ww, max=math.log(-_LOGW_MIN)))
    logw = logw.reshape(b, t, h, dh)

    if t <= 2:                                   # decode: step by step
        y, wkv_new = wkv_scan_ref(r, k, v, logw, lp.u, wkv_state)
    else:
        y, wkv_new = WKV6Function.apply(r, k, v, logw, lp.u, wkv_state)
    y = _head_norm(y, lp.ln_x, cfg.norm_eps) * g
    out = mm(y.to(x.dtype).flatten(-2), lp.wo.flatten(0, 1))
    return out.to(x.dtype), x[:, -1:], wkv_new


def _channel_mix(x, lp, shift_last):
    xx = _token_shift(x, shift_last) - x
    xk = x + xx * lp.cmix_mu_k
    xr = x + xx * lp.cmix_mu_r
    kk = mm(xk, lp.cmix_wk)
    kk = torch.square(torch.relu(kk.float())).to(x.dtype)
    vv = mm(kk, lp.cmix_wv)
    rr = torch.sigmoid(mm_f32(xr, lp.cmix_wr))
    return rr.to(x.dtype) * vv, x[:, -1:]


def _layer(x, lp, cfg, state):
    shift_t, wkv, shift_c = state
    h, s_t_new, wkv_new = _time_mix(rms_norm(x, lp.ln1, cfg.norm_eps), lp,
                                    cfg, shift_t, wkv)
    x = x + h
    h, s_c_new = _channel_mix(rms_norm(x, lp.ln2, cfg.norm_eps), lp, shift_c)
    x = x + h
    return x, (s_t_new, wkv_new, s_c_new)


def rwkv6_init_state(cfg, batch: int, device="cuda", dtype=torch.bfloat16):
    """Zero state; the token-shift carries are in the activations' dtype
    (bf16 as in the reference; float32 for a float32 model)."""
    l, d, h, dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head
    return {
        "shift_t": torch.zeros((l, batch, 1, d), dtype=dtype, device=device),
        "wkv": torch.zeros((l, batch, h, dh, dh), dtype=torch.float32, device=device),
        "shift_c": torch.zeros((l, batch, 1, d), dtype=dtype, device=device),
    }


def _train_time(x, lp, cfg, zero):
    """The time-mix half of a training layer from the zero state."""
    h, _, _ = _time_mix(rms_norm(x, lp.ln1, cfg.norm_eps), lp, cfg, zero,
                        None)
    return x + h


def _train_channel(x, lp, cfg, zero):
    """The channel-mix half of a training layer from the zero state."""
    h, _ = _channel_mix(rms_norm(x, lp.ln2, cfg.norm_eps), lp, zero)
    return x + h


def rwkv6_forward(model, tokens, cfg, mode: str = "prefill", state=None,
                  remat: bool = True):
    """Full-sequence forward of ``model`` (an ``RWKV6LM``, or a parameter
    view of one: ``model_api.param_view``). Returns (hidden (B, T, D), the
    new state); in mode "train" (hidden, None) from the zero state, each
    layer's two halves recomputed in backward when ``remat``."""
    if mode not in ("prefill", "decode", "train"):
        raise ValueError(f"mode={mode!r}: need 'prefill', 'decode' or "
                         "'train'")
    b, _ = tokens.shape
    x = embed_tokens(model.embed.table, tokens)
    if mode == "train":
        zero = torch.zeros((b, 1, cfg.d_model), dtype=x.dtype, device=x.device)
        for lp in model.layers:
            for half in (_train_time, _train_channel):
                x = (checkpoint(half, x, lp, cfg, zero, use_reentrant=False,
                                preserve_rng_state=False) if remat
                     else half(x, lp, cfg, zero))
        return rms_norm(x, model.final_norm.w, cfg.norm_eps), None
    if state is None:
        state = rwkv6_init_state(cfg, b, x.device, x.dtype)
    new = ([], [], [])
    for i, lp in enumerate(model.layers):
        x, layer_state = _layer(x, lp, cfg, (state["shift_t"][i],
                                             state["wkv"][i],
                                             state["shift_c"][i]))
        for acc, s in zip(new, layer_state):
            acc.append(s)
    x = rms_norm(x, model.final_norm.w, cfg.norm_eps)
    return x, {"shift_t": torch.stack(new[0]), "wkv": torch.stack(new[1]),
               "shift_c": torch.stack(new[2])}


def rwkv6_decode_step(model, tokens, state, pos: int, cfg):
    """One-token step; the recurrence makes this O(1) in context length."""
    del pos
    return rwkv6_forward(model, tokens, cfg, mode="decode", state=state)
