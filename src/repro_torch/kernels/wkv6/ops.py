"""Dispatch for the WKV6 recurrence: the device of the tensors decides.

A CUDA tensor goes to the hand-written kernel (``wkv6.py``) and either
launches or raises; a CPU tensor goes to the plain chunked version
(``ref.py::wkv_chunked``); a meta tensor (the dry run) to the kernel's meta
form (``kernels/meta.py``). There is no switch and no fallback: any other
device raises.

Unlike the reference's ``ops.wkv6``, which starts from a zero state and
returns y alone, this takes the model's initial state and returns the final
one beside y (what ``models/rwkv6.py`` needs to hand prefill on to decode);
and it pads nothing on the card (the kernel masks the ragged last chunk).

``WKV6Function`` is the recurrence with its gradient, for training: on the
card its forward launches the forward kernel and its backward the backward
kernel (``wkv6_bwd_cuda``); on the CPU they are the plain ``wkv_chunked``
and ``wkv6_bwd_ref``; on meta the meta forms. It saves only its inputs, so under
``torch.utils.checkpoint`` the forward runs again in backward (a second
launch) and nothing else changes.
"""
from __future__ import annotations

import torch

from .. import meta
from .ref import wkv6_bwd_ref, wkv_chunked
from .wkv6 import wkv6_bwd_cuda, wkv6_cuda

__all__ = ["wkv6", "WKV6Function"]


def _route(r):
    kind = r.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"WKV6 on {r.device}: the kernel takes CUDA "
                         "tensors, its plain version CPU ones, its meta form "
                         "meta ones")
    return kind


def wkv6(r, k, v, logw, u, state0=None):
    """WKV6 sequence mix. r, k, logw (B, T, H, Dh) with logw >= -2, v
    (B, T, H, Dv) (Dv = Dh, or a rank's value columns: the value-column
    form), u (H, Dh), state0 (B, H, Dh, Dv) or None. Returns (y (B, T, H,
    Dv) float32, final state (B, H, Dh, Dv) float32)."""
    kind = _route(r)
    if kind == "cuda":
        return wkv6_cuda(r, k, v, logw, u, state0)
    if kind == "meta":
        return meta.wkv6(r, k, v, logw, u, state0)
    return wkv_chunked(r, k, v, logw, u, state0)


class WKV6Function(torch.autograd.Function):
    """(y, final state) = wkv6(r, k, v, logw, u, state0), differentiable in
    every input. A final state that takes no part in the loss brings no
    cotangent (None: zero), and only the inputs that need a gradient get
    one; nothing is read on the host."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, state0)
        return wkv6(r, k, v, logw, u, state0)

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, logw, u, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(v.shape, dtype=torch.float32, device=r.device)
        need_s0 = state0 is not None and ctx.needs_input_grad[5]
        kind = _route(r)
        if kind == "cuda":
            dr, dk, dv, dlw, du, ds0 = wkv6_bwd_cuda(
                r, k, v, logw, u.float().contiguous(), state0,
                dy.float().contiguous(),
                None if ds is None else ds.float().contiguous(), need_s0)
        elif kind == "meta":
            dr, dk, dv, dlw, du, ds0 = meta.wkv6_bwd(r, k, v, logw, u, state0,
                                                     dy, ds, need_s0)
        else:
            dr, dk, dv, dlw, du, ds0 = wkv6_bwd_ref(r, k, v, logw, u, state0,
                                                    dy, ds)
        grads = (dr, dk, dv, dlw.to(logw.dtype), du.to(u.dtype),
                 ds0 if need_s0 else None)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
