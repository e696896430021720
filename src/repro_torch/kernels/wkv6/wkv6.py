"""Wrapper of the CUDA kernel in ``csrc/wkv6.cu``: the RWKV-6 WKV recurrence
in chunks of 32 steps, written by hand for Hopper.

    wkv6_cuda   r, k, v, logw (B, T, H, Dh), u (H, Dh), state0 (B, H, Dh, Dh)
                -> y (B, T, H, Dh) float32, final state (B, H, Dh, Dh) float32

It takes CUDA tensors only and either launches or raises: the plain version
(``ref.py::wkv_chunked``, the same function) is chosen one level up
(``ops.py``) and only for CPU tensors. The caller keeps ``logw >= -2``.
Outputs come from ``torch.empty``; the launch goes to PyTorch's current
stream and nothing synchronises. ``launch_counts`` adds one per wrapper
call that launched.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, load

__all__ = ["wkv6_cuda", "launch_counts", "reset_launch_counts", "MAX_DH"]

launch_counts = {"wkv6": 0}

MAX_DH = 128

_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("wkv6")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_launch.argtypes = [vp] * 8 + [ci] * 5 + [vp]
        lib.wkv6_launch.restype = ci
        _lib = lib
    return _lib


def _need(t: torch.Tensor, name: str, dtypes, shape) -> None:
    if not t.is_cuda or t.dtype not in dtypes \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous CUDA tensor of shape {tuple(shape)} "
            f"in {[str(d) for d in dtypes]}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}, contiguous={t.is_contiguous()}")


def wkv6_cuda(r, k, v, logw, u, state0=None):
    """The recurrence on the card: r, k, v bf16 or float32 (one dtype),
    logw float32, u any float dtype (widened to float32 here, (H, Dh) is
    small), state0 float32 or None for zeros."""
    if r.ndim != 4:
        raise ValueError(f"r: need (B, T, H, Dh), got {tuple(r.shape)}")
    b, t, h, dh = r.shape
    if dh % 4 or not 4 <= dh <= MAX_DH:
        raise ValueError(f"Dh={dh}: the kernel takes a multiple of 4 up to "
                         f"{MAX_DH}")
    _need(r, "r", (torch.bfloat16, torch.float32), r.shape)
    _need(k, "k", (r.dtype,), r.shape)
    _need(v, "v", (r.dtype,), r.shape)
    _need(logw, "logw", (torch.float32,), r.shape)
    if tuple(u.shape) != (h, dh) or not u.is_cuda:
        raise ValueError(f"u: need a CUDA tensor of shape {(h, dh)}, got "
                         f"{tuple(u.shape)} on {u.device}")
    if state0 is not None:
        _need(state0, "state0", (torch.float32,), (b, h, dh, dh))
    if len({x.device for x in (r, k, v, logw, u)}) != 1 or (
            state0 is not None and state0.device != r.device):
        raise ValueError("all inputs must be on one device")
    u32 = u.float().contiguous()
    y = torch.empty((b, t, h, dh), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        code = _library().wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u32.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, t, h, dh,
            int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check("wkv6", code, "wkv6_launch")
    launch_counts["wkv6"] += 1
    return y, state
