"""Wrappers of the CUDA kernels in ``csrc/amp_local.cu``: the fused AMP
local-computation step of the row layout, written by hand for Hopper.

    amp_local_z_cuda   z' = y_p - A_p x + onsager z_p,  ss = sum(z'^2)
                       (the z-pass kernel plus the fixed-order second stage
                       of the ss reduction, two launches on one stream)
    amp_local_f_cuda   f_p = x / P + A_p^T z'
    amp_local_cuda_grid  both, the counterpart of the JAX package's
                       ``amp_local_pallas_grid``

They take CUDA tensors only and either launch or raise: the plain versions
in ``ref.py`` are chosen one level up (``ops.py``) and only for CPU
tensors. Outputs and scratch come from ``torch.empty``; launches go to
PyTorch's current stream and nothing synchronises. ``launch_counts`` adds
one per wrapper call that launched its kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, load

__all__ = ["amp_local_z_cuda", "amp_local_f_cuda", "amp_local_cuda_grid",
           "launch_counts", "reset_launch_counts", "vec_width",
           "Z_WARPS", "F_THREADS"]

Z_WARPS = 8        # rows of A per z-pass block (one warp each)
F_THREADS = 128    # threads of an f-pass block, each owning vec_width columns

launch_counts = {"amp_local_z": 0, "amp_local_f": 0}

_A_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("amp_local")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.amp_local_z_launch.argtypes = [
            vp, ci, ll, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.amp_local_z_launch.restype = ci
        lib.amp_local_f_launch.argtypes = [
            vp, ci, ll, vp, vp, vp, ctypes.c_float, ci, ci, ci, ci, ci, ci,
            vp]
        lib.amp_local_f_launch.restype = ci
        _lib = lib
    return _lib


def vec_width(n: int, dtype: torch.dtype) -> int:
    """Elements of A a thread loads at once: 16 bytes' worth when N is a
    multiple of that, else 1 (rows of A then start unaligned)."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    return v if n % v == 0 else 1


def _f32(t: torch.Tensor, shape, name: str, dev) -> torch.Tensor:
    if t.device != dev or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}, contiguous={t.is_contiguous()}")
    return t


def _stack(a: torch.Tensor, x: torch.Tensor, x_rank: int = 1,
           dims: str = "(P, Mp, N)"):
    """Validate an A stack ``dims`` or (B,) + ``dims`` against ``x``, whose
    unbatched rank is ``x_rank``; returns (B, P, rows, cols, batch stride,
    batched). The column kernels use it with ``x_rank=2``."""
    if not a.is_cuda:
        raise ValueError("the CUDA LC kernels take CUDA tensors; CPU tensors "
                         "go through kernels.amp_fused.ops")
    if a.dtype not in _A_DTYPES or not a.is_contiguous() \
            or a.ndim not in (3, 4):
        raise ValueError(
            f"A: need a contiguous float32/bfloat16 {dims} or (B, "
            f"{dims[1:]} tensor, got {a.dtype} {tuple(a.shape)}, "
            f"contiguous={a.is_contiguous()}")
    batched = x.ndim == x_rank + 1
    if a.ndim == 4 and not batched:
        raise ValueError("a batched A needs a batched x")
    p, rows, cols = a.shape[-3:]
    b = x.shape[0] if batched else 1
    if a.ndim == 4 and a.shape[0] != b:
        raise ValueError(f"A batch {a.shape[0]} != x batch {b}")
    stride = p * rows * cols if a.ndim == 4 else 0
    return b, p, rows, cols, stride, batched


def _vec_flag(n: int, a_p: torch.Tensor, *others: torch.Tensor) -> int:
    if vec_width(n, a_p.dtype) == 1:
        return 0
    return int(all(t.data_ptr() % 16 == 0 for t in (a_p, *others)))


def amp_local_z_cuda(a_p, x, y_p, z_p, onsager):
    """z-pass on the card. Shapes as in ``ref.py``; returns ``(z_new, ss)``
    with ``ss`` of shape ``()`` or ``(B,)``, bit-identical from run to run."""
    b, p, mp, n, stride, batched = _stack(a_p, x)
    dev = a_p.device
    lead = (b,) if batched else ()
    _f32(x, lead + (n,), "x", dev)
    _f32(y_p, lead + (p, mp), "y_p", dev)
    _f32(z_p, lead + (p, mp), "z_p", dev)
    ons = torch.as_tensor(onsager, dtype=torch.float32, device=dev)
    if ons.ndim == 0:
        ons = ons.reshape(1) if b == 1 else ons.expand(b).contiguous()
    _f32(ons, (b,), "onsager", dev)
    rows = p * mp
    z_new = torch.empty_like(y_p)
    partial = torch.empty((b, -(-rows // Z_WARPS)), dtype=torch.float32,
                          device=dev)
    ss = torch.empty(lead, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _library().amp_local_z_launch(
            a_p.data_ptr(), int(a_p.dtype == torch.bfloat16), stride,
            x.data_ptr(), y_p.data_ptr(), z_p.data_ptr(), ons.data_ptr(),
            z_new.data_ptr(), partial.data_ptr(), ss.data_ptr(),
            b, rows, n, Z_WARPS, _vec_flag(n, a_p, x),
            torch.cuda.current_stream().cuda_stream)
    check("amp_local", code, "amp_local_z_launch")
    launch_counts["amp_local_z"] += 1
    return z_new, ss


def amp_local_f_cuda(a_p, z_new, x, n_proc: int):
    """f-pass on the card: ``f_p = x / n_proc + A_p^T z'``."""
    b, p, mp, n, stride, batched = _stack(a_p, x)
    dev = a_p.device
    lead = (b,) if batched else ()
    _f32(x, lead + (n,), "x", dev)
    _f32(z_new, lead + (p, mp), "z_new", dev)
    f_p = torch.empty(lead + (p, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _library().amp_local_f_launch(
            a_p.data_ptr(), int(a_p.dtype == torch.bfloat16), stride,
            z_new.data_ptr(), x.data_ptr(), f_p.data_ptr(), float(n_proc),
            b, p, mp, n, F_THREADS, _vec_flag(n, a_p),
            torch.cuda.current_stream().cuda_stream)
    check("amp_local", code, "amp_local_f_launch")
    launch_counts["amp_local_f"] += 1
    return f_p


def amp_local_cuda_grid(a_p, x, y_p, z_p, onsager, n_proc: int):
    """Fused LC step over the whole (B, P) stack on the card.

    Returns ``(z_new, f_p, ss)`` like ``ref.amp_local_ref_grid``."""
    z_new, ss = amp_local_z_cuda(a_p, x, y_p, z_p, onsager)
    f_p = amp_local_f_cuda(a_p, z_new, x, n_proc)
    return z_new, f_p, ss
