"""Wrappers of the CUDA kernels in ``csrc/quantize.cu``: block-wise max-abs
quantization (int8 symbols, bf16 scales) and its inverse, written by hand
for Hopper.

    quantize_cuda      x (R, N) float32 -> q (R, N) int8, scale (R, ceil(N/block)) bf16
    dequantize_cuda    (q, scale) -> (R, N) float32

They take CUDA tensors only and either launch or raise: the plain versions
in ``ref.py`` are chosen one level up (``ops.py``) and only for CPU tensors.
Outputs come from ``torch.empty``; launches go to PyTorch's current stream
and nothing synchronises. ``launch_counts`` adds one per wrapper call that
launched its kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, load

__all__ = ["quantize_cuda", "dequantize_cuda", "launch_counts",
           "reset_launch_counts"]

launch_counts = {"quantize_blocks": 0, "dequantize_blocks": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("quantize")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.quantize_blocks_launch.argtypes = [vp, vp, vp, ll, ci, ci, ci, vp]
        lib.quantize_blocks_launch.restype = ci
        lib.dequantize_blocks_launch.argtypes = [vp, vp, vp, ll, ci, ci, vp]
        lib.dequantize_blocks_launch.restype = ci
        _lib = lib
    return _lib


def _need(t: torch.Tensor, dtype, shape, name: str) -> None:
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}, "
            f"contiguous={t.is_contiguous()}")


def _check_block(block: int) -> None:
    if block < 32 or block % 32:
        raise ValueError(f"block={block}: the kernels take a positive "
                         "multiple of 32")


def quantize_cuda(x: torch.Tensor, qmax: int, block: int):
    """Block-quantize the rows of ``x`` on the card; ``N`` need not be a
    multiple of ``block`` (the ragged tail counts as zeros)."""
    if x.ndim != 2:
        raise ValueError(f"x: need (R, N), got {tuple(x.shape)}")
    _need(x, torch.float32, x.shape, "x")
    _check_block(block)
    if not 1 <= qmax <= 127:
        raise ValueError(f"qmax={qmax}: int8 symbols need 1 <= qmax <= 127")
    r, n = x.shape
    q = torch.empty((r, n), dtype=torch.int8, device=x.device)
    scale = torch.empty((r, -(-n // block)), dtype=torch.bfloat16,
                        device=x.device)
    with torch.cuda.device(x.device):
        code = _library().quantize_blocks_launch(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), r, n, block, qmax,
            torch.cuda.current_stream().cuda_stream)
    check("quantize", code, "quantize_blocks_launch")
    launch_counts["quantize_blocks"] += 1
    return q, scale


def dequantize_cuda(q: torch.Tensor, scale: torch.Tensor, block: int):
    """``q * scale`` per block on the card -> float32 (R, N)."""
    if q.ndim != 2:
        raise ValueError(f"q: need (R, N), got {tuple(q.shape)}")
    _check_block(block)
    r, n = q.shape
    _need(q, torch.int8, (r, n), "q")
    _need(scale, torch.bfloat16, (r, -(-n // block)), "scale")
    out = torch.empty((r, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = _library().dequantize_blocks_launch(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), r, n, block,
            torch.cuda.current_stream().cuda_stream)
    check("quantize", code, "dequantize_blocks_launch")
    launch_counts["dequantize_blocks"] += 1
    return out
