"""Plain PyTorch version of the block-quantize kernels (``csrc/quantize.cu``).

It computes what the JAX package's ``quantize_pallas`` / ``dequantize_pallas``
and ``core.compression.quantize_blocks`` compute, bit for bit: the bf16-
rounded scale with the 1.004 no-clip nudge, round half to even, clip.
The CUDA kernels are held against these functions on the card, and they are
what runs when the tensors lie on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["block_scale", "quantize_ref", "dequantize_ref"]


def block_scale(amax, qmax: int):
    """bf16-rounded bin size, as float32, of blocks with max-abs ``amax``:
    ``bf16(max(amax / qmax, 1e-30) * 1.004)``.

    The division is by a tensor, not a Python number: PyTorch on the card
    turns division by a host scalar into a multiplication by its
    reciprocal, which can differ in the last bit from the IEEE division of
    the reference and of the CUDA kernel."""
    delta = torch.clamp(amax / torch.full_like(amax, float(qmax)),
                        min=1e-30) * 1.004
    return delta.to(torch.bfloat16).to(torch.float32)


def quantize_ref(x, qmax: int, block: int):
    """x (R, N) with N % block == 0 -> (q int8 (R, N), scale bf16
    (R, N / block))."""
    r, n = x.shape
    xb = x.to(torch.float32).reshape(r, n // block, block)
    delta = block_scale(torch.amax(torch.abs(xb), dim=-1, keepdim=True), qmax)
    q = torch.clamp(torch.round(xb / delta), -qmax, qmax).to(torch.int8)
    return q.reshape(r, n), delta[..., 0].to(torch.bfloat16)


def dequantize_ref(q, scale, block: int):
    """q int8 (R, N), scale bf16 (R, N / block) -> float32 (R, N)."""
    r, n = q.shape
    qb = q.reshape(r, n // block, block).to(torch.float32)
    return (qb * scale.to(torch.float32)[..., None]).reshape(r, n)
