"""Dispatch for block quantization: the device of the tensor decides.

A CUDA tensor goes to the hand-written kernels (``quantize.py``) and either
launches or raises; a CPU tensor goes to the plain versions (``ref.py``),
with the ragged row tail padded here (the kernels read it as zeros, so on
the card no padded copy is made). There is no switch and no fallback.

Unlike the reference's ``ops.quantize``, which pads to its TPU tiles and
returns the original shape beside the padded arrays, these return the
unpadded ``q (R, N)`` and the ``ceil(N / block)`` scales of each row.
"""
from __future__ import annotations

import torch

from .quantize import dequantize_cuda, quantize_cuda
from .ref import dequantize_ref, quantize_ref

__all__ = ["quantize", "dequantize", "quantize_plain", "dequantize_plain",
           "BLOCK"]

BLOCK = 512           # elements per scale block (QuantConfig.block default)


def _pad_cols(x, block: int):
    pad = (-x.shape[-1]) % block
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def quantize_plain(x, qmax: int = 127, block: int = BLOCK):
    """The plain version of ``quantize`` on any device (the ragged tail
    padded with zeros, as the kernel reads it)."""
    q, scale = quantize_ref(_pad_cols(x, block), qmax, block)
    return q[:, :x.shape[-1]], scale


def dequantize_plain(q, scale, block: int = BLOCK):
    """The plain version of ``dequantize`` on any device."""
    return dequantize_ref(_pad_cols(q, block), scale, block)[:, :q.shape[-1]]


def quantize(x, qmax: int = 127, block: int = BLOCK):
    """Block-quantize a 2D float32 tensor: ``(q int8 (R, N), scale bf16
    (R, ceil(N / block)))``."""
    if x.is_cuda:
        return quantize_cuda(x, qmax, block)
    return quantize_plain(x, qmax, block)


def dequantize(q, scale, block: int = BLOCK):
    """Inverse of ``quantize``: float32 (R, N)."""
    if q.is_cuda:
        return dequantize_cuda(q, scale, block)
    return dequantize_plain(q, scale, block)
