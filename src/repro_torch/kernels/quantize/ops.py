"""Dispatch for block quantization: the device of the tensor decides.

A CUDA tensor goes to the hand-written kernels (``quantize.py``) and either
launches or raises; a CPU tensor goes to the plain versions (``ref.py``),
with the ragged row tail padded here (the kernels read it as zeros, so on
the card no padded copy is made); a meta tensor (the dry run) to the
kernels' meta forms (``kernels/meta.py``). There is no switch and no
fallback: any other device raises.
``block_quant_fuse`` is the whole of the block-quantized transport's fusion
(``core/engine.py::BlockQuantTransport``), one launch on the card.
``quantize`` / ``dequantize`` with ``packed`` (the int4 wire: two symbols a
byte) and ``dequantize_sum`` are the forms of the two-phase
``compressed_psum`` (``core/compression.py``).

Unlike the reference's ``ops.quantize``, which pads to its TPU tiles and
returns the original shape beside the padded arrays, these return the
unpadded ``q (R, N)`` and the ``ceil(N / block)`` scales of each row.
"""
from __future__ import annotations

import torch

from .. import meta
from .quantize import (block_quant_fuse_cuda, dequantize_cuda,
                       dequantize_sum_cuda, quantize_cuda)
from .ref import (block_quant_fuse_ref, dequantize_packed_ref,
                  dequantize_ref, dequantize_sum_ref, quantize_packed_ref,
                  quantize_ref)

__all__ = ["quantize", "dequantize", "dequantize_sum", "quantize_plain",
           "dequantize_plain", "dequantize_sum_plain", "block_quant_fuse",
           "BLOCK"]

BLOCK = 512           # elements per scale block (QuantConfig.block default)


def _route(x):
    kind = x.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"block quantization on {x.device}: the kernels "
                         "take CUDA tensors, their plain versions CPU ones, "
                         "their meta forms meta ones")
    return kind


def _pad_cols(x, block: int):
    pad = (-x.shape[-1]) % block
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def quantize_plain(x, qmax: int = 127, block: int = BLOCK,
                   packed: bool = False):
    """The plain version of ``quantize`` on any device (the ragged tail
    padded with zeros, as the kernel reads it; packed rows padded to an
    even length as well)."""
    n = x.shape[-1]
    if not packed:
        q, scale = quantize_ref(_pad_cols(x, block), qmax, block)
        return q[:, :n], scale
    q, scale = quantize_packed_ref(_pad_cols(x, block), qmax, block)
    return q[:, :(n + 1) // 2], scale


def _pad_symbols(q, block: int, packed: bool):
    return _pad_cols(q, block // 2 if packed else block)


def dequantize_plain(q, scale, block: int = BLOCK, packed: bool = False,
                     n: int | None = None):
    """The plain version of ``dequantize`` on any device."""
    if not packed:
        return dequantize_ref(_pad_cols(q, block), scale,
                              block)[:, :q.shape[-1]]
    n = 2 * q.shape[-1] if n is None else n
    return dequantize_packed_ref(_pad_symbols(q, block, True), scale,
                                 block)[:, :n]


def dequantize_sum_plain(q, scale, block: int = BLOCK, packed: bool = False,
                         c: int | None = None):
    """The plain version of ``dequantize_sum`` on any device."""
    c = (2 * q.shape[-1] if packed else q.shape[-1]) if c is None else c
    return dequantize_sum_ref(_pad_symbols(q, block, packed), scale, block,
                              packed)[:c]


def quantize(x, qmax: int = 127, block: int = BLOCK, packed: bool = False):
    """Block-quantize a 2D float32 tensor: ``(q int8 (R, N), scale bf16
    (R, ceil(N / block)))``; ``packed`` (int4, qmax <= 7): q is uint8
    (R, ceil(N / 2)), two symbols a byte, the first of a pair in the low
    nibble."""
    kind = _route(x)
    if kind == "cuda":
        return quantize_cuda(x, qmax, block, packed)
    if kind == "meta":
        return meta.quantize(x, qmax, block, packed)
    return quantize_plain(x, qmax, block, packed)


def dequantize(q, scale, block: int = BLOCK, packed: bool = False,
               n: int | None = None):
    """Inverse of ``quantize``: float32 (R, N) (``n`` the row length of
    packed symbols, default twice the bytes)."""
    kind = _route(q)
    if kind == "cuda":
        return dequantize_cuda(q, scale, block, packed, n)
    if kind == "meta":
        return meta.dequantize(q, scale, block, packed, n)
    return dequantize_plain(q, scale, block, packed, n)


def dequantize_sum(q, scale, block: int = BLOCK, packed: bool = False,
                   c: int | None = None):
    """Dequantize the D rows of q (D, C) and sum them in row order, d = 0,
    1, ...: float32 (C,). One launch on the card."""
    kind = _route(q)
    if kind == "cuda":
        return dequantize_sum_cuda(q, scale, block, packed, c)
    if kind == "meta":
        return meta.dequantize_sum(q, scale, block, packed, c)
    return dequantize_sum_plain(q, scale, block, packed, c)


def block_quant_fuse(f_p, qmax: int = 127, block: int = BLOCK,
                     symbols: bool = True, keep=None):
    """Quantize each message of ``f_p`` (B, P, L), dequantize and sum over
    P: ``(f (B, L), extra (B,), symbols float32 (B, P, L) or None)``, with
    ``extra = P * mean(Delta^2) / 12`` per batch entry. ``keep`` (P,)
    shared or (B, P), float32 0/1 on the same device, is the erasure form:
    the sum of the delivered messages times P / n_surv and ``extra =
    mean(Delta^2) / 12 * n_surv * (P / n_surv)^2``, n_surv = max(sum keep,
    1)."""
    kind = _route(f_p)
    if kind == "cuda":
        return block_quant_fuse_cuda(f_p, qmax, block, symbols, keep=keep)
    if kind == "meta":
        return meta.block_quant_fuse(f_p, qmax, block, symbols, keep)
    return block_quant_fuse_ref(f_p, qmax, block, symbols, keep=keep)
