"""Block-wise max-abs int8/int4 quantization — the wire format of the JAX
package's ``core/compression.py``, in plain PyTorch.

Each block of ``block`` consecutive elements is sent as int8 symbols
``q = clip(round(x / Delta), -qmax, qmax)`` and one bfloat16 scale
``Delta = bf16(max(amax / qmax, 1e-30) * 1.004)``. The scale is rounded to
its bf16 wire format *before* use, so encoder and decoder agree exactly; the
1.004 nudge makes the bf16 rounding an upper bound, so the largest element
never clips and ``|err| <= Delta / 2`` holds exactly. These numerics are the
reference's bit for bit (``torch.round`` rounds half to even, as
``jnp.round``).

``BlockQuantTransport`` (``core/engine.py``) runs the same function through
``kernels/quantize`` (a CUDA kernel on the card); this module is the plain
counterpart of the reference module and serves the tests and host code. The
scale rule has one home, ``kernels/quantize/ref.py::block_scale``.
``compressed_psum`` / ``compressed_grad_transform`` need several devices and
come with the multi-device solves.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.quantize.ref import block_scale

__all__ = ["QuantConfig", "quantize_blocks", "dequantize_blocks",
           "pack_int4", "unpack_int4", "quant_noise_var"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bits: int = 8             # 8 or 4 (packed)
    block: int = 512          # elements per scale block
    stochastic: bool = False  # stochastic rounding (decode-side unbiasedness)

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1


def _pad_to(x, k):
    r = (-x.shape[-1]) % k
    if r:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (r,))], -1)
    return x, r


def quantize_blocks(x, qc: QuantConfig, generator: torch.Generator | None = None):
    """x (..., N) -> (q int8 (..., N padded to a block multiple),
    scale bf16 (..., ceil(N / block))).

    With ``qc.stochastic`` and a ``generator`` the rounding is stochastic
    (``floor(x / Delta + 0.5 + U - 0.5)``, U uniform on [0, 1)); its random
    numbers are not the reference's, only their distribution is.
    """
    x, _ = _pad_to(x.to(torch.float32), qc.block)
    blocks = x.reshape(*x.shape[:-1], -1, qc.block)
    delta = block_scale(torch.amax(torch.abs(blocks), dim=-1, keepdim=True),
                        qc.qmax)
    scaled = blocks / delta
    if qc.stochastic and generator is not None:
        noise = torch.rand(scaled.shape, generator=generator,
                           device=scaled.device) - 0.5
        q = torch.floor(scaled + 0.5 + noise)
    else:
        q = torch.round(scaled)
    q = torch.clamp(q, -qc.qmax, qc.qmax).to(torch.int8)
    return q.reshape(x.shape), delta[..., 0].to(torch.bfloat16)


def dequantize_blocks(q, scale, qc: QuantConfig, orig_len: int | None = None):
    n = q.shape[-1]
    blocks = q.reshape(*q.shape[:-1], -1, qc.block).to(torch.float32)
    out = (blocks * scale.to(torch.float32)[..., None]).reshape(
        *q.shape[:-1], n)
    if orig_len is not None and orig_len != n:
        out = out[..., :orig_len]
    return out


def pack_int4(q):
    """int8 values in [-7, 7] -> packed uint8, two nibbles per byte (the
    first element of a pair in the low nibble)."""
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    pairs = u.reshape(*u.shape[:-1], u.shape[-1] // 2, 2)
    return pairs[..., 0] | (pairs[..., 1] << 4)


def unpack_int4(p):
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    # sign-extend 4-bit two's complement
    sext = lambda v: torch.where(v > 7, v - 16, v)
    out = torch.stack([sext(lo), sext(hi)], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


def quant_noise_var(scale, qc: QuantConfig | None = None, batch_dims: int = 0):
    """Per-element quantization noise variance Delta^2/12 (paper Sec. 3.2),
    the mean over every block of ``scale``. The first ``batch_dims`` axes
    are a batch written out: one value per batch entry, as the reference
    gets from ``vmap``."""
    d = scale.to(torch.float32)
    return torch.mean(d * d, dim=tuple(range(batch_dims, d.ndim))) / 12.0
