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
``kernels/quantize`` (a CUDA kernel on the card); ``quantize_blocks`` /
``dequantize_blocks`` here are the plain counterparts of the reference's and
serve the tests and host code. The scale rule has one home,
``kernels/quantize/ref.py::block_scale``.

``compressed_psum`` is the reference's two-phase lossy all-reduce over a
device mesh (``launch/mesh.py::Mesh``, collectives of
``core/collectives.py``):

  phase 1 (a reduce-scatter): each rank pads its summand to a multiple of
     D * block * 2, cuts it into D chunks, quantizes them (K4a) and
     ``all_to_all``'s the symbols and scales; each rank dequantizes the D
     chunks it received and sums them in rank order (K4b's summing form).
  phase 2 (an all-gather): the reduced chunk is quantized again (K4a),
     ``all_gather``'d, and every rank dequantizes the whole (K4b).

On the int4 wire the symbols travel packed two a byte, written so by the
quantizer itself. The kernels run where the tensors lie on the card, their
plain versions on the CPU (``kernels/quantize/ops.py``). Each phase drops
its temporaries as soon as the next is made: on a gradient leaf of 3e8
elements (gemma3-1b's embedding) each float32 one is 1.2 GB.

``compressed_grad_transform`` is the per-leaf compressed sum of a gradient
pytree with error feedback (the reference's, on the same kernels).
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.quantize import ops as qops
from ..kernels.quantize.ref import block_scale, pack_int4, unpack_int4
from .collectives import all_gather, all_to_all

__all__ = ["QuantConfig", "quantize_blocks", "dequantize_blocks",
           "pack_int4", "unpack_int4", "quant_noise_var", "compressed_psum",
           "compressed_grad_transform"]


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


def quant_noise_var(scale, qc: QuantConfig | None = None, batch_dims: int = 0):
    """Per-element quantization noise variance Delta^2/12 (paper Sec. 3.2),
    the mean over every block of ``scale``. The first ``batch_dims`` axes
    are a batch written out: one value per batch entry, as the reference
    gets from ``vmap``."""
    d = scale.to(torch.float32)
    return torch.mean(d * d, dim=tuple(range(batch_dims, d.ndim))) / 12.0


def _wire_encode(x, qc: QuantConfig):
    """Quantize the rows of ``x`` (R, C) for the wire: int8 symbols, or at
    4 bits the packed uint8 (R, C / 2), and the bf16 scales."""
    return qops.quantize(x, qc.qmax, qc.block, packed=qc.bits == 4)


def _wire_decode(w, scale, qc: QuantConfig):
    """Dequantize wire rows (``_wire_encode``'s) to float32 (R, C)."""
    return qops.dequantize(w, scale, qc.block, packed=qc.bits == 4)


def compressed_psum(x, mesh, qc: QuantConfig = QuantConfig()):
    """Sum ``x`` over ``mesh`` with lossy-compressed transport.

    Every rank calls it with its own ``x`` (any shape, float32) and gets
    ``(sum, injected_noise_var)``: the sum up to quantization error, the
    same bits on every rank, in ``x``'s shape, and this rank's noise
    account ``noise1 * D + noise2``, the paper's P * sigma_Q^2 from its own
    send-side scales (the transport takes its mean over the mesh). No
    value is read on the host."""
    n = mesh.size
    flat = x.reshape(-1).to(torch.float32)
    flat, _ = _pad_to(flat[None], n * qc.block * 2)
    chunks = flat[0].reshape(n, -1)           # (D, C): chunk d goes to rank d

    # phase 1: quantize per-destination chunks, exchange, reduce own chunk
    wire, scale = _wire_encode(chunks, qc)
    del chunks
    noise1 = quant_noise_var(scale) * n       # n summands -> n * sigma_Q^2
    wire_r = all_to_all(wire, mesh)
    scale_r = all_to_all(scale, mesh)
    del wire, scale
    own = qops.dequantize_sum(wire_r, scale_r, qc.block,
                              packed=qc.bits == 4)          # (C,)
    del wire_r, scale_r

    # phase 2: re-quantize the reduced chunk, gather everyone's
    wire2, scale2 = _wire_encode(own[None], qc)
    del own
    noise2 = quant_noise_var(scale2)
    wire_g = all_gather(wire2[0], mesh)       # (D, C) or (D, C / 2)
    scale_g = all_gather(scale2[0], mesh)     # (D, C / block)
    del wire2, scale2
    full = _wire_decode(wire_g, scale_g, qc)
    del wire_g, scale_g
    out = full.reshape(-1)[:x.numel()].reshape(x.shape)
    return out.to(x.dtype), noise1 + noise2


def compressed_grad_transform(grads: dict, residual: dict, mesh,
                              qc: QuantConfig = QuantConfig()):
    """Per-leaf compressed sum over ``mesh`` with error feedback.

    ``grads``: this rank's (unreduced) gradients, a flat dict; ``residual``:
    the same keys, the quantization residue carried from the last call
    (error feedback keeps the compression bias from accumulating across
    steps). Leaves go in sorted key order (the reference's pytree order),
    so every rank runs the same collectives. Returns (reduced grads, new
    residual, total noise variance): the residual is what quantizing this
    rank's fed-back gradient ``g + r`` alone loses (the reference's cheap
    proxy), through the wire's int8 symbols (K4a and K4b on the card)."""
    out, new_res = {}, {}
    noise = None
    for k in sorted(grads):
        g, r = grads[k], residual[k]
        g_fb = g.to(torch.float32) + r.to(torch.float32)
        red, nv = compressed_psum(g_fb, mesh, qc)
        row = g_fb.reshape(1, -1)
        q, s = qops.quantize(row, qc.qmax, qc.block)
        deq = qops.dequantize(q, s, qc.block).reshape(g.shape)
        new_res[k] = (g_fb - deq).to(r.dtype)
        out[k] = red.to(g.dtype)
        noise = nv if noise is None else noise + nv
    return out, new_res, noise
