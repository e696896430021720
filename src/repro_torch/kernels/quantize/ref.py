"""Plain PyTorch version of the block-quantize kernels (``csrc/quantize.cu``).

It computes what the JAX package's ``quantize_pallas`` / ``dequantize_pallas``
and ``core.compression.quantize_blocks`` compute, bit for bit: the bf16-
rounded scale with the 1.004 no-clip nudge, round half to even, clip; and
``block_quant_fuse_ref`` what its ``BlockQuantTransport.fuse`` computes, with
the sums in the fused kernel's order, so that the kernel's f and symbols are
the same bits. The CUDA kernels are held against these functions on the
card, and they are what runs when the tensors lie on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["block_scale", "quantize_ref", "dequantize_ref",
           "block_quant_fuse_ref", "pack_int4", "unpack_int4",
           "quantize_packed_ref", "dequantize_packed_ref",
           "dequantize_sum_ref"]


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


def pack_int4(q):
    """int8 values in [-7, 7] -> packed uint8, two nibbles per byte (the
    first element of a pair in the low nibble; the reference's
    ``pack_int4``). The last axis must be even."""
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    pairs = u.reshape(*u.shape[:-1], u.shape[-1] // 2, 2)
    return pairs[..., 0] | (pairs[..., 1] << 4)


def unpack_int4(p):
    """Inverse of ``pack_int4``: int8, twice as long on the last axis."""
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    # sign-extend 4-bit two's complement
    sext = lambda v: torch.where(v > 7, v - 16, v)
    out = torch.stack([sext(lo), sext(hi)], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


def quantize_packed_ref(x, qmax: int, block: int):
    """The packed int4 form of the quantizer: ``quantize_ref`` then
    ``pack_int4`` -> (uint8 (R, N / 2), scale bf16 (R, N / block)); N even
    and a multiple of ``block``."""
    q, scale = quantize_ref(x, qmax, block)
    return pack_int4(q), scale


def dequantize_packed_ref(p, scale, block: int):
    """``unpack_int4`` then ``dequantize_ref`` -> float32 (R, 2 * bytes)."""
    return dequantize_ref(unpack_int4(p), scale, block)


def dequantize_sum_ref(q, scale, block: int, packed: bool = False):
    """Phase 1 of ``compressed_psum``: the D rows of q (D, C) dequantized
    and summed in row (rank) order d = 0, 1, ..., as the kernel sums them
    -> float32 (C,). ``packed``: q is (D, C / 2) nibbles."""
    deq = (dequantize_packed_ref(q, scale, block) if packed
           else dequantize_ref(q, scale, block))
    out = torch.zeros_like(deq[0])
    for d in range(deq.shape[0]):
        out = out + deq[d]
    return out


def block_quant_fuse_ref(f_p, qmax: int, block: int, symbols: bool = True,
                         keep=None):
    """f_p (B, P, L) -> (f (B, L), extra (B,), symbols float32 (B, P, L) or
    None): each row quantized in scale blocks (the ragged tail as zeros),
    ``f`` the sum over p of q * Delta, taken p = 0, 1, ... in turn;
    ``extra = P * mean(Delta^2) / 12`` over the P x ceil(L / block) blocks
    of each batch entry, its squares summed over p for each column of
    blocks, then over the columns in turn, as the kernel sums them. No
    product meets a sum in one operation, so nothing can be contracted.

    ``keep`` (P,) or (B, P), the erasure form (the reference's
    ``_erasure_rescale`` after ``BlockQuantTransport``'s quantizer): each
    message's ``q * Delta`` times its keep flag enters the sum in p order,
    the sum is multiplied by scale = P / n_surv, n_surv = max(sum keep, 1),
    and ``extra = mean / 12 * n_surv * (scale * scale)``, the mean still
    over every processor's blocks. Symbols are all written. With every
    flag 1 each factor is an exact 1.0 and the bits are the drop-free
    ones."""
    b, p, length = f_p.shape
    nb = -(-length // block)
    x = torch.nn.functional.pad(f_p.to(torch.float32),
                                (0, nb * block - length))
    xb = x.reshape(b, p, nb, block)
    delta = block_scale(torch.amax(torch.abs(xb), dim=-1, keepdim=True), qmax)
    q = torch.clamp(torch.round(xb / delta), -qmax, qmax)
    q = q.to(torch.int8).to(torch.float32)         # -0 becomes +0, as an int
    deq = q * delta
    if keep is not None:
        keep = keep.to(torch.float32).expand(b, p)
        deq = deq * keep[:, :, None, None]
    f = torch.zeros_like(deq[:, 0])
    dd = delta[..., 0] * delta[..., 0]             # (B, P, nb)
    col = torch.zeros_like(dd[:, 0])
    for i in range(p):
        f = f + deq[:, i]
        col = col + dd[:, i]
    total = torch.zeros_like(col[:, 0])
    for j in range(nb):
        total = total + col[:, j]
    # divided by tensors: on the card, PyTorch multiplies by the reciprocal
    # of a Python number, where the kernel divides
    mean = total / torch.full_like(total, p * nb)
    if keep is None:
        extra = mean / torch.full_like(mean, 12) * p
    else:
        n_surv = torch.clamp(keep.sum(-1), min=1.0)   # 0/1: exact
        scale = torch.full_like(n_surv, p) / n_surv
        extra = mean / torch.full_like(mean, 12) * n_surv * (scale * scale)
        f = f * scale[:, None, None]
    f = f.reshape(b, nb * block)[:, :length]
    sym = q.reshape(b, p, nb * block)[..., :length] if symbols else None
    return f, extra, sym
