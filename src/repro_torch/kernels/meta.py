"""The kernels' meta form, for the dry run (``launch/dryrun.py``): tensors
on the ``meta`` device get outputs of the right shape and dtype, and the
kernel's own operation and byte count (the one its bound in ``PERF.md``
and ``chip_smoke.py`` uses: inputs read once, outputs written once) is
added to every open ``tally``. Nothing is computed; the plain version never
runs on meta (the dispatch in ``*/ops.py`` makes meta a case of its own).

A tally is ``{kernel name: {"calls", "flops", "bytes"}}``.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["tally", "decode_attention", "decode_attention_slice", "wkv6",
           "wkv6_bwd", "quantize", "dequantize", "dequantize_sum",
           "block_quant_fuse"]

_OPEN: list = []
CHUNK = 32          # K6's chunk of steps (kernels/wkv6/ref.py::CHUNK)


@contextlib.contextmanager
def tally():
    """A dict that every meta call made inside the block adds to."""
    d: dict = {}
    _OPEN.append(d)
    try:
        yield d
    finally:
        _OPEN.remove(d)


def _count(name: str, flops: float, nbytes: float) -> None:
    for d in _OPEN:
        rec = d.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += float(flops)
        rec["bytes"] += float(nbytes)


def _empty(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# -- K5 -------------------------------------------------------------------------

def _attn_cost(q, k_cache, rows: int, out_bytes: int):
    b, h, dh = q.shape
    kv = k_cache.shape[2]
    nbytes = (b * h * dh * _size(q.dtype) + out_bytes
              + 2 * rows * b * kv * dh * _size(k_cache.dtype))
    return 4.0 * b * h * dh * rows + 5.0 * b * h * rows, nbytes


def decode_attention(q, k_cache, v_cache, pos: int, window: int = 0):
    """K5: (B, H, Dh) in q's dtype; the rows ``pos`` attends to read once."""
    from .decode_attn.ref import valid_rows
    lo, hi = valid_rows(k_cache.shape[1], int(pos), int(window))
    flops, nbytes = _attn_cost(q, k_cache, hi - lo + 1,
                               q.numel() * _size(q.dtype))
    _count("decode_attn", flops, nbytes)
    return _empty(q.shape, q.dtype)


def decode_attention_slice(q, k_slice, v_slice, pos: int, window: int = 0,
                           row0: int = 0):
    """K5's slice form: (out (B, H, Dh), lse (B, H)) float32; a slice with
    no row that ``pos`` attends to counts no call."""
    from .decode_attn.ref import slice_rows
    b, h, dh = q.shape
    rows = slice_rows(k_slice.shape[1], int(row0), int(pos), int(window))
    if rows is not None:
        flops, nbytes = _attn_cost(q, k_slice, rows[1] - rows[0] + 1,
                                   4 * b * h * (dh + 1))
        _count("decode_attn_slice", flops, nbytes)
    return _empty((b, h, dh), torch.float32), _empty((b, h), torch.float32)


# -- K6 and its backward --------------------------------------------------------

def _chunks(t: int, per_chunk) -> float:
    full, rest = divmod(t, CHUNK)
    return full * per_chunk(CHUNK) + (per_chunk(rest) if rest else 0)


def wkv6(r, k, v, logw, u, state0=None):
    """K6: (y (B, T, H, Dv), final state (B, H, Dh, Dv)) float32, Dv = v's
    last dimension (Dh, or a rank's value columns)."""
    b, t, h, dh = r.shape
    dv = v.shape[-1]
    e, n, nv = _size(r.dtype), b * t * h * dh, b * t * h * dv
    st = b * h * dh * dv * 4
    nbytes = (2 * n * e + nv * e + 4 * n + 4 * h * dh
              + (st if state0 is not None else 0) + 4 * nv + st)
    ops = lambda c: (2 * c * (c - 1) * dh + 2 * c * dh * dv + 2 * dh * dv * c
                     + 10 * c * dh + 2 * dh * dv)
    _count("wkv6", b * h * _chunks(t, ops), nbytes)
    return (_empty((b, t, h, dv), torch.float32),
            _empty((b, h, dh, dv), torch.float32))


def wkv6_bwd(r, k, v, logw, u, state0, dy, ds=None,
             need_state0_grad: bool = False):
    """K6's backward: (dr, dk, dv, dlogw, du (H, Dh) float32, dstate0 or
    None), v of Dv <= Dh columns as in ``wkv6``."""
    b, t, h, dh = r.shape
    dv = v.shape[-1]
    e, n, nv = _size(r.dtype), b * t * h * dh, b * t * h * dv
    st = b * h * dh * dv * 4
    s0 = st if state0 is not None else 0
    nbytes = (2 * n * e + nv * e + 4 * n + 4 * nv + 4 * h * dh + s0
              + (st if ds is not None else 0)
              + 2 * n * e + nv * e + 4 * n + 4 * h * dh + s0)
    ops = lambda c: (2 * dh * dv * c + c * (c - 1) * dv + 2 * c * c * dh
                     + 6 * c * dh * dv + 3 * c * (c - 1) * dh
                     + 2 * dh * dv * c + 16 * c * dh + 4 * dh * dv)
    _count("wkv6_bwd", b * h * _chunks(t, ops), nbytes)
    ds0 = (_empty((b, h, dh, dv), torch.float32)
           if state0 is not None and need_state0_grad else None)
    return (_empty(r.shape, r.dtype), _empty(k.shape, k.dtype),
            _empty(v.shape, v.dtype), _empty(logw.shape, logw.dtype),
            _empty((h, dh), torch.float32), ds0)


# -- K4 -------------------------------------------------------------------------

def quantize(x, qmax: int = 127, block: int = 512, packed: bool = False):
    """K4a: (q int8 (R, N), or uint8 (R, ceil(N / 2)) packed; scales bf16
    (R, ceil(N / block)))."""
    r, n = x.shape
    nb = -(-n // block)
    qcols = (n + 1) // 2 if packed else n
    _count("quantize_blocks_packed" if packed else "quantize_blocks",
           5.0 * r * n, 4 * r * n + r * qcols + 2 * r * nb)
    return (_empty((r, qcols), torch.uint8 if packed else torch.int8),
            _empty((r, nb), torch.bfloat16))


def dequantize(q, scale, block: int = 512, packed: bool = False,
               n: int | None = None):
    """K4b: float32 (R, N)."""
    r = q.shape[0]
    n = (2 * q.shape[1] if packed else q.shape[1]) if n is None else n
    _count("dequantize_blocks_packed" if packed else "dequantize_blocks",
           2.0 * r * n, q.numel() + 2 * scale.numel() + 4 * r * n)
    return _empty((r, n), torch.float32)


def dequantize_sum(q, scale, block: int = 512, packed: bool = False,
                   c: int | None = None):
    """K4b's summing form: float32 (C,)."""
    d = q.shape[0]
    c = (2 * q.shape[1] if packed else q.shape[1]) if c is None else c
    _count("dequantize_sum_packed" if packed else "dequantize_sum",
           2.0 * d * c, q.numel() + 2 * scale.numel() + 4 * c)
    return _empty((c,), torch.float32)


def block_quant_fuse(f_p, qmax: int = 127, block: int = 512,
                     symbols: bool = True, keep=None):
    """K4 fused: (f (B, L), extra (B,), symbols (B, P, L) or None)."""
    b, p, length = f_p.shape
    n = b * p * length
    nbytes = (4 * n + 4 * b * length + 4 * b + (4 * n if symbols else 0)
              + (4 * keep.numel() if keep is not None else 0))
    _count("block_quant_fuse", 7.0 * n, nbytes)
    return (_empty((b, length), torch.float32), _empty((b,), torch.float32),
            _empty((b, p, length), torch.float32) if symbols else None)

