"""Wrapper of the CUDA kernels in ``csrc/amp_local.cu``: the fused AMP
local-computation step of the row layout, written by hand for Hopper.

    amp_local_cuda_grid  z' = y_p - A_p x + onsager z_p,  ss = sum(z'^2),
                         f_p = x / P + A_p^T z'; the counterpart of the JAX
                         package's ``amp_local_pallas_grid``

For N up to ``SINGLE_READ_MAX_N`` one step reads A once: a band kernel (one
block per (b, p, band of rows), ``split_plan``) and a fixed-order combine
(``combine_groups``), two launches counted as one in
``launch_counts["amp_local"]``. Wider rows take the two-pass kernels
(z-pass with its ss second stage, then the f-pass; A read twice), counted in
``launch_counts["amp_local_two_pass"]``. ``single_read`` chooses from (N,
dtype) alone, never because something failed.

It takes CUDA tensors only and either launches or raises: the plain
versions in ``ref.py`` are chosen one level up (``ops.py``) and only for CPU
tensors. Outputs and scratch come from ``torch.empty``; launches go to
PyTorch's current stream and nothing synchronises.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, load

__all__ = ["amp_local_cuda_grid", "launch_counts", "reset_launch_counts",
           "vec_width", "single_read", "rows_per_stage", "split_plan",
           "combine_groups", "sm_count", "SINGLE_READ_MAX_N", "BAND_THREADS",
           "Z_WARPS", "F_THREADS"]

BAND_THREADS = 512          # threads of a band block (kBandThreads)
REG_ELEMS = 32              # elements of a stage one thread holds (kRegElems)
SINGLE_READ_MAX_N = BAND_THREADS * REG_ELEMS    # 16384, rows of one stage
Z_WARPS = 8        # rows of A per two-pass z-pass block (one warp each)
F_THREADS = 128    # threads of a two-pass f-pass block, vec_width columns each

launch_counts = {"amp_local": 0, "amp_local_two_pass": 0}

_A_DTYPES = (torch.float32, torch.bfloat16)
_lib = None
_sm_count: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("amp_local")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.amp_local_launch.argtypes = [
            vp, ci, ll, vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_float,
            ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.amp_local_launch.restype = ci
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


def single_read(n: int, dtype: torch.dtype) -> bool:
    """Whether a step with rows of N elements of ``dtype`` takes the
    single-read kernels: a thread holds at most ``REG_ELEMS`` elements of a
    row (x and its f partial in float32 registers, whatever A's dtype), so
    N <= 16384. Wider rows take the two-pass kernels."""
    if dtype not in _A_DTYPES:
        raise ValueError(f"A: float32 or bfloat16, got {dtype}")
    return n <= SINGLE_READ_MAX_N


def rows_per_stage(n: int) -> int:
    """Rows of A one stage of the band kernel's ring holds (and one barrier
    serves): 4 while a thread's share of 4 rows fits its registers (N <=
    4096), else 1. A stage then carries at least ~16 KB for N >= 1024."""
    return 4 if n <= BAND_THREADS * REG_ELEMS // 4 else 1


def split_plan(batch: int, p: int, mp: int, n: int, dtype: torch.dtype,
               n_sm: int = 132) -> tuple[int, int]:
    """``(band_rows, n_bands)``: the Mp rows of each of the ``batch * p``
    shards cut into ``n_bands`` bands of ``band_rows`` contiguous rows (the
    last one ragged, none empty), one block each. The count aims at one
    block per SM over the whole grid (a band block fills an SM), and keeps
    the partial f's, ``batch * p * n_bands * n`` float32 written and read
    once, under a tenth of the per-instance A (``batch * p * mp * n``
    elements). ``n`` scales both sides of that cap alike."""
    esize = torch.empty((), dtype=dtype).element_size()
    want = max(1, n_sm // (batch * p))
    cap = max(1, mp * esize // 40)      # 4 * n_bands <= 0.1 * mp * esize
    rows = -(-mp // max(1, min(want, cap, mp)))
    return rows, -(-mp // rows)


def combine_groups(batch: int, p: int, n: int, n_bands: int,
                   n_sm: int = 132) -> int:
    """Band groups of a combine block: thread (c, g) adds the partials of
    bands g, g + groups, ... of column c, then a block adds its groups'
    sums in order. One group while the ``batch * p * n`` columns give the
    card its 2048 threads an SM; more (a power of two, at most 8 and at most
    the band count) only to make up the shortfall, as at P = 1."""
    want = min(8, n_bands, max(1, n_sm * 2048 // (batch * p * n)))
    return 1 << (want.bit_length() - 1)


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev`` (asked once a card)."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_count[idx]


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


def _onsager(onsager, b: int, dev) -> torch.Tensor:
    ons = torch.as_tensor(onsager, dtype=torch.float32, device=dev)
    if ons.ndim == 0:
        ons = ons.reshape(1) if b == 1 else ons.expand(b).contiguous()
    return _f32(ons, (b,), "onsager", dev)


def amp_local_cuda_grid(a_p, x, y_p, z_p, onsager, n_proc: int):
    """Fused LC step over the whole (B, P) stack on the card.

    Returns ``(z_new, f_p, ss)`` like ``ref.amp_local_ref_grid``, the same
    bits from run to run."""
    b, p, mp, n, stride, batched = _stack(a_p, x)
    dev = a_p.device
    lead = (b,) if batched else ()
    _f32(x, lead + (n,), "x", dev)
    _f32(y_p, lead + (p, mp), "y_p", dev)
    _f32(z_p, lead + (p, mp), "z_p", dev)
    ons = _onsager(onsager, b, dev)
    z_new = torch.empty_like(y_p)
    f_p = torch.empty(lead + (p, n), dtype=torch.float32, device=dev)
    ss = torch.empty(lead, dtype=torch.float32, device=dev)
    a_bf16 = int(a_p.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if not single_read(n, a_p.dtype):
        _two_pass(a_p, a_bf16, stride, x, y_p, z_p, ons, z_new, f_p, ss,
                  n_proc, b, p, mp, n, stream)
        launch_counts["amp_local_two_pass"] += 1
        return z_new, f_p, ss
    n_sm = sm_count(dev)
    band_rows, n_bands = split_plan(b, p, mp, n, a_p.dtype, n_sm)
    # one band a shard writes f itself: no partials
    fpart = torch.empty((b, p, n_bands, n) if n_bands > 1 else (0,),
                        dtype=torch.float32, device=dev)
    sspart = torch.empty((b, p, n_bands), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _library().amp_local_launch(
            a_p.data_ptr(), a_bf16, stride, x.data_ptr(), y_p.data_ptr(),
            z_p.data_ptr(), ons.data_ptr(), z_new.data_ptr(),
            fpart.data_ptr(), sspart.data_ptr(), f_p.data_ptr(),
            ss.data_ptr(), float(n_proc), b, p, mp, n, band_rows, n_bands,
            rows_per_stage(n), combine_groups(b, p, n, n_bands, n_sm),
            _vec_flag(n, a_p, x), stream)
    check("amp_local", code, "amp_local_launch")
    launch_counts["amp_local"] += 1
    return z_new, f_p, ss


def _two_pass(a_p, a_bf16, stride, x, y_p, z_p, ons, z_new, f_p, ss, n_proc,
              b, p, mp, n, stream) -> None:
    """The z-pass (and its ss second stage), then the f-pass: rows wider
    than ``SINGLE_READ_MAX_N``. Arguments checked by the caller."""
    rows = p * mp
    partial = torch.empty((b, -(-rows // Z_WARPS)), dtype=torch.float32,
                          device=a_p.device)
    with torch.cuda.device(a_p.device):
        code = _library().amp_local_z_launch(
            a_p.data_ptr(), a_bf16, stride, x.data_ptr(), y_p.data_ptr(),
            z_p.data_ptr(), ons.data_ptr(), z_new.data_ptr(),
            partial.data_ptr(), ss.data_ptr(), b, rows, n, Z_WARPS,
            _vec_flag(n, a_p, x), stream)
        check("amp_local", code, "amp_local_z_launch")
        code = _library().amp_local_f_launch(
            a_p.data_ptr(), a_bf16, stride, z_new.data_ptr(), x.data_ptr(),
            f_p.data_ptr(), float(n_proc), b, p, mp, n, F_THREADS,
            _vec_flag(n, a_p), stream)
    check("amp_local", code, "amp_local_f_launch")
