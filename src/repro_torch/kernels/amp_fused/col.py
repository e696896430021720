"""Wrappers of the CUDA kernels in ``csrc/amp_col.cu``: the column-layout
(C-MP-AMP) local computation, written by hand for Hopper.

    col_residual_cuda   r_p = A_p x_p                       (one launch)
    col_inner_cuda      one C-MP-AMP inner iteration: f_p = x_p + A_p^T z_p,
                        s2 = max(||z_p||^2 / m_eff, 1e-30), Bernoulli-Gauss
                        denoise and its derivative sum c_p, and when
                        ``update_z`` the residual z_p <- g - A_p (x' - x0) + c_p z_p
                        (two or three launches on one stream)

Shapes: ``a_cp`` (P, M, Np) shared by the batch or (B, P, M, Np); ``x``,
``x0`` (P, Np) or (B, P, Np); ``z_p`` (P, M) or (B, P, M); ``g`` (M,) or
(B, M); ``n_mask`` (Np,) shared, (B, Np) per instance, or None; ``par``
(4,) shared or (B, 4) per instance, float32 ``[m_eff, eps, mu_s,
sigma_s^2]`` on the card (``ref.col_params``). A may be bfloat16. They take CUDA tensors
only and either launch or raise: the plain versions in ``ref.py`` are
chosen one level up (``ops.py``) and only for CPU tensors. Outputs and
scratch come from ``torch.empty``; launches go to PyTorch's current stream
and nothing synchronises. ``launch_counts`` adds one per wrapper call that
launched its kernels.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import check, load
from .amp_fused import (Z_WARPS, _f32, _stack, _vec_flag, sm_count,
                        vec_width)

__all__ = ["col_residual_cuda", "col_inner_cuda", "launch_counts",
           "reset_launch_counts", "row_chunk", "col_stage_rows",
           "col_band_plan", "F_THREADS"]

F_THREADS = 128    # threads of an A^T z block (kFThreads in amp_col.cu)
STAGE_BYTES = 16 * 1024   # a stage of the row pass's ring (kColStageBytes)

launch_counts = {"col_residual": 0, "col_inner": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = load("amp_col")
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.col_residual_launch.argtypes = [vp, ci, ll, vp, vp, ci, ci, ci,
                                            ci, ci, ci, ci, ci, ci, vp]
        lib.col_residual_launch.restype = ci
        lib.col_inner_launch.argtypes = [
            vp, ci, ll, vp, vp, vp, vp, vp, ll, vp, ll, vp, vp, vp, vp,
            vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.col_inner_launch.restype = ci
        _lib = lib
    return _lib


def col_stage_rows(np_: int, dtype) -> int:
    """Rows of A_p one stage of the row pass's ring holds: as many whole
    rows as fit ``STAGE_BYTES``. 0 when the ring cannot take the rows: a bulk
    copy needs rows of a multiple of 16 bytes (``vec_width`` > 1), and a
    stage at least one row. Rows the ring does not take are read by one warp
    a row from device memory."""
    row_bytes = np_ * torch.empty((), dtype=dtype).element_size()
    if vec_width(np_, dtype) == 1 or row_bytes > STAGE_BYTES:
        return 0
    return STAGE_BYTES // row_bytes


def col_band_plan(n_stack: int, m: int, n_sm: int = 132) -> tuple[int, int]:
    """``(band_rows, n_bands)`` of the row pass's ring: the M rows of each
    of the ``n_stack`` (b, p) shards cut into contiguous bands (the last one
    ragged, none empty), one block each, about two blocks an SM over the
    grid (a block's ring and x take ~82 KB of shared memory). The rows are
    independent, so nothing is reduced across bands."""
    want = max(1, min(m, 2 * n_sm // n_stack))
    rows = -(-m // want)
    return rows, -(-m // rows)


def _ring_plan(dev, b: int, p: int, m: int, np_: int, dtype,
               vec: int) -> tuple[int, int, int]:
    """(band_rows, n_bands, stage_rows) for the C entry points; all 0 when
    the row pass reads device memory directly (no ring)."""
    stage_rows = col_stage_rows(np_, dtype) if vec else 0
    if stage_rows == 0:
        return 0, 0, 0
    return (*col_band_plan(b * p, m, sm_count(dev)), stage_rows)


def row_chunk(dev, n_stack: int, m: int, np_: int, dtype) -> int:
    """Rows of A_p one A^T z block sums over: M is split so that the grid
    holds about eight blocks per SM (never chunks under 32 rows). Fixed for
    a given shape and card, so the sums' order, and their bits, are too."""
    sms = sm_count(dev)
    tiles = -(-np_ // (F_THREADS * vec_width(np_, dtype)))
    n_chunks = max(1, min(-(-m // 32), -(-8 * sms // (n_stack * tiles))))
    return -(-m // n_chunks)


def col_residual_cuda(a_cp, x):
    """``r_p = A_p x_p`` on the card: (P, M) or (B, P, M) float32."""
    b, p, m, np_, stride, batched = _stack(a_cp, x, x_rank=2,
                                              dims="(P, M, Np)")
    dev = a_cp.device
    lead = (b,) if batched else ()
    _f32(x, lead + (p, np_), "x", dev)
    r = torch.empty(lead + (p, m), dtype=torch.float32, device=dev)
    vec = _vec_flag(np_, a_cp, x)
    plan = _ring_plan(dev, b, p, m, np_, a_cp.dtype, vec)
    with torch.cuda.device(dev):
        code = _library().col_residual_launch(
            a_cp.data_ptr(), int(a_cp.dtype == torch.bfloat16), stride,
            x.data_ptr(), r.data_ptr(), b, p, m, np_, Z_WARPS, vec, *plan,
            torch.cuda.current_stream().cuda_stream)
    check("amp_col", code, "col_residual_launch")
    launch_counts["col_residual"] += 1
    return r


def _per_instance(t, name: str, width: int, b: int, batched: bool, dev):
    """Validate ``par`` or ``n_mask``: one row for the whole stack
    (``(width,)``) or, for a batched stack, one per instance ``(B,
    width)``. Returns the row stride the kernel steps by (0: shared)."""
    if t.ndim == 2 and batched:
        _f32(t, (b, width), name, dev)
        return width
    _f32(t, (width,), name, dev)
    return 0


def col_inner_cuda(a_cp, x, x0, z_p, g, n_mask, par, update_z: bool):
    """One fused C-MP-AMP inner iteration on the card. Returns ``(x_new,
    c_p, z_new)`` like ``ref.col_inner_step_ref``; ``z_new`` is ``z_p``
    itself when ``update_z`` is False. ``c_p`` is the same bits run to run.
    ``par`` and ``n_mask`` are device tensors, read by the kernel: the
    wrapper computes nothing from them on the host."""
    b, p, m, np_, stride, batched = _stack(a_cp, x, x_rank=2,
                                              dims="(P, M, Np)")
    dev = a_cp.device
    lead = (b,) if batched else ()
    for t, name in ((x, "x"), (x0, "x0")):
        _f32(t, lead + (p, np_), name, dev)
    _f32(z_p, lead + (p, m), "z_p", dev)
    _f32(g, lead + (m,), "g", dev)
    par_stride = _per_instance(par, "par", 4, b, batched, dev)
    mask_stride = 0 if n_mask is None else _per_instance(
        n_mask, "n_mask", np_, b, batched, dev)
    chunk = row_chunk(dev, b * p, m, np_, a_cp.dtype)
    n_chunks = -(-m // chunk)
    fpart = torch.empty((b * p, n_chunks, np_), dtype=torch.float32,
                        device=dev)
    sspart = torch.empty((b * p, n_chunks), dtype=torch.float32, device=dev)
    x_new = torch.empty_like(x)
    c_p = torch.empty(lead + (p,), dtype=torch.float32, device=dev)
    z_new = torch.empty_like(z_p) if update_z else z_p
    vec = _vec_flag(np_, a_cp, x0, x_new)
    plan = _ring_plan(dev, b, p, m, np_, a_cp.dtype, vec)
    with torch.cuda.device(dev):
        code = _library().col_inner_launch(
            a_cp.data_ptr(), int(a_cp.dtype == torch.bfloat16), stride,
            x.data_ptr(), x0.data_ptr(), z_p.data_ptr(), g.data_ptr(),
            None if n_mask is None else n_mask.data_ptr(), mask_stride,
            par.data_ptr(), par_stride,
            fpart.data_ptr(), sspart.data_ptr(), x_new.data_ptr(),
            c_p.data_ptr(), z_new.data_ptr(), b, p, m, np_, chunk, Z_WARPS,
            int(update_z), vec, *plan, torch.cuda.current_stream().cuda_stream)
    check("amp_col", code, "col_inner_launch")
    launch_counts["col_inner"] += 1
    return x_new, c_p, z_new
