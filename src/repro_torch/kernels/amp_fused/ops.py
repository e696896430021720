"""Dispatch for the fused AMP LC steps of both layouts: the device of the
tensors decides.

A CUDA tensor goes to the hand-written kernels (``amp_fused.py``) and either
launches or raises; a CPU tensor goes to the plain versions (``ref.py``).
There is no switch and no fallback from one to the other.

The CUDA kernels mask their own ragged edges, so unlike the TPU kernels they
need no tile-aligned operands: ``pad_row_shards`` / ``pad_col_shards`` are
kept as the public places where alignment would happen at solve entry, and
are the identity.
The invariant it stood for stays: the (M, N)-sized operand is never padded
or copied inside the iteration loop.
"""
from __future__ import annotations

import torch

from .amp_fused import (BAND_THREADS, F_THREADS, Z_WARPS, amp_local_cuda_grid,
                        rows_per_stage, single_read, vec_width)
from .col import col_inner_cuda, col_residual_cuda, col_stage_rows
from .ref import (amp_local_ref, amp_local_ref_grid, col_inner_step_ref,
                  col_residual_ref)

__all__ = ["amp_local_step", "amp_local_grid", "row_tiles", "pad_row_shards",
           "col_residual", "col_inner_step", "col_tiles", "pad_col_shards"]


def row_tiles(mp: int, n: int, a_dtype: torch.dtype = torch.float32):
    """(bm, bn) of the CUDA kernels for a (P, Mp, N) row-shard stack. Single
    read (``single_read``): rows of A a stage of the band kernel holds, and
    the columns one sweep of its threads covers (threads times the vector
    width N allows). Two-pass (wider N): rows per z-pass block (one warp a
    row) and columns per f-pass block. Ragged edges are masked, so neither
    has to divide its dimension."""
    if single_read(n, a_dtype):
        return rows_per_stage(n), BAND_THREADS * vec_width(n, a_dtype)
    return Z_WARPS, F_THREADS * vec_width(n, a_dtype)


def pad_row_shards(a_p, y_p):
    """Alignment of a (..., P, Mp, N) row-shard stack at solve entry.

    Nothing needs aligning for the CUDA kernels (they mask ragged edges and
    take scalar loads when N is not a multiple of the vector width), so the
    inputs come back unchanged."""
    return a_p, y_p


def col_tiles(np_: int, a_dtype: torch.dtype = torch.float32):
    """(bm, bn) of the CUDA column kernels for a (P, M, Np) stack: rows of A
    a stage of the row pass's ring holds (``col.col_stage_rows``; without a
    ring, one warp a row, ``Z_WARPS`` rows a block) and columns per A^T z
    block (M is split over blocks as well, ``col.row_chunk``). Ragged edges
    are masked."""
    return (col_stage_rows(np_, a_dtype) or Z_WARPS,
            F_THREADS * vec_width(np_, a_dtype))


def pad_col_shards(a_cp, y):
    """Alignment of a (..., P, M, Np) column-shard stack and its shared y at
    solve entry: nothing needs aligning, the inputs come back unchanged."""
    return a_cp, y


def col_residual(a_cp, x):
    """Column-layout residual contributions ``r_p = A_p x_p`` (..., P, M)."""
    if a_cp.is_cuda:
        return col_residual_cuda(a_cp, x)
    return col_residual_ref(a_cp, x)


def col_inner_step(a_cp, x, x0, z_p, g, n_mask, m_eff, eps, mu_s, sigma_s2,
                   update_z: bool):
    """One fused C-MP-AMP inner iteration (message + denoise + optional
    residual update); ``ref.col_inner_step_ref`` states the function.
    ``n_mask`` is a (Np,) 0/1 mask of real columns, or None."""
    if a_cp.is_cuda:
        return col_inner_cuda(a_cp, x, x0, z_p, g, n_mask, m_eff, eps, mu_s,
                              sigma_s2, update_z)
    return col_inner_step_ref(a_cp, x, x0, z_p, g, n_mask, m_eff, eps, mu_s,
                              sigma_s2, update_z)


def amp_local_grid(a_p, x, y_p, z_p, onsager, n_proc: int):
    """Fused LC step over the whole (P, Mp, N) shard stack, optionally with
    a leading batch dimension (``ref.py`` for shapes).

    Returns ``(z_new, f_p, ss)`` — ``ss`` the fused sigma2_hat numerator
    ``sum(z_new**2)`` per batch entry. A may be bfloat16 (widened in the
    kernel / by the plain version; sums are float32)."""
    if a_p.is_cuda:
        return amp_local_cuda_grid(a_p, x, y_p, z_p, onsager, n_proc)
    return amp_local_ref_grid(a_p, x, y_p, z_p, onsager, n_proc)


def amp_local_step(a, x, y, z, onsager, n_proc: int):
    """Fused z'/f computation for one processor's LC step (v1 signature:
    a single (M, N) shard, ``n_proc`` only scales x)."""
    if not a.is_cuda:
        return amp_local_ref(a, x, y, z, onsager, n_proc)
    z_new, f_p, _ = amp_local_cuda_grid(a[None], x, y[None], z[None],
                                        onsager, n_proc)
    return z_new[0], f_p[0]
