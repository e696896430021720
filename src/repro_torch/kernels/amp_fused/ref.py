"""Plain PyTorch versions of the fused AMP local-computation kernels.

These are what the CUDA kernels of ``csrc/amp_local.cu`` are held against,
and what runs when the tensors lie on the CPU. Every function takes an
optional leading batch dimension B, written out (the JAX package gets it
from ``vmap``): ``a_p`` is ``(P, Mp, N)`` shared by the batch or
``(B, P, Mp, N)``; ``x`` is ``(N,)`` or ``(B, N)``; ``y_p``/``z_p`` are
``(P, Mp)`` or ``(B, P, Mp)``; ``onsager`` is a float, ``()`` or ``(B,)``.
"""
from __future__ import annotations

import torch

__all__ = ["amp_local_ref", "amp_local_ref_grid", "amp_local_z_ref",
           "amp_local_f_ref"]


def amp_local_ref(a, x, y, z, onsager, n_proc: int):
    """Paper Sec. 3.1 LC step for one processor:

        z' = y - A x + onsager * z
        f  = x / P + A^T z'

    a: (M, N); x: (N,); y, z: (M,). Returns (z', f)."""
    z_new = y - a @ x + onsager * z
    f = x / n_proc + a.T @ z_new
    return z_new, f


def _ons(onsager, z_p):
    """Onsager coefficient shaped to broadcast against z_p."""
    if isinstance(onsager, torch.Tensor) and onsager.ndim == 1:
        return onsager[:, None, None]
    return onsager


def amp_local_z_ref(a_p, x, y_p, z_p, onsager):
    """z-pass: ``z' = y_p - A_p x + onsager z_p`` and ``ss = sum(z'^2)``
    over (P, Mp), per batch entry. ``a_p`` may be bfloat16: it is widened to
    float32 before the contraction (bf16 storage, f32 accumulation)."""
    a32 = a_p.float()
    z_new = y_p - torch.einsum("...pmn,...n->...pm", a32, x) \
        + _ons(onsager, z_p) * z_p
    return z_new, torch.sum(z_new * z_new, dim=(-2, -1))


def amp_local_f_ref(a_p, z_new, x, n_proc: int):
    """f-pass: ``f_p = x / P + A_p^T z'``, shape (..., P, N)."""
    a32 = a_p.float()
    return x[..., None, :] / n_proc \
        + torch.einsum("...pmn,...pm->...pn", a32, z_new)


def amp_local_ref_grid(a_p, x, y_p, z_p, onsager, n_proc: int):
    """LC step over the full processor stack (module docstring for shapes).

    Returns ``(z_new (..., P, Mp), f_p (..., P, N), ss (...,))`` with
    ``ss = sum(z_new**2)``, the sigma2_hat numerator.
    """
    z_new, ss = amp_local_z_ref(a_p, x, y_p, z_p, onsager)
    return z_new, amp_local_f_ref(a_p, z_new, x, n_proc), ss
