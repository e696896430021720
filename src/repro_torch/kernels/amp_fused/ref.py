"""Plain PyTorch versions of the fused AMP local-computation kernels.

These are what the CUDA kernels of ``csrc/amp_local.cu`` (row layout) and
``csrc/amp_col.cu`` (column layout) are held against, and what runs when
the tensors lie on the CPU. Every function takes an optional leading batch
dimension B, written out (the JAX package gets it from ``vmap``). Row
layout: ``a_p`` is ``(P, Mp, N)`` shared by the batch or ``(B, P, Mp, N)``;
``x`` is ``(N,)`` or ``(B, N)``; ``y_p``/``z_p`` are ``(P, Mp)`` or
``(B, P, Mp)``; ``onsager`` is a float, ``()`` or ``(B,)``. Column layout:
``a_cp`` is ``(P, M, Np)`` or ``(B, P, M, Np)``; ``x``/``x0`` ``(P, Np)`` or
``(B, P, Np)``; ``z_p`` ``(P, M)`` or ``(B, P, M)``; ``g`` ``(M,)`` or
``(B, M)``.
"""
from __future__ import annotations

import torch

__all__ = ["amp_local_ref", "amp_local_ref_grid", "amp_local_z_ref",
           "amp_local_f_ref", "col_residual_ref", "col_inner_step_ref"]


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


def col_residual_ref(a_cp, x):
    """Column-layout residual contributions ``r_p = A_p x_p``, (..., P, M)."""
    return torch.einsum("...pmn,...pn->...pm", a_cp.float(), x)


def col_inner_step_ref(a_cp, x, x0, z_p, g, n_mask, m_eff, eps, mu_s,
                       sigma_s2, update_z: bool):
    """One C-MP-AMP inner iteration (the engine's ``_col_inner`` body). Per
    processor p:

        s2_p = max(||z_p||^2 / m_eff, 1e-30)
        f_p  = x_p + A_p^T z_p
        x'   = eta(f_p; s2_p) * mask,  c_p = sum(eta' * mask) / m_eff
        z'   = g - A_p (x' - x0) + c_p z_p        (only when ``update_z``)

    ``eta`` is the closed-form Bernoulli-Gauss conditional mean with its
    derivative (``core.denoisers.eta_bg_and_deriv``); the 1e-30 floor is
    the TPU kernel's. Returns ``(x_new, c_p, z_new)`` with ``z_new = z_p``
    when the update is skipped (the final inner iteration: ``z_p`` is the
    residual that fed the denoise, which the Onsager boundary carry needs).
    """
    # imported here: core.engine imports this module, so a module-level
    # import of core would be circular
    from ...core.denoisers import eta_bg_and_deriv

    a32 = a_cp.float()
    s2_p = torch.clamp(torch.sum(z_p * z_p, dim=-1, keepdim=True) / m_eff,
                       min=1e-30)
    f_p = x + torch.einsum("...pmn,...pm->...pn", a32, z_p)
    val, deriv = eta_bg_and_deriv(f_p, s2_p, eps, mu_s, sigma_s2)
    if n_mask is not None:
        val = val * n_mask
        deriv = deriv * n_mask
    c_p = torch.sum(deriv, dim=-1) / m_eff
    if not update_z:
        return val, c_p, z_p
    z_new = (g[..., None, :]
             - torch.einsum("...pmn,...pn->...pm", a32, val - x0)
             + c_p[..., None] * z_p)
    return val, c_p, z_new
