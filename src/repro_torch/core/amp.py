"""Centralized Bayesian AMP (paper Sec. 2, eqs. 1-3).

    f_t     = x_t + A^T z_t
    x_{t+1} = eta_t(f_t)
    z_{t+1} = y - A x_{t+1} + (N/M) * mean(eta_t'(f_t)) * z_t

The channel variance fed to the conditional-mean denoiser is the standard
plug-in estimate  sigma_hat_t^2 = ||z_t||^2 / M  [Bayati-Montanari; paper
Sec. 3.3], making the solver fully data-driven.

This is the P=1, lossless-fusion frontend of the unified ``core/engine.py``
solver: with one processor the LC/GC split reduces exactly to the
centralized recursion above, so the whole solve is one engine call.
``amp_iteration`` is kept as the public single-step API.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .denoisers import BernoulliGauss, eta_and_deriv
from .engine import AmpEngine, EngineConfig, ExactFusion

__all__ = ["AMPTrace", "amp_iteration", "amp_solve", "sample_problem"]


@dataclasses.dataclass
class AMPTrace:
    x: np.ndarray                # final estimate (N,)
    sigma2_hat: np.ndarray       # per-iteration plug-in variance (T,)
    mse: np.ndarray | None       # per-iteration MSE vs ground truth (T,) if s0 given


def amp_iteration(x, z, y, a_mat, prior: BernoulliGauss):
    """One centralized AMP iteration on tensors (plain PyTorch ops, any
    device). Returns (x_new, z_new, sigma2_hat)."""
    m = y.shape[0]
    n = x.shape[0]
    f = x + a_mat.T @ z
    sigma2_hat = torch.sum(z * z) / m
    x_new, deriv = eta_and_deriv(f, sigma2_hat, prior)
    z_new = y - a_mat @ x_new + (n / m) * deriv.mean() * z
    return x_new, z_new, sigma2_hat


def amp_solve(y, a_mat, prior: BernoulliGauss, n_iter: int,
              s0: np.ndarray | None = None, device: str = "cuda") -> AMPTrace:
    """Run centralized AMP for ``n_iter`` iterations (one engine solve) on
    ``device``; ``y``/``a_mat`` are numpy arrays or tensors."""
    engine = AmpEngine(
        prior, EngineConfig(n_proc=1, n_iter=n_iter, collect_symbols=False,
                            collect_xs=s0 is not None, device=device),
        ExactFusion())
    trace = engine.solve(y, a_mat)
    mse = trace.mse(s0) if s0 is not None else None
    return AMPTrace(x=trace.x, sigma2_hat=trace.sigma2_hat, mse=mse)


def sample_problem(gen, n: int, m: int, prior: BernoulliGauss,
                   sigma_e2: float, device: str = "cuda"):
    """Draw (s0, A, y) per the paper's model: A_ij ~ N(0, 1/M),
    e ~ N(0, sigma_e^2). ``gen`` is a ``torch.Generator`` on ``device`` or
    an int seed for a new one. Returns float32 tensors on ``device``
    (nothing of the (M, N) matrix touches the host)."""
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    dev = gen.device
    support = torch.rand(n, generator=gen, device=dev) < prior.eps
    gauss = prior.mu_s + prior.sigma_s * torch.randn(n, generator=gen,
                                                     device=dev)
    s0 = torch.where(support, gauss, torch.zeros_like(gauss))
    a = torch.randn(m, n, generator=gen, device=dev) / math.sqrt(m)
    e = math.sqrt(sigma_e2) * torch.randn(m, generator=gen, device=dev)
    y = a @ s0 + e
    return s0, a, y
