"""Bayesian denoisers for AMP.

The paper (Sec. 2) assumes a Bernoulli-Gaussian prior

    p_{S0}(s) = eps * N(s; mu_s, sigma_s^2) + (1 - eps) * delta(s)

observed through the AMP scalar channel F = S0 + sigma * Z, Z ~ N(0,1).
The MMSE denoiser is the conditional mean  eta(f) = E[S0 | S0 + sigma Z = f]
(paper eq. 5), which has the closed form

    eta(f) = pi(f) * (mu_s * sigma^2 + f * sigma_s^2) / (sigma_s^2 + sigma^2)

with spike/slab responsibility

    pi(f) = sigmoid( logit(eps) + log N(f; mu_s, sigma_s^2 + sigma^2)
                               - log N(f; 0, sigma^2) ).

Everything is written against an array-namespace argument ``xp`` so the same
formulas serve (a) the torch AMP loop on the device (``xp=tnp``, the default:
a small torch namespace defined below) and (b) fast numpy host-side table
building for state evolution / rate allocation (``xp=np``).

The derivative the Onsager term needs is the closed form
``eta_bg_and_deriv``; nothing here differentiates automatically (a test pins
the closed form against ``torch.autograd``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "BernoulliGauss",
    "eta",
    "eta_bg",
    "eta_bg_and_deriv",
    "eta_and_deriv",
    "mmse",
    "make_mmse_interp",
    "tnp",
]


class _TorchNamespace:
    """The handful of array functions the denoiser formulas use, on torch
    tensors. Python scalars go through ``math`` so prior parameters given
    as floats never become tensors on the wrong device."""

    @staticmethod
    def _unary(t_fn, m_fn, x):
        return t_fn(x) if isinstance(x, torch.Tensor) else m_fn(x)

    def log(self, x):
        return self._unary(torch.log, math.log, x)

    def log1p(self, x):
        return self._unary(torch.log1p, math.log1p, x)

    def exp(self, x):
        return self._unary(torch.exp, math.exp, x)

    def abs(self, x):
        return self._unary(torch.abs, abs, x)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def asarray(x, dtype=None, like=None):
        dev = like.device if isinstance(like, torch.Tensor) else None
        return torch.as_tensor(x, dtype=dtype, device=dev)


tnp = _TorchNamespace()


@dataclasses.dataclass(frozen=True)
class BernoulliGauss:
    """Bernoulli-Gaussian prior (paper eq. 6)."""

    eps: float = 0.1
    mu_s: float = 0.0
    sigma_s: float = 1.0

    @property
    def second_moment(self) -> float:
        """E[S0^2] = eps * (mu_s^2 + sigma_s^2)."""
        return self.eps * (self.mu_s**2 + self.sigma_s**2)

    def scaled(self, a: float) -> "BernoulliGauss":
        """Prior of a*S0."""
        return BernoulliGauss(self.eps, a * self.mu_s, abs(a) * self.sigma_s)


def _log_norm_pdf(xp, x, mu, var):
    return -0.5 * ((x - mu) ** 2 / var) - 0.5 * xp.log(2.0 * math.pi * var)


def _sigmoid(xp, x):
    # numerically stable logistic for both numpy and torch (no overflow branches)
    e = xp.exp(-xp.abs(x))
    return xp.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


def eta_bg(f, sigma2, eps, mu_s, sigma_s2, xp=tnp):
    """``eta`` with *array-valued* prior parameters.

    Identical formula to ``eta`` but every prior parameter may be a tensor
    (broadcast against ``f``), so one batched solve can serve per-instance
    priors. Requires 0 < eps < 1.
    """
    log_g1 = _log_norm_pdf(xp, f, mu_s, sigma_s2 + sigma2)
    log_g0 = _log_norm_pdf(xp, f, 0.0, sigma2)
    logit_eps = xp.log(eps) - xp.log1p(-eps)
    pi = _sigmoid(xp, logit_eps + log_g1 - log_g0)
    cond_mean = (mu_s * sigma2 + f * sigma_s2) / (sigma_s2 + sigma2)
    return pi * cond_mean


def eta_bg_and_deriv(f, sigma2, eps, mu_s, sigma_s2, xp=tnp):
    """Closed-form ``(eta_bg(f), eta_bg'(f))`` — no autodiff.

    The derivative of the conditional mean ``eta = pi(f) * cm(f)``:

        cm  = (mu_s sigma2 + f sigma_s2) / (sigma_s2 + sigma2)
        L   = logit(eps) + log N(f; mu_s, sigma_s2+sigma2) - log N(f; 0, sigma2)
        eta'= pi (1-pi) L'(f) cm + pi sigma_s2/(sigma_s2+sigma2),
        L'  = f/sigma2 - (f - mu_s)/(sigma_s2 + sigma2).

    This is what the engine's Onsager coefficient uses; pinned elementwise
    against ``torch.autograd`` of ``eta_bg`` in tests/test_torch_theory.py.
    Parameters may be floats or tensors.
    """
    v1 = sigma_s2 + sigma2
    log_g1 = _log_norm_pdf(xp, f, mu_s, v1)
    log_g0 = _log_norm_pdf(xp, f, 0.0, sigma2)
    lo = xp.log(eps) - xp.log1p(-eps) + log_g1 - log_g0
    pi = _sigmoid(xp, lo)
    cm = (mu_s * sigma2 + f * sigma_s2) / v1
    d_lo = f / sigma2 - (f - mu_s) / v1
    val = pi * cm
    deriv = pi * (1.0 - pi) * d_lo * cm + pi * (sigma_s2 / v1)
    return val, deriv


def eta(f, sigma2, prior: BernoulliGauss, xp=tnp):
    """Conditional-mean denoiser E[S0 | F=f] for channel variance ``sigma2``."""
    eps, mu, s2 = prior.eps, prior.mu_s, prior.sigma_s**2
    if isinstance(f, torch.Tensor):
        sigma2 = tnp.asarray(sigma2, dtype=f.dtype, like=f)
    elif hasattr(f, "dtype"):
        sigma2 = xp.asarray(sigma2, dtype=f.dtype)
    log_g1 = _log_norm_pdf(xp, f, mu, s2 + sigma2)
    log_g0 = _log_norm_pdf(xp, f, 0.0, sigma2)
    logit_eps = math.log(eps) - math.log1p(-eps) if 0.0 < eps < 1.0 else (math.inf if eps >= 1.0 else -math.inf)
    pi = _sigmoid(xp, logit_eps + log_g1 - log_g0)
    cond_mean = (mu * sigma2 + f * s2) / (s2 + sigma2)
    return pi * cond_mean


def eta_and_deriv(f, sigma2, prior: BernoulliGauss, xp=tnp):
    """eta(f) and the elementwise derivative eta'(f), in closed form.

    AMP's Onsager term (paper eq. 3) needs mean(eta'(f)). Requires
    0 < eps < 1 (the closed form divides by neither, but logit(eps) must be
    finite for the derivative to be meaningful).
    """
    if isinstance(f, torch.Tensor):
        sigma2 = tnp.asarray(sigma2, dtype=f.dtype, like=f)
    return eta_bg_and_deriv(f, sigma2, prior.eps, prior.mu_s,
                            prior.sigma_s**2, xp=xp)


_GH_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _gauss_hermite(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes/weights for E[h(X)], X~N(0,1) (probabilists' Hermite)."""
    if n not in _GH_CACHE:
        x, w = np.polynomial.hermite_e.hermegauss(n)
        _GH_CACHE[n] = (x, w / math.sqrt(2.0 * math.pi))
    return _GH_CACHE[n]


def mmse(sigma2, prior: BernoulliGauss, n_nodes: int = 4001) -> np.ndarray:
    """MMSE of the scalar channel  E[(eta(S0 + sigma Z) - S0)^2].

    Vectorized over an array of channel variances ``sigma2`` (host-side,
    numpy). This is the kernel of state evolution (paper eqs. 4 and 8).

    Uses the conditional-mean identity  mmse = E[S0^2] - E[eta(F)^2]  so only
    a single smooth 1D integral over the marginal p_F is needed. The marginal
    has two scales (spike width ~sigma, slab width ~sigma_G), so the grid is
    the union of dense windows at both scales (n_nodes points each).
    """
    sigma2 = np.atleast_1d(np.asarray(sigma2, dtype=np.float64))
    e_s2 = prior.second_moment
    eps, mu, s2s = prior.eps, prior.mu_s, prior.sigma_s**2
    out = np.empty_like(sigma2)
    for i, v in enumerate(sigma2):
        sg = math.sqrt(v)
        sg_g = math.sqrt(s2s + v)
        inner = np.linspace(-14 * sg, 14 * sg, n_nodes)
        outer = np.linspace(mu - 14 * sg_g, mu + 14 * sg_g, n_nodes)
        f = np.unique(np.concatenate([inner, outer]))
        p_f = (eps * np.exp(-0.5 * (f - mu) ** 2 / (s2s + v))
               / math.sqrt(2 * math.pi * (s2s + v))
               + (1 - eps) * np.exp(-0.5 * f * f / v)
               / math.sqrt(2 * math.pi * v))
        ef = eta(f, v, prior, xp=np)
        out[i] = max(e_s2 - float(np.trapezoid(ef * ef * p_f, f)), 1e-300)
    return out


def make_mmse_interp(prior: BernoulliGauss, v_min: float = 1e-9, v_max: float = 1e3,
                     n_grid: int = 400):
    """Precompute mmse() on a log grid and return a fast vectorized interpolant.

    Rate allocation (DP) evaluates the SE map ~1e6 times; quadrature each call
    would dominate, so we build log-log linear interpolation once. mmse is
    smooth and monotone in the channel variance, making this accurate to
    <0.1% at 400 points.
    """
    grid_v = np.geomspace(v_min, v_max, n_grid)
    grid_m = mmse(grid_v, prior)
    log_v, log_m = np.log(grid_v), np.log(np.maximum(grid_m, 1e-300))

    def interp(v):
        v = np.asarray(v, dtype=np.float64)
        lv = np.log(np.clip(v, v_min, v_max))
        return np.exp(np.interp(lv, log_v, log_m))

    return interp
