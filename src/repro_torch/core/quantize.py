"""Uniform (midtread) scalar quantization + ECSQ rate model (paper Sec. 3.2).

The per-processor fusion message obeys the scalar channel
    F_t^p = S0/P + (sigma_t/sqrt(P)) Z_p,
i.e. the Gaussian mixture
    F_t^p ~ eps * N(mu_s/P, (sigma_s^2 + P sigma_t^2)/P^2)
          + (1-eps) * N(0, sigma_t^2/P).

A midtread uniform quantizer with bin size Delta has
    q(f) = Delta * round(f / Delta),    sigma_Q^2 = Delta^2 / 12,
and (Widrow; paper's bandlimited-characteristic-function argument) the error is
~U[-Delta/2, Delta/2] and uncorrelated with F as long as
Delta <= 2 sigma_t / sqrt(P).

The ECSQ coding rate is the entropy H_Q of the quantized symbol; we compute it
from mixture CDF differences over the bins. All rate/entropy functions are
host-side numpy (they feed rate allocation); the quantizer itself runs on
torch tensors inside MP-AMP (``torch.round`` rounds half to even, as
``numpy.round`` does).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy.special import ndtr  # Gaussian CDF, vectorized

from .denoisers import BernoulliGauss

__all__ = [
    "GaussMixture",
    "message_mixture",
    "residual_mixture",
    "quantize_midtread",
    "dequantize_midtread",
    "ecsq_entropy",
    "delta_for_rate_ecsq",
    "delta_for_sigma_q2",
    "HIGH_RATE_ECSQ_GAP_BITS",
]

# High-rate gap between ECSQ entropy and the RD function (Gersho & Gray;
# = 0.5*log2(2*pi*e/12) ~ 0.2546 bits). The paper rounds to 0.255.
HIGH_RATE_ECSQ_GAP_BITS = 0.5 * math.log2(2.0 * math.pi * math.e / 12.0)


@dataclasses.dataclass(frozen=True)
class GaussMixture:
    """Two-component Gaussian mixture sum_k w_k N(mu_k, var_k)."""

    w: tuple[float, ...]
    mu: tuple[float, ...]
    var: tuple[float, ...]

    @property
    def mean(self) -> float:
        return sum(wk * mk for wk, mk in zip(self.w, self.mu))

    @property
    def variance(self) -> float:
        m = self.mean
        return sum(wk * (vk + (mk - m) ** 2) for wk, mk, vk in zip(self.w, self.mu, self.var))

    def cdf(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)[..., None]
        mu = np.asarray(self.mu)
        sd = np.sqrt(np.asarray(self.var))
        return (np.asarray(self.w) * ndtr((x - mu) / sd)).sum(-1)

    def std_span(self, k: float = 10.0) -> tuple[float, float]:
        lo = min(m - k * math.sqrt(v) for m, v in zip(self.mu, self.var))
        hi = max(m + k * math.sqrt(v) for m, v in zip(self.mu, self.var))
        return lo, hi


def message_mixture(prior: BernoulliGauss, sigma_t2: float, n_proc: int) -> GaussMixture:
    """Distribution of the per-processor message F_t^p (paper Sec. 3.2)."""
    p = float(n_proc)
    return GaussMixture(
        w=(prior.eps, 1.0 - prior.eps),
        mu=(prior.mu_s / p, 0.0),
        var=((prior.sigma_s**2 + p * sigma_t2) / p**2, sigma_t2 / p),
    )


def residual_mixture(prior: BernoulliGauss, block_mse: float, kappa: float,
                     n_proc: int) -> GaussMixture:
    """Distribution of one entry of the column-layout residual contribution
    r^p = A_p x_p (C-MP-AMP fusion payload, DESIGN.md §7).

    Each entry is a length-(N/P) inner product of i.i.d. N(0, 1/M) sensing
    rows with the block estimate, hence ~ N(0, ||x_p||^2/M); with block MSE
    ``d`` the estimator second moment is E[S0^2] - d (orthogonality), so

        Var r^p = (N/P) * (E[S0^2] - d) / M = (E[S0^2] - d) / (kappa * P).

    Returned as a (single-component) ``GaussMixture`` so the ECSQ entropy
    and bin-inversion helpers apply unchanged.
    """
    v_r = max(prior.second_moment - block_mse, 1e-30) / (kappa * n_proc)
    return GaussMixture(w=(1.0,), mu=(0.0,), var=(v_r,))


def quantize_midtread(x, delta, xp=torch):
    """Integer symbols of the midtread quantizer (round-half-even)."""
    return xp.round(x / delta)


def dequantize_midtread(q, delta):
    return q * delta


def ecsq_entropy(delta: np.ndarray, mix: GaussMixture) -> np.ndarray:
    """Entropy (bits/element) of the midtread-quantized mixture, vectorized over delta.

    Bin i covers [ (i-1/2) delta, (i+1/2) delta ); p_i from CDF differences.
    """
    delta = np.atleast_1d(np.asarray(delta, dtype=np.float64))
    lo, hi = mix.std_span(10.0)
    out = np.empty_like(delta)
    for k, d in enumerate(delta):
        i_lo = math.floor(lo / d) - 1
        i_hi = math.ceil(hi / d) + 1
        n_bins = i_hi - i_lo + 1
        if n_bins > 4_000_000:  # degenerate tiny delta; entropy ~ log2 span/d
            out[k] = math.log2((hi - lo) / d)
            continue
        edges = (np.arange(i_lo, i_hi + 2) - 0.5) * d
        cdf = mix.cdf(edges)
        p = np.diff(cdf)
        p = p[p > 1e-300]
        out[k] = float(-(p * np.log2(p)).sum())
    return out


def delta_for_sigma_q2(sigma_q2: float) -> float:
    """Bin size achieving quantizer MSE sigma_Q^2 = Delta^2/12."""
    return math.sqrt(12.0 * sigma_q2)


def delta_for_rate_ecsq(rate_bits: float, mix: GaussMixture,
                        tol: float = 1e-4) -> float:
    """Invert H_Q(Delta) = rate via bisection (H_Q is decreasing in Delta)."""
    sd = math.sqrt(mix.variance)
    lo, hi = sd * 2.0 ** (-40.0), sd * 2.0**12
    # make sure the bracket covers the target
    for _ in range(100):
        if ecsq_entropy(lo, mix)[0] < rate_bits:
            lo /= 4.0
        else:
            break
    for _ in range(100):
        if ecsq_entropy(hi, mix)[0] > rate_bits:
            hi *= 4.0
        else:
            break
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if ecsq_entropy(mid, mix)[0] > rate_bits:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1.0 + tol:
            break
    return math.sqrt(lo * hi)
