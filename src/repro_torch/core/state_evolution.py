"""State evolution (SE) for centralized and quantized multi-processor AMP.

Centralized SE (paper eq. 4):
    sigma_{t+1}^2 = sigma_e^2 + (1/kappa) * mmse(sigma_t^2)
with  sigma_0^2 = sigma_e^2 + E[S0^2]/kappa.

Quantized SE (paper eq. 8): the fusion sum of P independently-quantized
messages adds ~N(0, P*sigma_Q^2), so the denoiser sees effective variance
sigma_t^2 + P*sigma_Q^2:
    sigma_{t+1}^2 = sigma_e^2 + (1/kappa) * mmse(sigma_t^2 + P*sigma_Q^2).

Column-wise two-stage SE (C-MP-AMP, arXiv:1701.02578; DESIGN.md §7): each
processor owns N/P signal columns and the fusion exchanges residual
contributions r^p = A_p x_p (length M).  With d^s the per-entry block MSE
after outer round s and sigma_q2[s] the per-processor quantization MSE on
the exchanged residuals, the fused residual g^s has variance

    tau^{s,0} = sigma_e^2 + P*sigma_q2[s] + (1/kappa) * d^{s-1}          (fusion stage)

and the inner (per-processor) recursion freezes the other blocks' errors
while the own-block term e updates:

    tau^{s,t} = tau^{s,0} + (e_t - d^{s-1}) / (kappa * P)
    e_{t+1}   = mmse(tau^{s,t}),   e_0 = d^{s-1},   d^s = e_{t_inner}.

At n_inner = 1 the round map collapses to the centralized recursion with
the quantization noise entering *additively on the fused residual*:
tau^{s+1} = sigma_e^2 + P*sigma_q2[s+1] + mmse(tau^s)/kappa.

Erasure-extended SE (DESIGN.md §10): when each processor's fusion packet is
lost i.i.d. with probability p and the fusion center rescales the k
survivors by P/k (the transport's unbiased survivor rescale), both the
message noise and the survivors' embedded quantization noise are amplified
by P/k.  Taking the expectation over k ~ Binomial(P, 1-p),

    sigma_{t+1}^2 = sigma_e^2
        + mmse( amp * (sigma_t^2 + P*sigma_Q^2) ) / kappa,
    amp = E[ P / max(k, 1) ]      (``erasure_amplification``),

where the k = 0 event (all packets lost, the fused message collapses to
zero) is folded in through the max.  Column-layout erasure is a *reset*,
not a rescale (an erased contribution leaves its whole signal block
unexplained in g): the block MSE entering a round averages to
(1-p) * d + p * E[S0^2] and only the (1-p) fraction of survivors injects
quantization noise.  Bursty (Gilbert-Elliott) losses share the same
single-round marginals at the stationary loss rate; their temporal
correlation is not tracked here (bursty-loss DP tables are a named
follow-up in ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .denoisers import BernoulliGauss, mmse

__all__ = ["CSProblem", "se_trajectory", "se_trajectory_quantized",
           "se_trajectory_col", "erasure_amplification",
           "se_trajectory_erasure", "sdr", "steady_state_iters",
           "sigma_e2_for_snr", "PAPER_T"]


@dataclasses.dataclass(frozen=True)
class CSProblem:
    """Compressed-sensing problem spec (paper Sec. 4): y = A s0 + e."""

    n: int = 10_000
    m: int = 3_000
    prior: BernoulliGauss = dataclasses.field(default_factory=BernoulliGauss)
    snr_db: float = 20.0

    @property
    def kappa(self) -> float:
        return self.m / self.n

    @property
    def rho(self) -> float:
        """E[||s0||^2]/(N*kappa); equals eps/kappa when mu_s=0, sigma_s=1."""
        return self.prior.second_moment / self.kappa

    @property
    def sigma_e2(self) -> float:
        return sigma_e2_for_snr(self.snr_db, self.rho)

    @property
    def sigma0_2(self) -> float:
        """Initial SE variance (x_0 = 0)."""
        return self.sigma_e2 + self.prior.second_moment / self.kappa


def sigma_e2_for_snr(snr_db: float, rho: float) -> float:
    """Invert SNR = 10 log10(rho / sigma_e^2)."""
    return rho / (10.0 ** (snr_db / 10.0))


def sdr(sigma_t2, prob: CSProblem) -> np.ndarray:
    """Signal-to-distortion ratio SDR(t) = 10 log10(rho / (sigma_t^2 - sigma_e^2))."""
    sigma_t2 = np.asarray(sigma_t2, dtype=np.float64)
    return 10.0 * np.log10(prob.rho / np.maximum(sigma_t2 - prob.sigma_e2, 1e-300))


def se_trajectory(prob: CSProblem, n_iter: int, mmse_fn=None) -> np.ndarray:
    """Centralized SE: returns [sigma_0^2, ..., sigma_T^2] (length n_iter+1)."""
    if mmse_fn is None:
        mmse_fn = lambda v: mmse(v, prob.prior)
    out = [prob.sigma0_2]
    for _ in range(n_iter):
        out.append(prob.sigma_e2 + float(mmse_fn(np.asarray([out[-1]]))[0]) / prob.kappa)
    return np.asarray(out)


def se_trajectory_quantized(prob: CSProblem, sigma_q2: np.ndarray, n_proc: int,
                            mmse_fn=None) -> np.ndarray:
    """Quantized SE (eq. 8) for a per-iteration quantizer-MSE schedule.

    ``sigma_q2[t]`` is the per-processor quantization MSE applied at iteration
    t (0-indexed); the fusion sum injects n_proc * sigma_q2[t].
    """
    if mmse_fn is None:
        mmse_fn = lambda v: mmse(v, prob.prior)
    sigma_q2 = np.asarray(sigma_q2, dtype=np.float64)
    out = [prob.sigma0_2]
    for t in range(len(sigma_q2)):
        eff = out[-1] + n_proc * sigma_q2[t]
        out.append(prob.sigma_e2 + float(mmse_fn(np.asarray([eff]))[0]) / prob.kappa)
    return np.asarray(out)


def erasure_amplification(rate: float, n_proc: int) -> float:
    """E[P / max(k, 1)] for k ~ Binomial(P, 1 - rate): the expected noise
    amplification of the P/k survivor rescale at the fusion center.

    Exact binomial sum (P is small — tens of processors). ``rate = 0``
    returns exactly 1.0, so erasure-aware formulas degrade to the
    published SE without even a float rounding difference.
    """
    if rate <= 0.0:
        return 1.0
    assert 0.0 <= rate < 1.0, rate
    p_keep = 1.0 - rate
    amp = 0.0
    for k in range(n_proc + 1):
        pmf = math.comb(n_proc, k) * p_keep**k * rate**(n_proc - k)
        amp += pmf * n_proc / max(k, 1)
    return amp


def se_trajectory_erasure(prob: CSProblem, sigma_q2, n_proc: int,
                          erasure_rate: float, mmse_fn=None) -> np.ndarray:
    """Row-layout quantized SE under Bernoulli per-processor erasure.

    Each iteration the denoiser input variance is amplified by
    ``erasure_amplification`` (module docstring): survivors are rescaled
    by P/k, inflating both the message noise and the surviving
    quantization noise.  ``erasure_rate = 0`` reproduces
    ``se_trajectory_quantized`` exactly.  Gilbert-Elliott losses are
    evaluated at their stationary rate (marginals match; temporal
    correlation untracked).
    """
    if mmse_fn is None:
        mmse_fn = lambda v: mmse(v, prob.prior)
    sigma_q2 = np.asarray(sigma_q2, dtype=np.float64)
    amp = erasure_amplification(erasure_rate, n_proc)
    out = [prob.sigma0_2]
    for t in range(len(sigma_q2)):
        eff = amp * (out[-1] + n_proc * sigma_q2[t])
        out.append(prob.sigma_e2 + float(mmse_fn(np.asarray([eff]))[0]) / prob.kappa)
    return np.asarray(out)


def se_trajectory_col(prob: CSProblem, n_proc: int, n_outer: int,
                      n_inner: int = 1, sigma_q2=None, mmse_fn=None,
                      erasure_rate: float = 0.0):
    """Two-stage column-wise SE (module docstring). Returns ``(tau, d)``.

    ``tau[s]`` is the start-of-round variance of the fused residual g^s
    (``s = 0..n_outer-1``, quantization noise of round s included) —
    the quantity the engine's plug-in ``||g^s||^2/M`` estimates.  ``d[s]``
    is the per-entry block MSE entering round s (``d[0] = E[S0^2]``,
    ``d[s+1]`` = MSE of the estimate after round s, length n_outer+1).

    ``sigma_q2[s]`` is the per-processor quantizer MSE on the exchanged
    residual contributions at round s (entry 0 is conventionally 0: the
    round-0 contributions are identically zero, so their exchange is exact
    at any bin size).  ``None`` means lossless fusion throughout.

    ``erasure_rate`` models per-round, per-processor Bernoulli erasure of
    the residual contributions with the engine's *reset* semantics
    (module docstring): an erased block restarts from x = 0, so the block
    MSE entering the round averages to (1-p)*d + p*E[S0^2] and only the
    surviving (1-p) fraction injects quantization noise.  ``0.0``
    reproduces the lossless-link recursion exactly.
    """
    if mmse_fn is None:
        mmse_fn = lambda v: mmse(v, prob.prior)
    if sigma_q2 is None:
        sigma_q2 = np.zeros(n_outer)
    sigma_q2 = np.asarray(sigma_q2, dtype=np.float64)
    assert len(sigma_q2) == n_outer, (len(sigma_q2), n_outer)
    assert 0.0 <= erasure_rate < 1.0, erasure_rate
    p_e = erasure_rate
    sm = prob.prior.second_moment
    kappa = prob.kappa
    d = [sm]
    tau = []
    for s in range(n_outer):
        d_in = d[-1] if p_e == 0.0 else (1.0 - p_e) * d[-1] + p_e * sm
        tau_s0 = (prob.sigma_e2 + (1.0 - p_e) * n_proc * sigma_q2[s]
                  + d_in / kappa)
        tau.append(tau_s0)
        e = d_in
        tau_t = tau_s0
        for _ in range(n_inner):
            e = float(mmse_fn(np.asarray([tau_t]))[0])
            tau_t = tau_s0 + (e - d_in) / (kappa * n_proc)
        d.append(e)
    return np.asarray(tau), np.asarray(d)


# Steady-state horizons as stated in the paper (Sec. 4, Fig. 1). Our SE with
# the corrected MMSE quadrature reads off 8/10/18 at a 0.15 dB threshold —
# the eps=0.1 curve's last ~2 iterations gain <0.15 dB each, a visual-read
# ambiguity; Table-1 reproduction adopts the paper's own T values.
PAPER_T = {0.03: 8, 0.05: 10, 0.10: 20}


def steady_state_iters(prob: CSProblem, tol_db: float = 0.15, max_iter: int = 200,
                       mmse_fn=None) -> int:
    """Iterations until the SDR gain per iteration drops below ``tol_db``."""
    if mmse_fn is None:
        mmse_fn = lambda v: mmse(v, prob.prior)
    prev = prob.sigma0_2
    prev_sdr = sdr(prev, prob)
    for t in range(1, max_iter + 1):
        cur = prob.sigma_e2 + float(mmse_fn(np.asarray([prev]))[0]) / prob.kappa
        cur_sdr = sdr(cur, prob)
        if cur_sdr - prev_sdr < tol_db:
            # t-1 -> t gained < tol, so iteration t is the first one inside
            # the plateau; the paper counts it ("steady state after T itns").
            return t + 1 if t + 1 <= max_iter else t
        prev, prev_sdr = cur, cur_sdr
    return max_iter
