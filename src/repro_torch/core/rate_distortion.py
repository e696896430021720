"""Rate-distortion function of the MP-AMP fusion message, via Blahut-Arimoto.

The per-processor message is F_t^p = G/P with G = S0 + sigma' Z and
sigma' = sqrt(P) * sigma_t, so by the scaling property of RD functions under
squared-error distortion,

    R_{F^p}(D) = R_G(P^2 D)   and   D_{F^p}(R) = D_G(R) / P^2.

We therefore only ever tabulate the one-parameter family R_G(D; sigma')
(prior fixed), which the DP/BT allocators query thousands of times through a
bilinear interpolant in (log sigma', R).

Numerics: Blahut-Arimoto [Blahut'72, Arimoto'72] on a discretized source is
exact up to grid resolution, but saturates at the discrete entropy in the
high-rate limit. The Shannon lower bound

    D_SLB(R) = 2^{2 h(G)} 2^{-2R} / (2 pi e)

is asymptotically tight for this smooth mixture source, so we return
max(D_BA, D_SLB): in the BA-valid (low-rate) region D_BA >= D_SLB picks BA,
and where the grid can no longer resolve the distortion the SLB takes over.
Tests validate both against the closed-form Gaussian R(D).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os

import numpy as np

from .denoisers import BernoulliGauss

__all__ = ["ba_rd_curve", "gauss_mixture_entropy", "RDModel"]

_LN2 = math.log(2.0)


def _source_pdf(x: np.ndarray, prior: BernoulliGauss, sigma_p: float) -> np.ndarray:
    """pdf of G = S0 + sigma' Z (two-component Gaussian mixture)."""
    v1 = prior.sigma_s**2 + sigma_p**2
    v0 = sigma_p**2
    g1 = np.exp(-0.5 * (x - prior.mu_s) ** 2 / v1) / math.sqrt(2 * math.pi * v1)
    g0 = np.exp(-0.5 * x**2 / v0) / math.sqrt(2 * math.pi * v0)
    return prior.eps * g1 + (1 - prior.eps) * g0


def gauss_mixture_entropy(prior: BernoulliGauss, sigma_p: float,
                          n_grid: int = 20_001) -> float:
    """Differential entropy h(G) in bits, by quadrature."""
    span = prior.mu_s, math.sqrt(prior.sigma_s**2 + sigma_p**2)
    lo = min(-12 * sigma_p, span[0] - 12 * span[1])
    hi = max(12 * sigma_p, span[0] + 12 * span[1])
    x = np.linspace(lo, hi, n_grid)
    p = _source_pdf(x, prior, sigma_p)
    dx = x[1] - x[0]
    mask = p > 1e-300
    return float(-(p[mask] * np.log2(p[mask])).sum() * dx)


def ba_rd_curve(prior: BernoulliGauss, sigma_p: float, n_grid: int = 769,
                n_beta: int = 48, max_iter: int = 400, tol: float = 1e-7):
    """Blahut-Arimoto sweep -> (R bits, D) samples of R(D) for G = S0 + sigma' Z.

    Returns (R, D) arrays, R increasing, restricted to the grid-valid region
    D >= 30 * dx^2 (below that the discrete grid can't represent the
    reproduction density and the SLB branch of RDModel takes over).
    """
    var_g = prior.second_moment + sigma_p**2  # E[G^2] (mu offsets inside moments)
    hi = prior.mu_s + 8 * math.sqrt(prior.sigma_s**2 + sigma_p**2)
    lo = prior.mu_s - 8 * math.sqrt(prior.sigma_s**2 + sigma_p**2)
    lo, hi = min(lo, -8 * sigma_p), max(hi, 8 * sigma_p)
    x = np.linspace(lo, hi, n_grid)
    dx = x[1] - x[0]
    p = _source_pdf(x, prior, sigma_p)
    p = p / p.sum()

    d = (x[:, None] - x[None, :]) ** 2
    # beta ~ 1/(2 D): sweep distortions from ~var_g down past the grid-validity
    # floor (D ~ 30 dx^2); larger beta only produces points the filter drops.
    betas = np.geomspace(0.05 / var_g, 0.5 / (dx * dx), n_beta)
    q = p.copy()
    rates, dists = [], []
    for beta in betas:
        a = np.exp(-beta * d)
        for _ in range(max_iter):
            c = np.maximum(a @ q, 1e-300)
            t = a.T @ (p / c)
            q = np.maximum(q * t, 0.0)
            q = q / q.sum()
            mask = q > 1e-15
            if not mask.any() or np.abs(np.log(np.maximum(t[mask], 1e-300))).max() < tol:
                break
        c = np.maximum(a @ q, 1e-300)
        pc = p / c
        dist = float(pc @ ((a * d) @ q))
        rate = -beta * dist / _LN2 - float(p @ np.log2(np.maximum(c, 1e-300)))
        rates.append(max(rate, 0.0))
        dists.append(dist)
    r = np.asarray(rates)
    dv = np.asarray(dists)
    valid = dv >= 30.0 * dx * dx
    order = np.argsort(r[valid])
    return r[valid][order], dv[valid][order]


def _cache_dir() -> str:
    d = os.environ.get("REPRO_CACHE", os.path.join(os.path.dirname(__file__), "..", "..", "..", ".cache"))
    os.makedirs(d, exist_ok=True)
    return d


@dataclasses.dataclass
class RDModel:
    """Tabulated D_G(R; sigma') with disk cache, plus per-processor helpers.

    ``distortion_msg(rate, sigma_t2, n_proc)`` returns the quantization MSE
    sigma_Q^2 of one message F_t^p when coded at ``rate`` bits/element.
    """

    prior: BernoulliGauss
    sigma_min: float = 5e-3
    sigma_max: float = 8.0
    n_sigma: int = 25
    r_max: float = 12.0
    dr: float = 0.05
    n_grid: int = 769

    def __post_init__(self):
        self.sigmas = np.geomspace(self.sigma_min, self.sigma_max, self.n_sigma)
        self.r_grid = np.arange(0.0, self.r_max + self.dr / 2, self.dr)
        key = f"rd|{self.prior}|{self.sigma_min}|{self.sigma_max}|{self.n_sigma}|{self.r_max}|{self.dr}|{self.n_grid}|v3"
        h = hashlib.sha1(key.encode()).hexdigest()[:16]
        path = os.path.join(_cache_dir(), f"rd_{h}.npz")
        if os.path.exists(path):
            z = np.load(path)
            self.log_d = z["log_d"]
        else:
            self.log_d = self._build()
            np.savez(path, log_d=self.log_d)

    def _build(self) -> np.ndarray:
        """Hybrid D(R) table per sigma'.

        Low rate: Blahut-Arimoto (exact up to grid resolution). High rate
        (beyond BA's grid validity): the true D(R) is sandwiched between the
        Shannon lower bound (converse) and the ECSQ curve (achievable), and
        asymptotically sits 0.2546 bits left of ECSQ; we use
        clip(D_ECSQ(R + 0.2546), D_SLB(R), D_ECSQ(R)), which is exact in the
        high-rate limit and bounded by information-theoretic limits always.
        """
        from .quantize import GaussMixture, ecsq_entropy, HIGH_RATE_ECSQ_GAP_BITS

        tab = np.empty((self.n_sigma, len(self.r_grid)))
        for i, sp in enumerate(self.sigmas):
            sp = float(sp)
            var_g = self.prior.second_moment + sp**2
            h_g = gauss_mixture_entropy(self.prior, sp)
            d_slb = 2.0 ** (2.0 * (h_g - self.r_grid)) / (2 * math.pi * math.e)

            # -- ECSQ achievability curve D_ECSQ(R) for source G ------------
            mix = GaussMixture(w=(self.prior.eps, 1 - self.prior.eps),
                               mu=(self.prior.mu_s, 0.0),
                               var=(self.prior.sigma_s**2 + sp**2, sp**2))
            sd_g = math.sqrt(var_g)
            deltas = np.geomspace(sd_g * 2.0**-14, sd_g * 8.0, 72)
            h_q = ecsq_entropy(deltas, mix)      # decreasing in delta
            d_q = deltas**2 / 12.0
            order = np.argsort(h_q)

            def d_ecsq(r):
                ld = np.interp(r, h_q[order], np.log(d_q[order]))
                return np.exp(ld)

            # -- BA exact low-rate curve ------------------------------------
            # adaptive grid: small sigma' compresses the interesting D range,
            # so the BA validity window (D >= 30 dx^2) needs finer resolution
            # to keep the exact branch covering rates up to ~3.5 bits.
            n_grid = self.n_grid * 2 + 1 if sp < 1.5 else self.n_grid
            r_ba, d_ba = ba_rd_curve(self.prior, sp, n_grid=n_grid)
            gap = HIGH_RATE_ECSQ_GAP_BITS
            d_hi = np.clip(d_ecsq(self.r_grid + gap),
                           d_slb, d_ecsq(self.r_grid))
            if len(r_ba) >= 2:
                r_valid_max = float(r_ba[-1])
                ld = np.interp(self.r_grid, np.concatenate([[0.0], r_ba]),
                               np.log(np.concatenate([[var_g], d_ba])))
                d_lo = np.exp(ld)
                d_hat = np.where(self.r_grid <= r_valid_max, d_lo, d_hi)
            else:
                d_hat = d_hi
            d_hat = np.minimum(np.maximum(d_hat, d_slb), var_g)
            # enforce monotone decreasing in R
            d_hat = np.minimum.accumulate(d_hat)
            tab[i] = np.log(np.maximum(d_hat, 1e-300))
        return tab

    # ---- queries ------------------------------------------------------------

    def distortion_g(self, rate, sigma_p):
        """D_G(rate; sigma'), vectorized; bilinear in (log sigma', R)."""
        rate = np.asarray(rate, dtype=np.float64)
        sigma_p = np.asarray(sigma_p, dtype=np.float64)
        rate_b = np.broadcast_to(rate, np.broadcast_shapes(rate.shape, sigma_p.shape)).ravel()
        sig_b = np.broadcast_to(sigma_p, np.broadcast_shapes(rate.shape, sigma_p.shape)).ravel()

        ls = np.log(np.clip(sig_b, self.sigmas[0], self.sigmas[-1]))
        lgrid = np.log(self.sigmas)
        i = np.clip(np.searchsorted(lgrid, ls) - 1, 0, self.n_sigma - 2)
        ws = (ls - lgrid[i]) / (lgrid[i + 1] - lgrid[i])

        r = np.clip(rate_b, 0.0, self.r_grid[-1])
        j = np.clip((r / self.dr).astype(int), 0, len(self.r_grid) - 2)
        wr = (r - self.r_grid[j]) / self.dr

        ld = ((1 - ws) * (1 - wr) * self.log_d[i, j]
              + (1 - ws) * wr * self.log_d[i, j + 1]
              + ws * (1 - wr) * self.log_d[i + 1, j]
              + ws * wr * self.log_d[i + 1, j + 1])
        out = np.exp(ld)
        return out.reshape(np.broadcast_shapes(rate.shape, sigma_p.shape))

    def distortion_msg(self, rate, sigma_t2, n_proc: int):
        """Quantization MSE sigma_Q^2 of one message F_t^p at ``rate`` bits/elem."""
        sigma_p = np.sqrt(n_proc * np.asarray(sigma_t2, dtype=np.float64))
        return self.distortion_g(rate, sigma_p) / n_proc**2

    def rate_for_msg_distortion(self, sigma_q2: float, sigma_t2: float, n_proc: int) -> float:
        """Inverse query: bits/element needed for message MSE sigma_q2."""
        d_g = sigma_q2 * n_proc**2
        sigma_p = math.sqrt(n_proc * sigma_t2)
        rates = self.r_grid
        d_curve = self.distortion_g(rates, np.full_like(rates, sigma_p))
        if d_g >= d_curve[0]:
            return 0.0
        if d_g <= d_curve[-1]:
            return float(rates[-1])
        # d_curve decreasing: find crossing
        k = int(np.searchsorted(-d_curve, -d_g))
        k = min(max(k, 1), len(rates) - 1)
        # log-linear inverse interpolation
        l0, l1 = math.log(d_curve[k - 1]), math.log(d_curve[k])
        w = (math.log(d_g) - l0) / (l1 - l0) if l1 != l0 else 0.0
        return float(rates[k - 1] + w * self.dr)
