"""Coding-rate allocation across AMP iterations (paper Secs. 3.3-3.4).

BT-MP-AMP (online back-tracking): at iteration t, given the plug-in estimate
sigma_hat_{t,D}^2, find the largest quantizer MSE sigma_Q^2 such that the
predicted next-iteration variance stays within a factor ``c_ratio`` of the
offline centralized-SE value:

    sigma_e^2 + mmse(sigma_hat_{t,D}^2 + P sigma_Q^2)/kappa
        <= c_ratio * sigma_{t+1,C}^2,

subject to rate(sigma_Q^2) <= r_max bits/element.

DP-MP-AMP (offline optimal, eqs. 9-12): given a total budget R over T
iterations discretized at dR (=0.1 in the paper), dynamic programming over
the table sigma_D^2(s, t) = best variance using R^{(s)} bits in the first t
iterations, with transition
    sigma_D^2(s,t) = min_r f1(sigma_D^2(r, t-1), R^{(s-r+1)}).

Erasure recovery policies (DESIGN.md §10): under per-packet loss rate p the
allocators support two bit-accounting disciplines, selectable via
``recovery``:

  * ``"retransmit"`` — lost packets are re-sent next round, so of a wire
    budget R only (1-p)*R lands as fused payload: the DP allocates the
    shrunk budget, BT caps the delivered per-packet rate at r_max*(1-p),
    and the wire rate is the delivered rate / (1-p).
  * ``"rate_up"`` — the dropped processors' bit share is re-allocated to
    the survivors: the fused-payload budget is unchanged, each survivor
    spends rate/(1-p) (finer bins), and the per-processor-slot wire rate
    equals the allocated rate.

Either way the SE step amplifies the denoiser input by
``erasure_amplification`` (the survivor-rescale noise blow-up); the
``DPResult.wire_rates`` column reports what actually crosses the wire.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .denoisers import BernoulliGauss, make_mmse_interp
from .quantize import (delta_for_rate_ecsq, delta_for_sigma_q2, ecsq_entropy,
                       message_mixture)
from .rate_distortion import RDModel
from .state_evolution import (CSProblem, erasure_amplification,
                              se_trajectory, se_trajectory_erasure)

__all__ = ["BTController", "bt_schedule_offline", "dp_allocate",
           "dp_allocate_col", "col_sigma_q2_for_rate", "DPResult",
           "rate_for_sigma_q2", "sigma_q2_for_rate", "stack_schedules",
           "erasure_rate_factors"]


def erasure_rate_factors(erasure_rate: float, recovery: str):
    """(budget_factor, survivor_boost, wire_factor) for a recovery policy.

    ``budget_factor`` scales the allocatable payload budget,
    ``survivor_boost`` the per-delivered-packet rate actually spent
    relative to the allocated slot rate, and ``wire_factor`` maps
    delivered rates to on-the-wire rates (module docstring). At
    ``erasure_rate = 0`` all three are exactly 1.0.
    """
    assert 0.0 <= erasure_rate < 1.0, erasure_rate
    assert recovery in ("retransmit", "rate_up"), recovery
    if erasure_rate == 0.0:
        return 1.0, 1.0, 1.0
    keep = 1.0 - erasure_rate
    if recovery == "retransmit":
        return keep, 1.0, 1.0 / keep
    return 1.0, 1.0 / keep, keep


def stack_schedules(schedules, n_iter: int) -> np.ndarray:
    """Stack variable-length per-request delta schedules into (B, n_iter).

    The serving layer buckets requests with different iteration counts into
    one scan of length ``n_iter`` (the bucket's T_max); shorter schedules
    are padded with +inf — lossless no-op bins that sit beyond the
    request's ``t_active`` early-exit mask, so they are never acted on.
    """
    out = np.full((len(schedules), n_iter), np.inf, np.float32)
    for i, sched in enumerate(schedules):
        sched = np.asarray(sched, np.float32)
        assert sched.ndim == 1 and len(sched) <= n_iter, \
            f"schedule {i}: {sched.shape} exceeds bucket T_max={n_iter}"
        out[i, :len(sched)] = sched
    return out


# ---------------------------------------------------------------------------
# shared helpers (public: core/engine.py builds its in-graph BT rate tables
# from these, so the scan-compiled controller and this host-loop controller
# share one rate model)
# ---------------------------------------------------------------------------

def rate_for_sigma_q2(sigma_q2: float, sigma_t2: float, prob: CSProblem,
                      n_proc: int, rate_model: str, rd: RDModel | None) -> float:
    """Bits/element needed for per-message quantizer MSE sigma_q2."""
    if rate_model == "rd":
        return rd.rate_for_msg_distortion(sigma_q2, sigma_t2, n_proc)
    mix = message_mixture(prob.prior, sigma_t2, n_proc)
    return float(ecsq_entropy(delta_for_sigma_q2(sigma_q2), mix)[0])


def sigma_q2_for_rate(rate: float, sigma_t2: float, prob: CSProblem,
                      n_proc: int, rate_model: str, rd: RDModel | None) -> float:
    if rate_model == "rd":
        return float(rd.distortion_msg(rate, sigma_t2, n_proc))
    mix = message_mixture(prob.prior, sigma_t2, n_proc)
    return delta_for_rate_ecsq(rate, mix) ** 2 / 12.0


# legacy private aliases (pre-engine callers)
_rate_for_sigma_q2 = rate_for_sigma_q2
_sigma_q2_for_rate = sigma_q2_for_rate


# ---------------------------------------------------------------------------
# BT-MP-AMP
# ---------------------------------------------------------------------------

class BTController:
    """Online back-tracking rate controller (paper Sec. 3.3).

    Usable directly as the ``delta_schedule`` callable of mp_amp_solve.
    Records per-iteration (rate, sigma_q2, delta) decisions.
    """

    def __init__(self, prob: CSProblem, n_proc: int, n_iter: int,
                 c_ratio: float = 1.05, r_max: float = 6.0,
                 rate_model: str = "ecsq", rd: RDModel | None = None,
                 mmse_fn=None, erasure_rate: float = 0.0,
                 recovery: str = "retransmit"):
        self.prob = prob
        self.n_proc = n_proc
        self.c_ratio = c_ratio
        self.r_max = r_max
        self.rate_model = rate_model
        self.rd = rd if (rd is not None or rate_model != "rd") else RDModel(prob.prior)
        self.mmse_fn = mmse_fn or make_mmse_interp(prob.prior)
        self.erasure_rate = erasure_rate
        self.recovery = recovery
        budget_f, boost, wire_f = erasure_rate_factors(erasure_rate, recovery)
        self._amp = erasure_amplification(erasure_rate, n_proc)
        self._wire_f = wire_f
        # delivered-rate cap implied by the wire cap r_max: retransmit
        # loses p of the wire budget, rate_up hands the dropped share to
        # survivors (r_max * budget_f * boost; exactly r_max at rate 0)
        self._r_cap = r_max * budget_f * boost
        # offline SE reference sigma_{t,C}^2, t = 0..n_iter — under
        # erasure the reachable reference is the zero-quantization SE with
        # the survivor-rescale amplification, not the lossless-link one
        if erasure_rate > 0.0:
            self.sigma2_c = se_trajectory_erasure(
                prob, np.zeros(n_iter), n_proc, erasure_rate,
                mmse_fn=self.mmse_fn)
        else:
            self.sigma2_c = se_trajectory(prob, n_iter, mmse_fn=self.mmse_fn)
        self.rates: list[float] = []        # delivered bits/element
        self.wire_rates: list[float] = []   # on-the-wire bits/element/slot
        self.sigma_q2s: list[float] = []

    def _predict_next(self, sigma2_d: float, sigma_q2: float) -> float:
        eff = sigma2_d + self.n_proc * sigma_q2
        if self._amp != 1.0:
            eff = self._amp * eff
        return self.prob.sigma_e2 + float(self.mmse_fn(eff)) / self.prob.kappa

    def __call__(self, t: int, sigma2_hat: float) -> float:
        prob, p = self.prob, self.n_proc
        target = self.c_ratio * self.sigma2_c[t + 1]
        # feasibility at zero quantization noise (plug-in may exceed SE ref)
        base = self._predict_next(sigma2_hat, 0.0)
        if base >= target:
            # cannot meet the ratio even losslessly -> spend the cap
            rate = self._r_cap
            sq2 = sigma_q2_for_rate(rate, sigma2_hat, prob, p,
                                     self.rate_model, self.rd)
        else:
            # largest sigma_Q^2 with predicted variance <= target (bisection;
            # _predict_next is increasing in sigma_Q^2)
            lo, hi = 0.0, sigma2_hat / p + 1e-12
            while self._predict_next(sigma2_hat, hi) < target:
                hi *= 4.0
                if hi > 1e6:
                    break
            for _ in range(80):
                mid = 0.5 * (lo + hi)
                if self._predict_next(sigma2_hat, mid) <= target:
                    lo = mid
                else:
                    hi = mid
            sq2 = lo
            rate = rate_for_sigma_q2(sq2, sigma2_hat, prob, p,
                                      self.rate_model, self.rd)
            if rate > self._r_cap:
                rate = self._r_cap
                sq2 = sigma_q2_for_rate(rate, sigma2_hat, prob, p,
                                         self.rate_model, self.rd)
        self.rates.append(rate)
        self.wire_rates.append(rate * self._wire_f)
        self.sigma_q2s.append(sq2)
        return delta_for_sigma_q2(sq2)


def bt_schedule_offline(prob: CSProblem, n_proc: int, n_iter: int,
                        c_ratio: float = 1.05, r_max: float = 6.0,
                        rate_model: str = "rd", rd: RDModel | None = None,
                        mmse_fn=None, erasure_rate: float = 0.0,
                        recovery: str = "retransmit"):
    """Pure-SE BT prediction (no data): returns (rates, sigma2_D trajectory).

    This is the paper's "BT-MP-AMP (RD prediction)" row: run the BT rule on
    the quantized SE recursion itself, using the RD function as rate model.
    """
    ctrl = BTController(prob, n_proc, n_iter, c_ratio, r_max, rate_model, rd,
                        mmse_fn, erasure_rate=erasure_rate, recovery=recovery)
    sigma2_d = [prob.sigma0_2]
    for t in range(n_iter):
        ctrl(t, sigma2_d[-1])
        sigma2_d.append(ctrl._predict_next(sigma2_d[-1], ctrl.sigma_q2s[-1]))
    return np.asarray(ctrl.rates), np.asarray(sigma2_d)


# ---------------------------------------------------------------------------
# DP-MP-AMP
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DPResult:
    rates: np.ndarray          # optimal R_t, t = 1..T (bits/element)
    sigma2_d: np.ndarray       # predicted variance trajectory (T+1,)
    sigma2_table: np.ndarray   # full DP table Sigma (S, T)
    r_grid: np.ndarray         # R^{(s)} grid
    wire_rates: np.ndarray | None = None
                               # on-the-wire bits/element/processor-slot
                               # under an erasure recovery policy (None =
                               # lossless link, wire == rates)


def dp_allocate(prob: CSProblem, n_proc: int, n_iter: int, r_total: float,
                dr: float = 0.1, rd: RDModel | None = None,
                mmse_fn=None, erasure_rate: float = 0.0,
                recovery: str = "retransmit") -> DPResult:
    """Optimal rate allocation by dynamic programming (paper eqs. 10-12).

    ``erasure_rate``/``recovery`` allocate for a lossy link (module
    docstring): the SE transition amplifies by the survivor-rescale
    factor, ``retransmit`` shrinks the allocatable budget to
    (1-p)*r_total, ``rate_up`` lets survivors spend the dropped share.
    ``erasure_rate = 0`` reproduces the published allocator exactly.
    """
    rd = rd or RDModel(prob.prior)
    mmse_fn = mmse_fn or make_mmse_interp(prob.prior)
    p = n_proc
    budget_f, boost, wire_f = erasure_rate_factors(erasure_rate, recovery)
    amp = erasure_amplification(erasure_rate, n_proc)
    s_count = int(round(r_total * budget_f / dr)) + 1
    r_grid = np.arange(s_count) * dr  # R^{(s)}, s = 1..S (0-indexed)

    def f1_matrix(v_prev: np.ndarray, rates: np.ndarray) -> np.ndarray:
        """f1(v_prev[r], rates[k]) for all (r, k): (S, S) array."""
        sigma_p = np.sqrt(p * v_prev)[:, None]          # (S, 1)
        # survivors deliver at boost * the allocated slot rate
        d_g = rd.distortion_g(rates[None, :] * boost, sigma_p)  # (S, S)
        eff = v_prev[:, None] + d_g / p                 # + P * sigma_Q^2
        if amp != 1.0:
            eff = amp * eff
        return prob.sigma_e2 + mmse_fn(eff) / prob.kappa

    big = np.inf
    sigma_tab = np.full((s_count, n_iter), big)
    choice = np.zeros((s_count, n_iter), dtype=np.int64)

    # t = 1 (column 0): all budget R^{(s)} spent here
    v0 = np.full(s_count, prob.sigma0_2)
    sigma_tab[:, 0] = f1_matrix(v0[:1], r_grid)[0]
    choice[:, 0] = np.arange(s_count)

    for t in range(1, n_iter):
        v_prev = sigma_tab[:, t - 1]                    # (S,) indexed by r
        m = f1_matrix(v_prev, r_grid)                   # m[r, k] = f1(prev_r, k*dr)
        # sigma(s, t) = min over r <= s of m[r, s - r]
        r_idx = np.arange(s_count)[:, None]             # (S, 1)
        s_idx = np.arange(s_count)[None, :]             # (1, S)
        k_idx = s_idx - r_idx
        valid = k_idx >= 0
        vals = np.where(valid, m[r_idx, np.clip(k_idx, 0, s_count - 1)], big)
        best_r = np.argmin(vals, axis=0)                # (S,)
        sigma_tab[:, t] = vals[best_r, np.arange(s_count)]
        choice[:, t] = np.arange(s_count) - best_r      # rate index spent at t

    # backtrack from (S-1, T-1)
    rates = np.zeros(n_iter)
    s = s_count - 1
    for t in range(n_iter - 1, -1, -1):
        k = choice[s, t]
        rates[t] = r_grid[k]
        s = s - k

    # predicted trajectory under the optimal schedule
    sigma2_d = [prob.sigma0_2]
    for t in range(n_iter):
        sq2 = float(rd.distortion_msg(rates[t] * boost, sigma2_d[-1], p))
        eff = sigma2_d[-1] + p * sq2
        if amp != 1.0:
            eff = amp * eff
        sigma2_d.append(prob.sigma_e2 + float(mmse_fn(eff)) / prob.kappa)

    wire = rates * boost * wire_f if erasure_rate > 0.0 else None
    return DPResult(rates=rates, sigma2_d=np.asarray(sigma2_d),
                    sigma2_table=sigma_tab, r_grid=r_grid, wire_rates=wire)


# ---------------------------------------------------------------------------
# DP-C-MP-AMP (column layout, DESIGN.md §7)
# ---------------------------------------------------------------------------

def col_sigma_q2_for_rate(rate, block_mse, prob: CSProblem, n_proc: int,
                          ecsq_gap: bool = True):
    """Quantizer MSE on one exchanged residual contribution at ``rate``
    bits/entry (Gaussian model; vectorized over ``rate``/``block_mse``).

    Column-layout residual entries are ~ N(0, v_r) (``residual_mixture``),
    so the rate-distortion law is the Gaussian one, D = v_r 2^{-2R},
    shifted by the high-rate ECSQ gap when the realized quantizer is a
    midtread scalar one.  Capped at v_r: spending less than the gap cannot
    do worse than sending nothing (the FC substitutes zero).
    """
    from .quantize import HIGH_RATE_ECSQ_GAP_BITS
    gap = HIGH_RATE_ECSQ_GAP_BITS if ecsq_gap else 0.0
    sm = prob.prior.second_moment
    v_r = np.maximum(sm - np.asarray(block_mse, np.float64), 1e-30) \
        / (prob.kappa * n_proc)
    return v_r * np.minimum(1.0, 2.0 ** (-2.0 * (np.asarray(rate) - gap)))


def _col_round_map(d_prev, sigma_q2, prob: CSProblem, n_proc: int,
                   n_inner: int, mmse_fn, erasure_rate: float = 0.0):
    """One outer-round map of the two-stage column SE, vectorized over a
    (d_prev, sigma_q2) grid: returns the block MSE after the round.

    ``erasure_rate`` applies the column *reset* semantics
    (state_evolution module docstring): the block MSE entering the round
    averages to (1-p)*d + p*E[S0^2] and only the surviving fraction
    injects quantization noise.  ``0.0`` is bit-exact with the
    lossless-link map.
    """
    d_prev = np.asarray(d_prev, np.float64)
    if erasure_rate > 0.0:
        keep = 1.0 - erasure_rate
        d_in = keep * d_prev + erasure_rate * prob.prior.second_moment
    else:
        keep = 1.0
        d_in = d_prev
    tau0 = prob.sigma_e2 + keep * n_proc * sigma_q2 + d_in / prob.kappa
    e = d_in
    tau_t = tau0
    for _ in range(n_inner):
        e = mmse_fn(tau_t)
        tau_t = tau0 + (e - d_in) / (prob.kappa * n_proc)
    return e


def dp_allocate_col(prob: CSProblem, n_proc: int, n_outer: int,
                    r_total: float, n_inner: int = 1, dr: float = 0.1,
                    mmse_fn=None, ecsq_gap: bool = True,
                    erasure_rate: float = 0.0,
                    recovery: str = "retransmit") -> DPResult:
    """Offline-optimal rate allocation across C-MP-AMP outer rounds.

    Same DP recursion as ``dp_allocate`` (paper eqs. 10-12) with the
    column-layout round map in place of the row-wise SE step: the state is
    the block MSE d^s, a round at rate R injects P * sigma_Q^2(R, d) onto
    the fused residual, and the inner recursion runs ``n_inner`` mmse
    steps.  Round 0 is excluded from the allocation — its exchanged
    contributions are identically zero, so it is lossless for free.

    ``erasure_rate``/``recovery`` follow the module-docstring accounting;
    the SE step is the column *reset* map rather than the row-wise
    survivor-rescale amplification.

    Returns a ``DPResult`` whose ``rates`` has length ``n_outer``
    (``rates[0] = 0``) and whose ``sigma2_d`` is the predicted block-MSE
    trajectory d^0..d^{n_outer} (length n_outer+1).
    """
    mmse_fn = mmse_fn or make_mmse_interp(prob.prior)
    budget_f, boost, wire_f = erasure_rate_factors(erasure_rate, recovery)
    p_e = erasure_rate
    s_count = int(round(r_total * budget_f / dr)) + 1
    r_grid = np.arange(s_count) * dr
    n_alloc = n_outer - 1   # rounds 1..n_outer-1 spend the budget

    def f1_matrix(d_prev: np.ndarray, rates: np.ndarray) -> np.ndarray:
        """round_map(d_prev[r], rates[k]) for all (r, k): (S, S) array."""
        dp_col = d_prev[:, None]
        # survivors deliver at boost * the allocated slot rate
        sq2 = col_sigma_q2_for_rate(rates[None, :] * boost, dp_col, prob,
                                    n_proc, ecsq_gap)
        return _col_round_map(dp_col, sq2, prob, n_proc, n_inner, mmse_fn,
                              erasure_rate=p_e)

    # round 0: lossless, no budget spent (an erased all-zeros contribution
    # resets a block to the x = 0 it already holds, so the reset map is
    # exact here too)
    d0 = _col_round_map(np.asarray([prob.prior.second_moment]), 0.0, prob,
                        n_proc, n_inner, mmse_fn, erasure_rate=p_e)[0]

    big = np.inf
    if n_alloc == 0:
        return DPResult(rates=np.zeros(n_outer),
                        sigma2_d=np.asarray([prob.prior.second_moment, d0]),
                        sigma2_table=np.full((s_count, 1), d0),
                        r_grid=r_grid,
                        wire_rates=(np.zeros(n_outer) if p_e > 0.0
                                    else None))

    sigma_tab = np.full((s_count, n_alloc), big)
    choice = np.zeros((s_count, n_alloc), dtype=np.int64)

    v0 = np.full(s_count, d0)
    sigma_tab[:, 0] = f1_matrix(v0[:1], r_grid)[0]
    choice[:, 0] = np.arange(s_count)

    for t in range(1, n_alloc):
        d_prev = sigma_tab[:, t - 1]
        m = f1_matrix(d_prev, r_grid)
        r_idx = np.arange(s_count)[:, None]
        s_idx = np.arange(s_count)[None, :]
        k_idx = s_idx - r_idx
        valid = k_idx >= 0
        vals = np.where(valid, m[r_idx, np.clip(k_idx, 0, s_count - 1)], big)
        best_r = np.argmin(vals, axis=0)
        sigma_tab[:, t] = vals[best_r, np.arange(s_count)]
        choice[:, t] = np.arange(s_count) - best_r

    rates = np.zeros(n_outer)
    s = s_count - 1
    for t in range(n_alloc - 1, -1, -1):
        k = choice[s, t]
        rates[t + 1] = r_grid[k]
        s = s - k

    # predicted block-MSE trajectory under the optimal schedule
    d_traj = [prob.prior.second_moment, d0]
    for t in range(1, n_outer):
        sq2 = float(col_sigma_q2_for_rate(rates[t] * boost, d_traj[-1], prob,
                                          n_proc, ecsq_gap))
        d_traj.append(float(_col_round_map(np.asarray([d_traj[-1]]), sq2,
                                           prob, n_proc, n_inner, mmse_fn,
                                           erasure_rate=p_e)[0]))

    wire = rates * boost * wire_f if p_e > 0.0 else None
    return DPResult(rates=rates, sigma2_d=np.asarray(d_traj),
                    sigma2_table=sigma_tab, r_grid=r_grid, wire_rates=wire)
