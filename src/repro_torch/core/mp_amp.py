"""Multi-processor AMP with lossy fusion compression (paper Sec. 3).

Row-partitioned model: processor p holds A^p (M/P rows) and y^p. Per iteration

    LC:  z_t^p = y^p - A^p x_t + (1/kappa) * mean(eta'_{t-1}) * z_{t-1}^p
         f_t^p = x_t / P + (A^p)^T z_t^p
    GC:  f_t = sum_p Q_t(f_t^p)        <- lossy fusion (midtread quantizer)
         x_{t+1} = eta_t^Q(f_t),  denoiser variance sigma_hat_t^2 + P Delta^2/12

The LC and GC stages are split exactly as in the paper so that an *online*
rate controller (BT-MP-AMP, Sec. 3.3) can observe the current plug-in noise
estimate sigma_hat_{t,D}^2 = sum_p ||z_t^p||^2 / M — which is available after
LC — before choosing the quantizer for this iteration's fusion.

This module is the *emulated* multi-processor frontend of the unified
``core/engine.py`` solver: the processor axis is a leading tensor axis and
fusion is a sum over it — bit-exact to the physical cluster algorithm
(quantization included), independent of device count. Fixed schedules and
``BTController`` instances run as a single engine solve with no
per-iteration host sync (the BT rule runs on the device); arbitrary Python
schedule callables fall back to the engine's host-loop mode.

Rate accounting per iteration: analytic ECSQ entropy H_Q of the model message
distribution, plus the empirical entropy of the realized symbol stream.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .denoisers import BernoulliGauss
from .engine import (AmpEngine, BTRateControl, EcsqTransport, EngineConfig,
                     EngineTrace, FixedSchedule, amp_gc_step, split_problem)
from .quantize import ecsq_entropy, message_mixture
from .rate_alloc import BTController

__all__ = ["MPAMPConfig", "MPAMPResult", "mp_amp_solve", "split_problem",
           "mp_local_step", "mp_fusion_step"]


@dataclasses.dataclass(frozen=True)
class MPAMPConfig:
    n_proc: int = 30
    n_iter: int = 10
    device: str = "cuda"     # where the solve runs; tests pass "cpu"


@dataclasses.dataclass
class MPAMPResult:
    x: np.ndarray
    mse: np.ndarray | None        # per-iteration MSE vs s0 (if s0 given)
    sigma2_hat: np.ndarray        # plug-in sigma_t^2 estimates (post-LC)
    rates_analytic: np.ndarray    # H_Q from the model mixture (bits/elem/proc)
    rates_empirical: np.ndarray   # empirical entropy of realized symbols
    deltas: np.ndarray            # quantizer bin sizes used (inf = lossless)

    @property
    def total_bits_analytic(self) -> float:
        r = self.rates_analytic
        return float(np.sum(r[np.isfinite(r)]))

    @property
    def total_bits_empirical(self) -> float:
        r = self.rates_empirical
        return float(np.sum(r[np.isfinite(r)]))


# ---------------------------------------------------------------------------
# single-iteration pieces (public API; plain tensor ops on any device)
# ---------------------------------------------------------------------------

def mp_local_step(x, z_p, onsager_coef, a_p, y_p):
    """LC: residual update + per-processor message. Returns (z_new, f_p, s2)."""
    n_proc = a_p.shape[0]
    m = a_p.shape[0] * a_p.shape[1]
    z_new = y_p - torch.einsum("pmn,n->pm", a_p, x) + onsager_coef * z_p
    f_p = x[None, :] / n_proc + torch.einsum("pmn,pm->pn", a_p, z_new)
    sigma2_hat = torch.sum(z_new * z_new) / m
    return z_new, f_p, sigma2_hat


def mp_fusion_step(f_p, sigma2_hat, delta, prior: BernoulliGauss, kappa):
    """GC: quantize messages, fuse, denoise. Returns (x_new, onsager, q_syms)."""
    delta = torch.as_tensor(delta, dtype=f_p.dtype, device=f_p.device)
    f, extra, q = EcsqTransport().fuse(f_p, delta)
    x_new, onsager_new = amp_gc_step(f, sigma2_hat + extra, prior, kappa)
    return x_new, onsager_new, q


# per-(prior, P, T, device) engines for fixed-schedule / host-loop solves
_FIXED_ENGINES: dict = {}


def _empirical_entropy(q: np.ndarray) -> float:
    """Empirical entropy (bits/symbol) of the quantized index stream."""
    _, counts = np.unique(q.astype(np.int64), return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def _result_from_trace(trace: EngineTrace, prior: BernoulliGauss,
                       cfg: MPAMPConfig, s0, sigma2_for_model) -> MPAMPResult:
    """Host-side rate accounting + MSE curve from an engine trace."""
    r_ana, r_emp = [], []
    for t in range(cfg.n_iter):
        delta_t = float(trace.deltas[t])
        if math.isfinite(delta_t):
            model_s2 = (sigma2_for_model[t] if sigma2_for_model is not None
                        else float(trace.sigma2_hat[t]))
            mix = message_mixture(prior, model_s2, cfg.n_proc)
            r_ana.append(float(ecsq_entropy(delta_t, mix)[0]))
            r_emp.append(_empirical_entropy(np.asarray(trace.symbols[t])))
        else:
            r_ana.append(np.inf)
            r_emp.append(np.inf)
    mse = trace.mse(s0) if s0 is not None else None
    return MPAMPResult(
        x=trace.x, mse=mse, sigma2_hat=trace.sigma2_hat,
        rates_analytic=np.asarray(r_ana), rates_empirical=np.asarray(r_emp),
        deltas=trace.deltas,
    )


def mp_amp_solve(y, a_mat, prior: BernoulliGauss, cfg: MPAMPConfig,
                 delta_schedule, s0: np.ndarray | None = None,
                 sigma2_for_model=None) -> MPAMPResult:
    """Run MP-AMP with a per-iteration quantizer schedule on ``cfg.device``.

    y, a_mat: numpy arrays or tensors.
    delta_schedule: either a sequence of bin sizes (len n_iter; np.inf =>
      lossless fusion at that iteration), an online controller callable
      ``delta_schedule(t, sigma2_hat) -> delta`` receiving this iteration's
      post-LC plug-in estimate (BT-MP-AMP), or an engine RateController.
      Sequences, ``rate_alloc.BTController`` instances and engine
      controllers run as one sync-free engine solve; other callables use
      the per-iteration host loop.
    sigma2_for_model: optional per-iteration channel variances for the
      *analytic* rate accounting (defaults to the online plug-in estimates).
    """
    ecfg = EngineConfig(n_proc=cfg.n_proc, n_iter=cfg.n_iter,
                        device=cfg.device)

    bt_host: BTController | None = None
    if isinstance(delta_schedule, BTController):
        bt_host = delta_schedule
        # device tables are cached on the controller instance (their build
        # is the expensive part; the controller's params + (P, T) fix them)
        controller = getattr(bt_host, "_in_graph", None)
        if (controller is None or controller.n_iter != cfg.n_iter
                or controller.n_proc != cfg.n_proc):
            controller = BTRateControl(
                bt_host.prob, cfg.n_proc, cfg.n_iter, bt_host.c_ratio,
                bt_host.r_max, bt_host.rate_model, bt_host.rd,
                bt_host.mmse_fn)
            bt_host._in_graph = controller
        host_fallback = None
    elif callable(delta_schedule):
        controller, host_fallback = None, delta_schedule
    elif hasattr(delta_schedule, "delta_for"):
        controller, host_fallback = delta_schedule, None
    else:
        # longer schedules are valid (legacy contract): first n_iter entries
        controller = FixedSchedule(
            np.asarray(delta_schedule, np.float64)[:cfg.n_iter])
        host_fallback = None

    # fixed schedules share one engine per (prior, P, T, device): the
    # schedule is an operand of the solve, not part of the engine
    if type(controller) is FixedSchedule or host_fallback is not None:
        cache_key = (prior, cfg.n_proc, cfg.n_iter, cfg.device)
        engine = _FIXED_ENGINES.get(cache_key)
        if engine is None:
            engine = AmpEngine(prior, ecfg, EcsqTransport(),
                               FixedSchedule(np.full(cfg.n_iter, np.inf)))
            _FIXED_ENGINES[cache_key] = engine
        if type(controller) is FixedSchedule:
            engine.controller = controller
    else:
        # the engine rides on the controller so repeated solves reuse it
        engine = getattr(controller, "_engine", None)
        if engine is None or engine.prior != prior or engine.cfg != ecfg:
            engine = AmpEngine(prior, ecfg, EcsqTransport(), controller)
            try:
                controller._engine = engine
            except AttributeError:
                pass
        engine.controller = controller
    if host_fallback is not None:
        trace = engine.solve_host_loop(y, a_mat, host_schedule=host_fallback)
    else:
        trace = engine.solve(y, a_mat)

    if bt_host is not None:
        # preserve the host controller's record-keeping contract
        for t in range(cfg.n_iter):
            bt_host.rates.append(float(trace.rates[t]))
            bt_host.sigma_q2s.append(float(trace.deltas[t]) ** 2 / 12.0)

    return _result_from_trace(trace, prior, cfg, s0, sigma2_for_model)
