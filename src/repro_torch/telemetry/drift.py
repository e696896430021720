"""Live SE-drift monitor (DESIGN.md §12).

The paper's promise is analytic predictability: quantized SE (eq. 8) and
its column/erasure extensions say what per-iteration variance a solve
*should* realize.  The engine already computes the realized plug-in
trajectory in-graph (``EngineTrace.sigma2_hat`` — no extra FLOPs), so
comparing the two per request is nearly free and turns mis-modeled
quantization error, erasure bursts, or stale RD tables into an alert
instead of a silent MSE regression.

Alignment with the engine's plug-in (``core/engine.py``; the predictions
come from this package's ``core.state_evolution``):

- Row layout: ``sigma2_hat[t] = ||z_t||^2 / m`` estimates the SE message
  variance *before* iteration t's transport noise is injected, i.e.
  ``se_trajectory_erasure(...)[t]`` (which starts at sigma_0^2).  The
  transport-injected variance rides separately as
  ``extra_var[t] = P * sigma_Q^2[t]``, which is exactly the schedule the
  SE recursion consumes.
- Column layout: ``sigma2_hat[s] = ||g^s||^2 / M`` post-fusion *includes*
  round-s quantization noise and matches ``tau[s]`` from
  ``se_trajectory_col`` directly.

Drift statistic: ``mean_t | ln(realized[t] / predicted[t]) |`` — a
symmetric, scale-free multiplicative error.  Clean solves measure
well under 0.5 (finite-N fluctuation at the paper's sizes); a mis-rated
solve (e.g. the request declares the wrong SNR, or the quantizer's true
MSE is not what the RD table claims) lands decades off on the log scale.

Predictions are memoized on the operating point (prior, shape, SNR,
layout, P, T, erasure rate, rounded quantizer schedule): a steady-state
request stream pays one dict hit per request, not an SE recursion.
"""
from __future__ import annotations

import math
import threading
from typing import Optional, Tuple

import numpy as np

from ..core.state_evolution import (CSProblem, se_trajectory_col,
                                    se_trajectory_erasure)

__all__ = ["se_drift", "se_drift_batch", "se_prediction", "DRIFT_ALERT"]

# Above this, flag the request (service increments amp_se_drift_alerts_total).
DRIFT_ALERT = 1.0

_cache_lock = threading.Lock()
_cache: dict = {}
_CACHE_MAX = 4096
# second-level cache in front of ``se_prediction``: keyed by the raw
# float32 schedule bytes instead of the 5-sig-digit rounded tuple, so a
# steady stream pays ~1us of key construction per request instead of
# ~5us of per-element string formatting (the <=2% telemetry-overhead
# budget, DESIGN.md §12). Bit-identical schedules — the steady-state
# case, since they come from the same compiled program — always hit.
_fast_cache: dict = {}


def _sched_key(extra_var: Optional[np.ndarray], t: int) -> tuple:
    if extra_var is None:
        return (0.0,) * t
    # 5 significant digits: identical requests hit; real schedule changes miss.
    return tuple(float(f"{float(v):.5e}") for v in extra_var[:t])


def se_prediction(prob: CSProblem, t_max: int, extra_var,
                  *, layout: str = "row", n_proc: int = 1,
                  erasure_rate: float = 0.0, n_inner: int = 1) -> np.ndarray:
    """Predicted per-iteration variance trajectory (length ``t_max``) for
    the operating point, memoized process-wide."""
    key = (prob.n, prob.m, prob.snr_db,
           prob.prior.eps, prob.prior.mu_s, prob.prior.sigma_s,
           layout, int(n_proc), int(n_inner), float(erasure_rate),
           int(t_max), _sched_key(extra_var, t_max))
    with _cache_lock:
        pred = _cache.get(key)
    if pred is not None:
        return pred
    sq = (np.zeros(t_max) if extra_var is None
          else np.asarray(extra_var, dtype=np.float64)[:t_max] / max(n_proc, 1))
    if layout == "col":
        tau, _ = se_trajectory_col(prob, n_proc, n_outer=t_max,
                                   n_inner=n_inner, sigma_q2=sq,
                                   erasure_rate=erasure_rate)
        pred = np.asarray(tau[:t_max])
    else:
        pred = se_trajectory_erasure(prob, sq, n_proc, erasure_rate)[:t_max]
    with _cache_lock:
        if len(_cache) >= _CACHE_MAX:
            _cache.clear()
        _cache[key] = pred
    return pred


def _fast_prediction(prob: CSProblem, t_max: int, extra_var, layout: str,
                     n_proc: int, erasure_rate: float,
                     n_inner: int) -> tuple:
    """Returns ``(pred, log_pred, ok, ok_all)`` — the prediction plus its
    precomputed log and validity mask (``pred > 0`` and finite), so the
    batched drift stat pays only the realized-side numpy ops per call."""
    ev_b = (None if extra_var is None else
            np.ascontiguousarray(extra_var[:t_max],
                                 dtype=np.float32).tobytes())
    key = (prob.n, prob.m, prob.snr_db,
           prob.prior.eps, prob.prior.mu_s, prob.prior.sigma_s,
           layout, int(n_proc), int(n_inner), float(erasure_rate),
           int(t_max), ev_b)
    entry = _fast_cache.get(key)    # GIL-atomic read; no lock on the hit
    if entry is None:
        pred = se_prediction(prob, t_max, extra_var, layout=layout,
                             n_proc=n_proc, erasure_rate=erasure_rate,
                             n_inner=n_inner)
        ok = (pred > 0.0) & np.isfinite(pred)
        with np.errstate(divide="ignore", invalid="ignore"):
            log_pred = np.where(ok, np.log(np.where(ok, pred, 1.0)), 0.0)
        entry = (pred, log_pred, ok, bool(ok.all()))
        with _cache_lock:
            if len(_fast_cache) >= _CACHE_MAX:
                _fast_cache.clear()
            _fast_cache[key] = entry
    return entry


def se_drift(prob: CSProblem, sigma2_hat, extra_var=None,
             *, layout: str = "row", n_proc: int = 1,
             erasure_rate: float = 0.0, n_inner: int = 1
             ) -> Tuple[float, np.ndarray]:
    """Compare a realized ``sigma2_hat`` trajectory against its SE
    prediction.  Returns ``(drift, predicted)`` with
    ``drift = mean_t |ln(realized[t]/predicted[t])|``; NaN when no
    iteration admits a well-defined ratio."""
    s2 = np.asarray(sigma2_hat, dtype=np.float64)
    t_max = len(s2)
    pred = _fast_prediction(prob, t_max, extra_var, layout, n_proc,
                            erasure_rate, n_inner)[0]
    # T is small (<= a few dozen): a scalar loop beats the ~8 numpy-op
    # masked pipeline by an order of magnitude on the hot path
    tot, k = 0.0, 0
    for r, p in zip(s2.tolist(), pred.tolist()):
        if r > 0.0 and p > 0.0 and math.isfinite(r) and math.isfinite(p):
            tot += abs(math.log(r / p))
            k += 1
    if k == 0:
        return float("nan"), pred
    return tot / k, pred


def se_drift_batch(prob: CSProblem, sigma2_hat, extra_var=None,
                   *, layout: str = "row", n_proc: int = 1,
                   erasure_rate: float = 0.0, n_inner: int = 1
                   ) -> np.ndarray:
    """Vectorized ``se_drift`` over a batch sharing one operating point:
    ``sigma2_hat`` is ``(B, T)``; ``extra_var`` is either one length-T
    realized quantizer schedule shared by every row, or a ``(B, T)``
    matrix of per-request schedules (one memoized prediction lookup per
    *distinct* schedule — requests with per-request rate allocations
    stay on the vectorized path instead of degrading to B scalar
    ``se_drift`` calls). One masked log-ratio pass covers every row —
    the batched dispatch path's telemetry tail (DESIGN.md §12). Rows
    with no well-defined ratio come back NaN."""
    s2 = np.asarray(sigma2_hat, dtype=np.float64)
    ev = None if extra_var is None else np.asarray(extra_var)
    if ev is not None and ev.ndim == 2:
        t_max = s2.shape[1]
        log_pred = np.empty_like(s2)
        ok_pred = np.empty(s2.shape, dtype=bool)
        ok_all = True
        for i in range(s2.shape[0]):
            _, lp, okp, oa = _fast_prediction(prob, t_max, ev[i], layout,
                                              n_proc, erasure_rate, n_inner)
            log_pred[i] = lp
            ok_pred[i] = okp
            ok_all = ok_all and oa
    else:
        _, log_pred, ok_pred, ok_all = _fast_prediction(
            prob, s2.shape[1], ev, layout, n_proc, erasure_rate, n_inner)
    # clean-trace fast path (the steady-state common case): every entry
    # strictly positive and finite on both sides, so the mask machinery
    # — masked ufuncs are markedly slower than plain ones — and the
    # per-row count bookkeeping all collapse away
    if ok_all and s2.size and s2.min() > 0.0 and math.isfinite(s2.max()):
        buf = np.log(s2)
        buf -= log_pred
        np.abs(buf, out=buf)
        return buf.sum(axis=1) / s2.shape[1]
    ok = (s2 > 0.0) & np.isfinite(s2)
    if not ok_all:
        ok &= ok_pred
    # log only where valid (masked entries stay 0), subtract the cached
    # log-prediction in place, zero the masked residue, reduce
    buf = np.log(s2, out=np.zeros_like(s2), where=ok)
    np.subtract(buf, log_pred, out=buf, where=ok)
    np.abs(buf, out=buf)
    k = ok.sum(axis=1)
    tot = buf.sum(axis=1)
    return np.where(k > 0, tot / np.maximum(k, 1), np.nan)
