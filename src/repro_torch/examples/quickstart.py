"""Quickstart on the port: compressed-sensing recovery with MP-AMP and
lossy fusion (the twin of the JAX package's ``examples/quickstart.py``).

Solves y = A s0 + e with 30 emulated processors, comparing:
  * centralized AMP (paper eqs. 1-3),
  * MP-AMP with lossless fusion (the same as centralized),
  * MP-AMP with BT-controlled ECSQ quantization (paper Sec. 3.3).

On the card every local-computation step is the fused row kernel (K1).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.amp import amp_solve
from ..core.denoisers import BernoulliGauss, make_mmse_interp
from ..core.mp_amp import MPAMPConfig, mp_amp_solve
from ..core.rate_alloc import BTController
from ..core.state_evolution import CSProblem
from .common import check_device, draw_problem, sdr_db

__all__ = ["run", "main"]

N, M, EPS, SNR_DB, N_PROC, N_ITER = 5000, 1500, 0.1, 20.0, 30, 15


def run(device: str = "cuda", problem=None, n: int = N, m: int = M,
        eps: float = EPS, snr_db: float = SNR_DB, n_proc: int = N_PROC,
        n_iter: int = N_ITER, seed: int = 0) -> dict:
    """The three solves on one problem (``problem`` = (s0, a, y), else
    drawn from ``seed``). Returns the printed numbers, the x and MSE
    trajectories of each solve and the BT solve's bins and rates."""
    check_device(device)
    if problem is not None:
        m, n = problem[1].shape
    prior = BernoulliGauss(eps=eps, mu_s=0.0, sigma_s=1.0)
    prob = CSProblem(n=n, m=m, prior=prior, snr_db=snr_db)
    s0, a, y = draw_problem(seed, prob, device, problem)
    cfg = MPAMPConfig(n_proc, n_iter, device=device)

    cen = amp_solve(y, a, prior, n_iter, s0=s0, device=device)
    lossless = mp_amp_solve(y, a, prior, cfg, [np.inf] * n_iter, s0=s0)
    ctrl = BTController(prob, n_proc, n_iter, c_ratio=1.005, r_max=6.0,
                        rate_model="ecsq", mmse_fn=make_mmse_interp(prior))
    bt = mp_amp_solve(y, a, prior, cfg, ctrl, s0=s0)
    total = bt.total_bits_empirical
    return {
        "n": n, "m": m, "eps": eps, "snr_db": snr_db, "n_proc": n_proc,
        "n_iter": n_iter,
        "sdr_centralized": sdr_db(prior, cen.mse[-1]),
        "bits_centralized": 32 * n_iter,
        "sdr_lossless": sdr_db(prior, lossless.mse[-1]),
        "max_dx_lossless": float(np.abs(lossless.x - cen.x).max()),
        "sdr_bt": sdr_db(prior, bt.mse[-1]),
        "bits_bt": float(total),
        "saved_pct": float(100 * (1 - total / (32 * n_iter))),
        "rates_bt": [float(r) for r in bt.rates_empirical],
        "x": {"centralized": cen.x, "lossless": lossless.x, "bt": bt.x},
        "mse": {"centralized": cen.mse, "lossless": lossless.mse,
                "bt": bt.mse},
        "sigma2_hat": {"centralized": cen.sigma2_hat,
                       "lossless": lossless.sigma2_hat,
                       "bt": bt.sigma2_hat},
        "deltas_bt": bt.deltas,
        "bits_bt_analytic": bt.total_bits_analytic,
    }


def report(r: dict) -> None:
    print(f"CS problem: N={r['n']} M={r['m']} eps={r['eps']} "
          f"SNR={r['snr_db']}dB, P={r['n_proc']} processors, "
          f"T={r['n_iter']}")
    print(f"\ncentralized AMP       : SDR {r['sdr_centralized']:6.2f} dB "
          f"(32-bit fusion: {r['bits_centralized']} bits/element total)")
    print(f"MP-AMP lossless fusion: SDR {r['sdr_lossless']:6.2f} dB "
          f"(identical to centralized: max|dx|="
          f"{r['max_dx_lossless']:.1e})")
    print(f"BT-MP-AMP (ECSQ)      : SDR {r['sdr_bt']:6.2f} dB "
          f"({r['bits_bt']:.1f} bits/element total -> "
          f"{r['saved_pct']:.0f}% communication saved)")
    print("per-iteration rates   :", np.round(r["rates_bt"], 2))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the solves run (default: the card)")
    args = ap.parse_args(argv)
    r = run(device=args.device, n=N, m=M, eps=EPS, snr_db=SNR_DB,
            n_proc=N_PROC, n_iter=N_ITER)
    report(r)
    return r


if __name__ == "__main__":
    main()
