"""Serve a heterogeneous batch of CS recovery requests through the port's
solve service: different shapes, priors, SNRs and rate policies mixed in
one submission (the twin of the JAX package's ``examples/serve_mixed.py``;
its DESIGN.md §5).

On the card the row buckets run the fused row kernel (K1) and the column
buckets the column pair (K2, K3).

  PYTHONPATH=src python -m repro_torch.examples.serve_mixed [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core.denoisers import BernoulliGauss
from ..core.state_evolution import CSProblem
from ..serving import BucketPolicy, SolveRequest, SolveService
from .common import check_device, draw_problem, to_numpy

__all__ = ["SPECS", "run", "main"]

# Mixed traffic: (eps, snr_db, N, M, P, T, policy) — different operating
# points, three rate policies, and both partition layouts: wide shapes
# (N/M ~ 3.2) route row-wise, tall ones (N/M >= 4) route to C-MP-AMP
# column buckets.
SPECS = [
    (0.10, 20.0, 1024, 320, 8, 8, "lossless"),
    (0.10, 20.0, 1024, 320, 8, 8, "fixed"),
    (0.02, 20.0, 2048, 256, 8, 10, "bt"),       # tall: column layout
    (0.10, 15.0,  512, 160, 4, 8, "bt"),
    (0.02, 25.0, 2048, 256, 8, 6, "fixed"),     # tall: column layout
]
MAX_BATCH = 32


def _requests(specs, device: str, problems=None):
    """One ``SolveRequest`` a spec (problem i drawn from seed i, or
    ``problems[i]`` = (s0, a, y)) and its (s0, CSProblem)."""
    reqs, truths = [], []
    for i, (eps, snr, n, m, p, t, policy) in enumerate(specs):
        prior = BernoulliGauss(eps=eps)
        prob = CSProblem(n=n, m=m, prior=prior, snr_db=snr)
        s0, a, y = draw_problem(i, prob, device,
                                None if problems is None else problems[i])
        kw = {}
        if policy == "fixed":
            deltas = np.full(t, 0.05, np.float32)
            deltas[0] = np.inf  # first iteration lossless (messages wide)
            kw["deltas"] = deltas
        reqs.append(SolveRequest(y=to_numpy(y), a=to_numpy(a), prior=prior,
                                 snr_db=snr, n_proc=p, n_iter=t,
                                 policy=policy, **kw))
        truths.append((s0, prob))
    return reqs, truths


def _bucket_label(bucket) -> str:
    return (f"({bucket.n_pad},{bucket.m_pad},{bucket.n_proc},"
            f"{bucket.t_max}){bucket.layout[0]}")


def run(device: str = "cuda", problems=None, specs=SPECS,
        max_batch: int = MAX_BATCH) -> dict:
    """The specs as one submission. Returns per request its spec, SDR,
    bits (None when lossless), bucket (key and label) and result arrays,
    and the number of buckets."""
    check_device(device)
    svc = SolveService(policy=BucketPolicy(max_batch=max_batch),
                       device=device)
    try:
        reqs, truths = _requests(specs, device, problems)
        results = svc.solve(reqs)
    finally:
        svc.close()
    rows = []
    for spec, res, (s0, prob) in zip(specs, results, truths):
        mse = res.mse(s0)
        rows.append({
            "spec": spec, "policy": spec[6],
            "sdr": float(10 * np.log10(prob.prior.second_moment
                                       / max(mse, 1e-30))),
            "mse": mse,
            # rate units differ per layout: bits/signal-element (row) vs
            # bits/measurement (col) — the bucket's layout letter tells
            "bits": float(res.total_bits) if res.tracked else None,
            "bucket": res.bucket, "bucket_label": _bucket_label(res.bucket),
            "x": res.x, "sigma2_hat": res.sigma2_hat, "deltas": res.deltas,
            "rates": res.rates})
    return {"requests": rows, "n_requests": len(reqs),
            "n_buckets": len({r.bucket for r in results})}


def report(r: dict) -> None:
    print(f"{'policy':>9s} {'eps':>5s} {'snr':>5s} {'N':>5s} {'P':>3s} "
          f"{'T':>3s} {'SDR(dB)':>8s} {'bits/unit':>10s} {'bucket':>20s}")
    for row in r["requests"]:
        eps, snr, n, m, p, t, policy = row["spec"]
        bits = ("  lossless" if row["bits"] is None
                else f"{row['bits']:10.2f}")
        print(f"{policy:>9s} {eps:5.2f} {snr:5.1f} {n:5d} {p:3d} {t:3d} "
              f"{row['sdr']:8.2f} {bits} {row['bucket_label']:>20s}")
    print(f"\n{r['n_requests']} requests ran as {r['n_buckets']} bucketed "
          f"engine calls; per-request results unpadded back to native "
          f"shapes.")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the service runs (default: the card)")
    args = ap.parse_args(argv)
    r = run(device=args.device, specs=SPECS)
    report(r)
    return r


if __name__ == "__main__":
    main()
