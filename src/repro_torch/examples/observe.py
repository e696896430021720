"""Observe a serving run of the port end to end: per-request trace spans,
the live SE-drift monitor and the Prometheus metrics snapshot (the twin of
the JAX package's ``examples/observe.py``; its DESIGN.md §12).

Runs a mixed load through a telemetry-enabled ``SolveService``, prints
each request's span tree and SE drift, renders the service's metrics
registry as Prometheus text, and writes a Chrome trace (``chrome://
tracing`` / Perfetto) of the whole run.

  PYTHONPATH=src python -m repro_torch.examples.observe [--device cpu]
      [--trace-out amp_trace.jsonl]
"""
from __future__ import annotations

import argparse

from ..core.denoisers import BernoulliGauss
from ..core.state_evolution import CSProblem
from ..serving import BucketPolicy, SolveRequest, SolveService
from ..telemetry import (DRIFT_ALERT, hist_quantile, span_names,
                         write_trace_jsonl)
from .common import check_device, draw_problem, to_numpy

__all__ = ["SPECS", "run", "main"]

# Three operating points; the middle one lies about its SNR by 20 dB, so
# the drift monitor should flag it while the honest requests sit well
# under the alert line. (eps, snr_true, snr_declared, N, M, P, T)
SPECS = [
    (0.10, 20.0, 20.0, 1024, 320, 8, 8),    # honest
    (0.10, 20.0,  0.0, 1024, 320, 8, 8),    # declares 0 dB, signal is 20
    (0.02, 25.0, 25.0,  512, 160, 4, 8),    # honest
]
MAX_BATCH = 32


def run(device: str = "cuda", problems=None, specs=SPECS,
        trace_out: str | None = None) -> dict:
    """The specs through a telemetry-enabled service. Returns per request
    its span tree, each span's ms, its drift and whether it alerts; the
    latency p95 estimates; the Prometheus lines of the drift and request
    families; and with ``trace_out`` the span events written there."""
    check_device(device)
    svc = SolveService(policy=BucketPolicy(max_batch=MAX_BATCH),
                       telemetry=True, device=device)
    try:
        reqs = []
        for i, (eps, snr_true, snr_decl, n, m, p, t) in enumerate(specs):
            prior = BernoulliGauss(eps=eps)
            prob = CSProblem(n=n, m=m, prior=prior, snr_db=snr_true)
            _, a, y = draw_problem(i, prob, device,
                                   None if problems is None else problems[i])
            reqs.append(SolveRequest(y=to_numpy(y), a=to_numpy(a),
                                     prior=prior, snr_db=snr_decl, n_proc=p,
                                     n_iter=t, policy="lossless"))
        results = svc.solve(reqs)
        snap = svc.metrics()
        text = svc.metrics_text()
    finally:
        svc.close()
    rows = []
    for spec, res in zip(specs, results):
        rows.append({
            "spec": spec, "tree": span_names(res.spans),
            "spans_ms": [(name, 1e3 * (t1 - t0))
                         for name, _, t0, t1 in res.spans],
            "drift": None if res.se_drift is None else float(res.se_drift),
            "alert": bool(res.se_drift is not None
                          and res.se_drift > DRIFT_ALERT),
            "bucket": res.bucket, "x": res.x, "sigma2_hat": res.sigma2_hat})
    p95 = []
    for metric in snap["metrics"]:
        if metric["name"] != "amp_request_latency_seconds":
            continue
        for sample in metric["samples"]:
            q = hist_quantile(sample, 0.95)
            if q is not None:
                p95.append(float(q))
    out = {"requests": rows, "latency_p95_s": p95,
           "prometheus": [line for line in text.splitlines()
                          if "se_drift" in line or "requests_total" in line],
           "trace_out": trace_out, "trace_events": None}
    if trace_out:
        with open(trace_out, "w") as fp:
            out["trace_events"] = write_trace_jsonl(fp, results)
    return out


def report(r: dict) -> None:
    print("request trace spans + SE drift:")
    for row in r["requests"]:
        _, snr_true, snr_decl, n, m, p, t = row["spec"]
        drift = "   n/a" if row["drift"] is None else f"{row['drift']:6.3f}"
        flag = " <-- ALERT (declared SNR is wrong)" if row["alert"] else ""
        print(f"  N={n:5d} snr_decl={snr_decl:4.1f} (true {snr_true:4.1f})"
              f"  drift {drift}{flag}")
        print(f"    {' -> '.join(row['tree'])}")
        for name, ms in row["spans_ms"]:
            print(f"    {name:>10s}  {ms:8.3f} ms")
    for q in r["latency_p95_s"]:
        print(f"\nlatency p95 (histogram estimate): <= {1e3 * q:.1f} ms")
    print("\nPrometheus snapshot (drift + request families):")
    for line in r["prometheus"]:
        print(f"  {line}")
    if r["trace_out"]:
        print(f"\ntrace: {r['trace_events']} span events -> "
              f"{r['trace_out']}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the service runs (default: the card)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write Chrome trace-event JSONL of the run")
    args = ap.parse_args(argv)
    r = run(device=args.device, specs=SPECS, trace_out=args.trace_out)
    report(r)
    return r


if __name__ == "__main__":
    main()
