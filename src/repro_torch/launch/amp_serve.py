"""AMP solve-service launcher: synthetic heterogeneous load -> SolveService,
on one device (the port of the JAX package's ``launch/amp_serve.py``).

Generates a stream of CS recovery requests with mixed shapes, priors, SNRs
and rate policies, runs them through the shape-bucketed batching service,
and reports per-request quality/rate plus end-to-end throughput.

  PYTHONPATH=src python -m repro_torch.launch.amp_serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.amp_serve --requests 256 \\
      --max-batch 64 --policies fixed,bt,lossless [--device cpu]

The shape menu mixes wide (row-partitioned) and tall (column-partitioned
C-MP-AMP) requests; the summary reports rate totals *per layout* — row
rates are bits per signal element per processor, column rates bits per
measurement per processor. Problems are drawn with numpy from ``--seed``
(the reference draws them with ``jax.random``: the same model, other
numbers). ``--hosts K`` serves through the cluster tier: a
``ClusterService`` routes buckets across K in-process ``SolveService``s
(all on ``--device``: on one card they share it) and autoscales per-bucket
replicas from demand EWMAs on a scraper thread. ``--mesh D`` serves over a
mesh of D ranks (``launch/mesh.py``): this process is rank 0 and owns the
``SolveService(mesh=...)``; it spawns D - 1 worker processes
(``serving.service.serve_mesh_worker``, the spawn start method, a
FileStore rendezvous in a temporary directory), runs the stream, prints
the summary and stops them. The largest shape of the menu (4096 x 512)
runs processor-sharded, the others data-parallel. ``--backend`` is the
mesh's: ``nccl`` (the default on the card: one card a rank) or ``gloo``
(the default on the CPU, and for several ranks sharing one card).

  PYTHONPATH=src python -m repro_torch.launch.amp_serve --smoke --mesh 2 \\
      [--device cpu | --backend gloo]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ..core.denoisers import BernoulliGauss
from ..core.state_evolution import CSProblem
from ..serving import (BucketPolicy, ClusterService, PrewarmSpec,
                       RouterPolicy, SolveRequest, SolveService)

__all__ = ["sample_problem_np", "make_request", "main"]

# (N, M, P) menu — wide shapes (N/M ~ 3.2) route row, tall ones (N/M >=
# 4) route column; P divides every M and every N
SHAPES = [(512, 160, 4), (1024, 320, 8), (2048, 512, 8), (4096, 512, 8)]
EPS_MENU = (0.05, 0.1)
SNR_MENU = (15.0, 20.0, 25.0)


def sample_problem_np(rng: np.random.Generator, n: int, m: int,
                      prior: BernoulliGauss, sigma_e2: float):
    """Draw (s0, A, y) per the paper's model with numpy: A_ij ~ N(0, 1/M),
    e ~ N(0, sigma_e^2); float32 arrays."""
    support = rng.random(n) < prior.eps
    s0 = np.where(support, prior.mu_s + prior.sigma_s * rng.standard_normal(n),
                  0.0).astype(np.float32)
    a = (rng.standard_normal((m, n), dtype=np.float32)
         / np.float32(np.sqrt(m)))
    e = (np.sqrt(sigma_e2) * rng.standard_normal(m)).astype(np.float32)
    return s0, a, (a @ s0 + e).astype(np.float32)


def make_request(rng: np.random.Generator, policies) -> tuple:
    n, m, p = SHAPES[rng.integers(len(SHAPES))]
    # tall shapes undersample harder (kappa = M/N down to 1/8): keep their
    # signals sparse enough to sit inside the AMP recovery region
    eps_menu = (0.02, 0.05) if n >= 4 * m else EPS_MENU
    prior = BernoulliGauss(eps=float(rng.choice(eps_menu)))
    snr = float(rng.choice(SNR_MENU))
    t = int(rng.choice((6, 8, 10)))
    policy = str(rng.choice(policies))
    prob = CSProblem(n=n, m=m, prior=prior, snr_db=snr)
    s0, a, y = sample_problem_np(rng, n, m, prior, prob.sigma_e2)
    kw = {}
    if policy == "fixed":
        deltas = np.full(t, 0.05, np.float32)
        deltas[0] = np.inf
        kw["deltas"] = deltas
    req = SolveRequest(y=y, a=a, prior=prior, snr_db=snr, n_proc=p,
                       n_iter=t, policy=policy, **kw)
    return req, s0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=32)
    ap.add_argument("--policies", default="lossless,fixed,bt",
                    help="comma list from lossless,fixed,dp,bt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the service solves (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="16 requests, small batches, no rate accounting")
    ap.add_argument("--mesh", type=int, default=0, metavar="D",
                    help="serve over a mesh of D ranks: D - 1 worker "
                         "processes beside this one (rank 0)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the mesh's backend (default: nccl on the card, "
                         "gloo on the CPU; gloo for ranks sharing a card)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="serve through the cluster tier with this many "
                         "in-process hosts: a ClusterService routes "
                         "buckets across per-host SolveServices and "
                         "autoscales per-bucket replicas from demand EWMAs")
    ap.add_argument("--prewarm", action="store_true",
                    help="build the kernels and run every program of the "
                         "SHAPES bucket menu before streaming; the summary "
                         "then reports the programs first run after it")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="dump per-request trace spans as Chrome "
                         "trace-event JSONL")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="dump the final metrics snapshot as Prometheus "
                         "text exposition format")
    args = ap.parse_args(argv)
    if args.mesh > 1:
        if args.hosts > 1:
            raise ValueError("--hosts emulates single-device hosts; combine "
                             "with --mesh is not supported")
        return _serve_on_mesh(args)
    return _serve(args)


def _rank_device(device: str):
    """A rank's device from ``--device``: each rank's own card for "cuda"
    (rank % cards; every gloo rank on the one card of a one-card host)."""
    return None if device == "cuda" else device


def _mesh_worker(rank: int, world: int, store: str, backend: str,
                 device: str) -> None:
    from ..serving.service import serve_mesh_worker
    from .mesh import init_cluster, make_serve_mesh
    import torch.distributed as dist
    init_cluster(num_processes=world, process_id=rank, backend=backend,
                 store_path=store, device=_rank_device(device))
    try:
        serve_mesh_worker(make_serve_mesh(device=_rank_device(device)))
    finally:
        dist.destroy_process_group()


def _serve_on_mesh(args):
    """Rank 0 of a mesh of ``args.mesh`` ranks: spawn the workers, serve,
    stop them, join them (each under a deadline)."""
    import multiprocessing as mp
    import torch.distributed as dist
    from .mesh import init_cluster, make_serve_mesh, rank_device
    rank_device(_rank_device(args.device), 0)   # raises without a card
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if args.device.startswith("cuda"):
        # build once here, so the workers (several on one card) only load
        from ..kernels.build import ensure_built
        ensure_built(["amp_local", "amp_col", "quantize"])
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_mesh_worker,
                             args=(r, args.mesh, store, backend, args.device))
                 for r in range(1, args.mesh)]
        for p in procs:
            p.start()
        try:
            init_cluster(num_processes=args.mesh, process_id=0,
                         backend=backend, store_path=store,
                         device=_rank_device(args.device))
            mesh = make_serve_mesh(device=_rank_device(args.device))
            try:
                return _serve(args, mesh)
            finally:
                dist.destroy_process_group()
        finally:
            for p in procs:
                p.join(timeout=60)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            bad = [p.exitcode for p in procs if p.exitcode != 0]
            if bad:
                raise RuntimeError(f"mesh workers exited with {bad}")


def _serve(args, mesh=None):

    n_req = 16 if args.smoke else args.requests
    policies = args.policies.split(",")
    rng = np.random.default_rng(args.seed)
    pairs = [make_request(rng, policies) for _ in range(n_req)]

    cluster = args.hosts > 1
    max_batch = args.max_batch
    if mesh is not None:
        # data-parallel batches pad to a multiple of the mesh
        max_batch = -(-max_batch // mesh.size) * mesh.size
    if cluster:
        svc = ClusterService(
            n_hosts=args.hosts, policy=BucketPolicy(max_batch=args.max_batch),
            router_policy=RouterPolicy(scrape_every_s=0.25,
                                       ewma_halflife_s=2.0),
            rate_accounting=not args.smoke, device=args.device)
    else:
        svc = SolveService(policy=BucketPolicy(max_batch=max_batch),
                           rate_accounting=not args.smoke,
                           device=args.device, mesh=mesh)
    try:
        prewarmed = 0
        if args.prewarm:
            # one spec per (shape, t-bucket, program family): T in {6,8} and
            # {10} pad to distinct t_max buckets; BT solves run a different
            # program (the per-instance table controller)
            fams = [p for p in ("lossless", "bt") if p == "lossless"
                    or "bt" in policies]
            menu = [PrewarmSpec(n=n, m=m, n_proc=p, n_iter=t, policy=fam)
                    for (n, m, p) in SHAPES for t in (8, 12) for fam in fams]
            rep = svc.prewarm(menu)
            if cluster:
                rep = next(iter(rep.values()))     # per-host reports are equal
            prewarmed = rep["programs"] * (args.hosts if cluster else 1)
            print(f"prewarm: {rep['programs']} programs over "
                  f"{len(rep['buckets'])} buckets in {rep['seconds']:.1f}s")
        if cluster:
            # the autoscaler's scrape loop runs on its own daemon thread
            svc.start_scraper()
        t0 = time.time()
        try:
            results = list(svc.stream(r for r, _ in pairs))
        finally:
            if cluster:
                svc.stop_scraper()
        dt = time.time() - t0

        # request ids are assigned in submission order, i.e. pairs[rid]
        print(f"{'id':>4s} {'policy':>9s} {'T':>3s} {'bucket':>22s} {'B':>4s} "
              f"{'mse':>10s} {'bits':>7s}")
        for r in sorted(results, key=lambda res: res.request_id):
            req, s0 = pairs[r.request_id]
            bk = f"({r.bucket.n_pad},{r.bucket.m_pad},{r.bucket.n_proc}," \
                 f"{r.bucket.t_max}){r.bucket.placement[0]}" \
                 f"{r.bucket.layout[0]}"
            # untracked (no finite per-iteration rate) shows "-"; a genuine
            # 0.00-bit total from finite rates still prints as a number
            bits = f"{r.total_bits:7.2f}" if r.tracked else "      -"
            print(f"{r.request_id:4d} {req.policy:>9s} {req.n_iter:3d} "
                  f"{bk:>22s} {r.batch_size:4d} {r.mse(s0):10.3e} {bits}")

        unit = {"row": "bits/elem", "col": "bits/meas"}
        for layout in ("row", "col"):
            in_layout = [r for r in results if r.bucket.layout == layout]
            if not in_layout:
                continue
            tracked = [r for r in in_layout if r.tracked]
            tot = sum(r.total_bits for r in tracked)
            print(f"{layout}: {len(in_layout)} requests, "
                  f"{len(tracked)} rate-tracked, "
                  f"{tot:.1f} {unit[layout]} total"
                  + (f" ({tot / len(tracked):.2f} avg)" if tracked else ""))
        st = svc.stats()
        if cluster:
            _cluster_summary(st, n_req, dt, args.device,
                             prewarmed if args.prewarm else None)
        else:
            oc = st["operand_cache"]
            on = (f"{svc.device}" if mesh is None else
                  f"a mesh of {mesh.size} {mesh.backend} ranks "
                  f"({svc.device} and the workers')")
            print(f"\n{n_req} requests in {dt:.2f}s  "
                  f"({n_req / dt:.1f} req/s on {on}, "
                  f"{len(svc._engines)} bucket engines)")
            if mesh is not None:
                placed = {}
                for r in results:
                    placed[r.bucket.placement] = placed.get(
                        r.bucket.placement, 0) + 1
                print(f"placements: {placed}; collectives "
                      f"{mesh.stats.snapshot()['calls']}")
            print(f"hot path: {st['compiles']['total']} programs run"
                  + (f" ({st['compiles']['total'] - prewarmed} after prewarm)"
                     if args.prewarm else "")
                  + f", operand cache {oc['hits']} hits / {oc['misses']} "
                  f"misses ({oc['bytes'] / (1 << 20):.1f} MiB), "
                  f"{st['singleton_dispatches']} singleton dispatches")

        drifts = [r.se_drift for r in results
                  if r.se_drift is not None and np.isfinite(r.se_drift)]
        if drifts:
            from ..telemetry import DRIFT_ALERT
            alerts = sum(1 for d in drifts if d > DRIFT_ALERT)
            print(f"se drift: median {float(np.median(drifts)):.3f}, "
                  f"max {max(drifts):.3f}, {alerts} alert(s) over "
                  f"{len(drifts)} monitored requests")
        if args.trace_out:
            from ..telemetry import write_trace_jsonl
            with open(args.trace_out, "w") as fp:
                n_ev = write_trace_jsonl(fp, results)
            print(f"trace: {n_ev} span events -> {args.trace_out}")
        if args.metrics_out:
            with open(args.metrics_out, "w") as fp:
                fp.write(svc.metrics_text())
            print(f"metrics: Prometheus snapshot -> {args.metrics_out}")
    finally:
        if cluster or mesh is not None:
            svc.close()
    return results


def _cluster_summary(st: dict, n_req: int, dt: float, device: str,
                     prewarmed: int | None) -> None:
    """The cluster tier's summary: per-host hot-path stats rolled up, the
    scheduler's routing and autoscaling view, and the fault counters when
    any fired."""
    hosts = st["hosts"]
    programs = sum(h["compiles"]["total"] for h in hosts.values())
    hits = sum(h["operand_cache"]["hits"] for h in hosts.values())
    misses = sum(h["operand_cache"]["misses"] for h in hosts.values())
    rt = st["router"]
    print(f"\n{n_req} requests in {dt:.2f}s  ({n_req / dt:.1f} req/s, "
          f"{len(hosts)} hosts on {device})")
    print(f"hot path: {programs} programs run"
          + (f" ({programs - prewarmed} after prewarm)"
             if prewarmed is not None else "")
          + f", operand cache {hits} hits / {misses} misses")
    print(f"router: served {rt['served']} (cost imbalance "
          f"{rt['imbalance']:.2f}x), {st['shed']} shed; autoscaler events: "
          f"{st['autoscaler']['events'] or 'none'}")
    faults = {k: st[k] for k in
              ("failovers", "retries", "hedges", "lost", "degraded")
              if st.get(k)}
    unhealthy = {h: s for h, s in st["host_states"].items()
                 if s != "healthy"}
    if faults or unhealthy:
        rec = st.get("recovery") or {}
        print("faults: " + ", ".join(f"{k} {v}" for k, v in faults.items())
              + (f"; states {unhealthy}" if unhealthy else "")
              + (f"; recovery p95 {rec['p95_ms']:.1f}ms (n={rec['count']})"
                 if rec else ""))


if __name__ == "__main__":
    main()
