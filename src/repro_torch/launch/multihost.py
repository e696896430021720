"""Multi-process cluster launcher (the port of the JAX package's
``launch/multihost.py``; its DESIGN.md §11 and §13 describe the design),
with plain subprocesses: nothing here needs a collective, so there is no
distributed runtime to join.

Run with no cluster environment, this module is the **parent**: it builds
the kernels the children will launch (on the card; the build is one
``nvcc`` each, all at once, and a child then only loads the libraries),
picks free ports, spawns one child per process (the same interpreter and
argv) with ``AMP_COORDINATOR`` (the frontend's address),
``AMP_NUM_PROCESSES``, ``AMP_PROCESS_ID`` and ``AMP_BACKEND_PORTS``, waits
for them with a deadline and returns the worst child exit code.

With ``AMP_PROCESS_ID`` set it is a **child**:

  * process 1..K-1 each serve a ``SolveService`` behind a
    ``BackendServer`` (codec frames on TCP, no pickle) until the frontend
    sends the shutdown op, and
  * process 0, the frontend, builds a ``ClusterService`` over its own
    ``LocalBackend`` and one ``TcpBackend`` per remote, prewarms the
    menu, streams a smoke load, and holds the invariants: results bit for
    bit those of a single-host ``SolveService`` on the same stream, no
    program first run after prewarm, every host served. It prints each
    remote's frame round-trip times.

Every process runs on ``--device`` (the card unless asked for the CPU;
on a one-card machine all of them share it).

  PYTHONPATH=src python -m repro_torch.launch.multihost --smoke [--device cpu]

``--chaos`` is the two-process fault drill: the frontend submits the whole
stream, then kills host1's backend process with results still buffered
there (the ``X`` frame op), and the gate is that the flush recovers every
request over the TCP path: none lost, one failover, host1 evicted as dead,
recovery latency measured, and the results bit for bit the single host's.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

__all__ = ["main", "parent", "child", "make_load"]

# the smoke load: a row bucket of fixed-schedule requests (the reference's)
N, M, P, T = 128, 64, 4, 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parent(args, argv) -> int:
    if args.device.startswith("cuda"):
        # build once here, so the children (several on one card) load
        from ..kernels.build import ensure_built
        ensure_built(["amp_local", "amp_col", "quantize"])
    ports = [_free_port() for _ in range(args.processes)]
    env = dict(os.environ)
    env.update({
        "AMP_COORDINATOR": f"127.0.0.1:{ports[0]}",
        "AMP_NUM_PROCESSES": str(args.processes),
        "AMP_BACKEND_PORTS": ",".join(map(str, ports[1:])),
    })
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.multihost", *argv],
        env=dict(env, AMP_PROCESS_ID=str(pid)))
        for pid in range(args.processes)]
    deadline = time.monotonic() + args.timeout
    codes = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            try:
                codes.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    print(f"multihost parent: child exit codes {codes}")
    return max(abs(c) for c in codes)


def make_load(n_req: int, seed: int = 0):
    """``n_req`` fixed-schedule row requests (N, M, P, T above), problems
    drawn with numpy from ``seed``: ``(prior, requests)``."""
    import numpy as np

    from ..core.denoisers import BernoulliGauss
    from ..core.state_evolution import CSProblem
    from ..serving import SolveRequest
    from .amp_serve import sample_problem_np

    prior = BernoulliGauss(eps=0.1)
    prob = CSProblem(n=N, m=M, prior=prior, snr_db=20.0)
    deltas = np.full(T, 0.05, np.float32)
    deltas[0] = np.inf
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_req):
        _, a, y = sample_problem_np(rng, N, M, prior, prob.sigma_e2)
        reqs.append(SolveRequest(y=y, a=a, prior=prior, n_proc=P,
                                 n_iter=T, policy="fixed", deltas=deltas))
    return prior, reqs


def child(args) -> int:
    pid = int(os.environ["AMP_PROCESS_ID"])
    n_proc = int(os.environ["AMP_NUM_PROCESSES"])
    ports = [int(p) for p in os.environ["AMP_BACKEND_PORTS"].split(",") if p]
    if n_proc != args.processes or len(ports) != n_proc - 1:
        print(f"multihost[{pid}]: bad cluster environment "
              f"({n_proc} processes, ports {ports})")
        return 2
    print(f"multihost[{pid}]: {n_proc} processes, frontend at "
          f"{os.environ.get('AMP_COORDINATOR')}, device {args.device}")

    from ..serving import BucketPolicy, PrewarmSpec, SolveService
    from ..serving.frontend import BackendServer, LocalBackend

    policy = BucketPolicy(max_batch=8, n_quantum=64, mp_quantum=8)
    make_service = lambda: SolveService(policy=policy, rate_accounting=False,
                                        device=args.device)

    if pid != 0:
        # backend process: serve until the frontend's shutdown op (or, if
        # the frontend never comes, until the parent's deadline kills it)
        server = BackendServer(LocalBackend(f"host{pid}", make_service()),
                               port=ports[pid - 1])
        print(f"multihost[{pid}]: backend on :{server.port}", flush=True)
        server.serve_forever()
        return 0

    import numpy as np

    from ..serving import ClusterService, RouterPolicy
    from ..serving.frontend import TcpBackend
    from ..serving.wire import BackendUnavailable

    backends = [LocalBackend("host0", make_service())]
    for i, port in enumerate(ports, start=1):
        deadline = time.monotonic() + args.connect_wait
        while True:       # the backend process may still be starting
            try:
                backends.append(TcpBackend(
                    ("127.0.0.1", port), f"host{i}",
                    connect_timeout_s=5.0, recv_timeout_s=120.0))
                break
            except BackendUnavailable:
                if time.monotonic() > deadline:
                    print(f"multihost[0]: backend host{i} on :{port} "
                          "never came up")
                    return 2
                time.sleep(0.5)

    rp = RouterPolicy(min_replicas=len(backends))
    if args.chaos:
        # fast detection: one failed call suspects, two evict
        rp = RouterPolicy(min_replicas=len(backends), suspect_after=1,
                          dead_after=2, retry_limit=2, retry_backoff_s=0.05)
    cluster = ClusterService(backends=backends, policy=policy,
                             router_policy=rp)
    prior, reqs = make_load(args.requests)
    menu = [PrewarmSpec(n=N, m=M, n_proc=P, n_iter=T, policy="fixed",
                        prior=prior, batch_widths=(8,))]
    cluster.prewarm(menu)
    # per-host warm counts: a host that dies in the drill drops out of the
    # cluster-wide count, so programs after prewarm compare per survivor
    warm = {hid: b.compile_count() for hid, b in cluster.backends.items()}

    t0 = time.time()
    if args.chaos:
        ids = [cluster.submit(r) for r in reqs]
        stranded = sum(1 for hk in cluster._inflight if hk[0] == "host1")
        cluster.backends["host1"].kill_server()
        print(f"multihost[0]: chaos — killed host1 with {stranded} "
              f"requests in flight there")
        own = set(ids)
        results = sorted((r for r in cluster.flush() if r.request_id in own),
                         key=lambda r: r.request_id)
    else:
        results = sorted(cluster.solve(reqs), key=lambda r: r.request_id)
    dt = time.time() - t0

    # the single-host reference on the same stream: the same padded
    # widths, the same programs, the same bits
    ref_svc = make_service()
    ref_svc.prewarm(menu)
    ref = ref_svc.solve(reqs)
    max_dx = max(float(np.max(np.abs(c.x - r.x)))
                 for c, r in zip(results, ref)) if results else float("nan")

    st = cluster.stats()
    served = st["router"]["served"]
    steady = sum(b.compile_count() - warm[hid]
                 for hid, b in cluster.backends.items()
                 if cluster.router.host_state(hid) != "dead")
    print(f"multihost[0]: {len(results)} results in {dt:.2f}s over "
          f"{len(backends)} hosts; served {served}; programs after "
          f"prewarm {steady}; max|dx| {max_dx:.1e}; imbalance "
          f"{st['router']['imbalance']:.2f}x")
    if args.chaos:
        rec = st["recovery"] or {}
        print(f"multihost[0]: chaos — states {st['host_states']}; "
              f"failovers {st['failovers']}, retries {st['retries']}, "
              f"lost {st['lost']}; recovery p95 "
              f"{rec.get('p95_ms', float('nan')):.1f}ms "
              f"(n={rec.get('count', 0)})")
    for host_id, per_op in cluster.rtt_stats().items():
        line = "  ".join(f"{op}: p50 {s['p50_ms']:.3f}ms "
                         f"p95 {s['p95_ms']:.3f}ms (n={s['count']})"
                         for op, s in per_op.items())
        print(f"multihost[0]: {host_id} frame rtt  {line}")
    cluster.close(shutdown_remote=True)

    failures = []
    if len(results) != len(reqs):
        failures.append(f"{len(reqs) - len(results)} results missing")
    if max_dx != 0.0:
        failures.append(f"cluster differs from single-host: "
                        f"max|dx|={max_dx:.2e}")
    if steady != 0:
        failures.append(f"{steady} programs first run after prewarm")
    if any(v == 0 for v in served.values()):
        failures.append(f"idle host in {served}")
    if args.chaos:
        if st["lost"] != 0:
            failures.append(f"{st['lost']} requests lost in failover")
        if st["failovers"] != 1:
            failures.append(f"expected 1 failover, saw {st['failovers']}")
        if st["retries"] == 0:
            failures.append("no retries counted despite a host kill")
        if st["host_states"].get("host1") != "dead":
            failures.append(f"host1 not evicted: {st['host_states']}")
        if not st["recovery"]:
            failures.append("no recovery latency recorded")
    for msg in failures:
        print(f"multihost[0]: FAIL: {msg}")
    return 1 if failures else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="where every process solves (default: the card)")
    ap.add_argument("--smoke", action="store_true", help="16 requests")
    ap.add_argument("--chaos", action="store_true",
                    help="kill one backend process mid-stream and gate on "
                         "a failover that loses nothing")
    ap.add_argument("--connect-wait", type=float, default=120.0,
                    help="seconds the frontend waits for a backend to "
                         "start listening")
    ap.add_argument("--timeout", type=float, default=420.0,
                    help="parent-side wall clock before the children are "
                         "killed (exit 124)")
    args = ap.parse_args(argv)
    if args.processes < 2:
        ap.error("--processes must be at least 2")
    if args.smoke:
        args.requests = 16
    if os.environ.get("AMP_PROCESS_ID") is None:
        return parent(args, argv)
    return child(args)


if __name__ == "__main__":
    sys.exit(main())
