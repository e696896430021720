"""Cluster-style MP-AMP on the port: the paper's P=30 experiment and the
mesh-distributed solver with compressed-psum fusion on 8 ranks (the twin
of the JAX package's ``examples/mp_amp_cluster.py``).

Part 1 reproduces a Table-1 column (eps=0.05): BT against DP rate
allocation with real ECSQ quantizers and empirical-entropy rate
accounting; the RD model reads the committed ``.cache/rd_*.npz``.
Part 2 runs the same algorithm as SPMD over a ``torch.distributed`` mesh
(``DistributedMPAMP``), fusing with the int8 / int4 compressed psum,
including straggler-tolerant partial fusion. The reference emulates 8
devices; here the 8 ranks are spawned processes (``launch/mesh.py::
spawn_world``): gloo ranks on the CPU, or gloo ranks sharing one card
(NCCL refuses two ranks on one GPU). On the card every local-computation
step is the fused row kernel (K1) and the compressed psum runs the block
quantizer and its inverse (K4).

  PYTHONPATH=src python -m repro_torch.examples.mp_amp_cluster
      [--device cpu] [--ranks 8] [--part 1|2|both]
"""
from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import tempfile
import time

import numpy as np

from ..core.amp import amp_solve
from ..core.denoisers import BernoulliGauss, make_mmse_interp
from ..core.engine import DPSchedule
from ..core.mp_amp import MPAMPConfig, mp_amp_solve
from ..core.rate_alloc import BTController, dp_allocate
from ..core.rate_distortion import RDModel
from ..core.state_evolution import PAPER_T, CSProblem
from ..kernels import launch_counts
from ..launch.mesh import spawn_world
from ..launch.solver import DistributedMPAMP, SolverConfig
from .common import check_device, draw_problem, sdr_db, to_numpy

__all__ = ["SOLVERS", "part1", "part2", "run", "main"]

EPS1, P1 = 0.05, 30
N2, M2, EPS2, T2, RANKS = 4000, 1200, 0.1, 15, 8
PAPER_BITS = {"bt": 49.19, "dp": 22.55}
SOLVERS = [("exact fusion        ", dict(bits=None)),
           ("int8 compressed psum", dict(bits=8)),
           ("int4 compressed psum", dict(bits=4)),
           ("int8 + 15% straggler", dict(bits=8, drop_rate=0.15))]
WIRE = {None: "32-bit", 8: "~8-bit", 4: "~4-bit"}


def part1(device: str = "cuda", problem=None, seed: int = 0) -> dict:
    """The paper's point: centralized AMP, BT- and DP-rated MP-AMP."""
    check_device(device)
    prior = BernoulliGauss(eps=EPS1)
    prob = CSProblem(prior=prior)
    t = PAPER_T[EPS1]
    if problem is not None:
        prob = CSProblem(n=problem[1].shape[1], m=problem[1].shape[0],
                         prior=prior)
    rd = RDModel(prior)
    mm = make_mmse_interp(prior)
    s0, a, y = draw_problem(seed, prob, device, problem)
    cfg = MPAMPConfig(P1, t, device=device)

    cen = amp_solve(y, a, prior, t, s0=s0, device=device)
    ctrl = BTController(prob, P1, t, 1.005, 6.0, "ecsq", mmse_fn=mm)
    bt = mp_amp_solve(y, a, prior, cfg, ctrl, s0=s0)
    dp = dp_allocate(prob, P1, t, 2.0 * t, rd=rd, mmse_fn=mm)
    deltas = DPSchedule(dp, rd, P1).deltas
    dps = mp_amp_solve(y, a, prior, cfg, deltas, s0=s0,
                       sigma2_for_model=dp.sigma2_d[:-1])
    return {"eps": EPS1, "n_proc": P1, "n_iter": t, "n": prob.n,
            "m": prob.m,
            "sdr_centralized": sdr_db(prior, cen.mse[-1]),
            "bits_centralized": 32 * t,
            "sdr_bt": sdr_db(prior, bt.mse[-1]),
            "bits_bt": float(bt.total_bits_empirical),
            "sdr_dp": sdr_db(prior, dps.mse[-1]),
            "bits_dp": float(dps.total_bits_empirical),
            "paper_bits": dict(PAPER_BITS),
            "mse": {"centralized": cen.mse, "bt": bt.mse, "dp": dps.mse},
            "x": {"centralized": cen.x, "bt": bt.x, "dp": dps.x},
            "deltas": {"bt": bt.deltas, "dp": dps.deltas},
            "dp_deltas_planned": np.asarray(deltas)}


def _part2_rank(mesh, a, y, eps: float, n_iter: int, solvers,
                check_kernels: bool = False) -> dict:
    """One rank of part 2: every solver configuration on the mesh, then
    this process's kernel launches; with ``check_kernels``, then K1 held
    against its plain version on the inputs of its first calls at each
    shape (``kernels.amp_fused.check``; none on the CPU)."""
    from ..kernels.amp_fused.check import captured_inputs, check_captured
    prior = BernoulliGauss(eps=eps)
    out = {"started": time.time()}
    with (captured_inputs() if check_kernels
          else contextlib.nullcontext({})) as seen:
        for label, kw in solvers:
            t0 = time.perf_counter()
            x, s2, nv = DistributedMPAMP(
                mesh, prior, SolverConfig(n_iter=n_iter, **kw)).solve(a, y)
            out[label] = {"x": x, "sigma2_hat": s2, "noise_var": nv,
                          "seconds": time.perf_counter() - t0}
    out["launches"] = launch_counts()
    t0 = time.perf_counter()
    out["kernel_checks"] = check_captured(seen)
    out["kernel_check_seconds"] = time.perf_counter() - t0
    return out


def part2(device: str = "cuda", ranks: int = RANKS, problem=None,
          seed: int = 1, timeout_s: float = 600.0,
          check_kernels: bool = False) -> dict:
    """The mesh solver on ``ranks`` spawned gloo ranks on ``device`` (on
    the card they share it). Returns per configuration the SDR, the wire,
    the mean quantization-noise variance and rank 0's seconds, each rank's
    launches, whether every rank returned the same x, and the seconds from
    the spawn until every rank had started; with ``check_kernels`` each
    rank's rows of ``check_captured`` (K1 against its plain version at the
    rank's shapes, after its launches are read)."""
    dev = check_device(device)
    prior = BernoulliGauss(eps=EPS2)
    prob = CSProblem(n=N2, m=M2, prior=prior)
    if problem is not None:
        prob = CSProblem(n=problem[1].shape[1], m=problem[1].shape[0],
                         prior=prior)
    s0, a, y = draw_problem(seed, prob, device, problem)
    a, y = to_numpy(a), to_numpy(y)
    if dev.type == "cuda":
        # the ranks only load the kernels: built here, once, before them
        from ..kernels import build
        build.ensure_built(["amp_local", "quantize"])
    store = tempfile.mkdtemp(prefix="amp_cluster_")
    t0, wall0 = time.perf_counter(), time.time()
    try:
        res = spawn_world(_part2_rank, ranks, backend="gloo",
                          device=str(dev), store_path=os.path.join(
                              store, "store"),
                          args=(a, y, EPS2, T2, SOLVERS,
                                check_kernels),
                          timeout_s=timeout_s,
                          threads=1 if dev.type == "cpu" else None)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    seconds = time.perf_counter() - t0
    rows = []
    for label, kw in SOLVERS:
        got = res[0][label]
        x = got["x"]
        rows.append({
            "label": label, "bits": kw.get("bits"),
            "drop_rate": kw.get("drop_rate", 0.0),
            "sdr": float(10 * np.log10(prior.second_moment
                                       / np.mean((x - s0) ** 2))),
            "mse": float(np.mean((x - s0) ** 2)),
            "wire": WIRE[kw.get("bits")],
            "noise_var": float(np.asarray(got["noise_var"]).mean()),
            "seconds": got["seconds"],
            "x": x, "sigma2_hat": got["sigma2_hat"],
            "ranks_agree": all(np.array_equal(r[label]["x"], x)
                               for r in res[1:])})
    return {"n": prob.n, "m": prob.m, "eps": EPS2, "n_iter": T2,
            "ranks": ranks, "rows": rows, "seconds": seconds,
            # from the spawn to the last rank's first line of its work
            "start_seconds": max(r["started"] for r in res) - wall0,
            "launches": [r["launches"] for r in res],
            "kernel_checks": [r["kernel_checks"] for r in res],
            "kernel_check_seconds": max(r["kernel_check_seconds"]
                                        for r in res)}


def run(device: str = "cuda", ranks: int = RANKS, parts=(1, 2),
        problem1=None, problem2=None) -> dict:
    """Part 1 and part 2 (``parts``), each as ``part1`` / ``part2``."""
    out = {}
    if 1 in parts:
        out["part1"] = part1(device, problem1)
    if 2 in parts:
        out["part2"] = part2(device, ranks, problem2)
    return out


def report(r: dict) -> None:
    if "part1" in r:
        p1 = r["part1"]
        print(f"=== Part 1: paper experiment (eps={p1['eps']}, "
              f"P={p1['n_proc']}, T={p1['n_iter']}) ===")
        print(f"centralized : SDR {p1['sdr_centralized']:6.2f} dB, "
              f"{p1['bits_centralized']} bits/elem")
        print(f"BT-MP-AMP   : SDR {p1['sdr_bt']:6.2f} dB, "
              f"{p1['bits_bt']:6.2f} bits/elem (paper: "
              f"{p1['paper_bits']['bt']})")
        print(f"DP-MP-AMP   : SDR {p1['sdr_dp']:6.2f} dB, "
              f"{p1['bits_dp']:6.2f} bits/elem (paper: "
              f"{p1['paper_bits']['dp']})")
    if "part2" in r:
        p2 = r["part2"]
        print(f"\n=== Part 2: SPMD mesh solver ({p2['ranks']} ranks, int8 "
              f"fusion) ===")
        for row in p2["rows"]:
            print(f"{row['label']}: SDR {row['sdr']:6.2f} dB  (wire "
                  f"{row['wire']}, quant-noise var {row['noise_var']:.2e})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the solves and the ranks run (default: "
                         "the card)")
    ap.add_argument("--ranks", type=int, default=RANKS,
                    help="part 2's mesh size (the reference's 8 devices)")
    ap.add_argument("--part", choices=("1", "2", "both"), default="both")
    args = ap.parse_args(argv)
    parts = (1, 2) if args.part == "both" else (int(args.part),)
    r = run(device=args.device, ranks=args.ranks, parts=parts)
    report(r)
    return r


if __name__ == "__main__":
    main()
