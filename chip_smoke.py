#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--out results.json]

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, holds each
against its plain PyTorch version on the card, drives the port's main path
— the row-layout MP-AMP solve at the paper's size (N=10000, M=3000, P=30,
eps=0.05, 20 dB, T=10): centralized, lossless, DP-rated and BT-rated ECSQ
fusion, and a batch of 8 — through the entry points a user calls, checks
the results, and times the kernels against their bounds.

Prints one JSON object per phase (device, build, kernel_check, reference,
solve, timing), then ``{"kernels": [...]}``, then as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the exit
code is non-zero and the last line is not printed. ``--out`` also writes all
of it to one JSON file. Needs a CUDA device and nvcc; needs no network.
Takes under a minute on an H100.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
             "this script needs one CUDA device")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.amp import amp_solve, sample_problem  # noqa: E402
from repro_torch.core.denoisers import (BernoulliGauss,  # noqa: E402
                                        make_mmse_interp)
from repro_torch.core.engine import (AmpEngine, DPSchedule,  # noqa: E402
                                     EcsqTransport, EngineConfig,
                                     FixedSchedule, bt_delta_for)
from repro_torch.core.mp_amp import MPAMPConfig, mp_amp_solve  # noqa: E402
from repro_torch.core.rate_alloc import BTController, dp_allocate  # noqa: E402
from repro_torch.core.rate_distortion import RDModel  # noqa: E402
from repro_torch.core.state_evolution import (PAPER_T, CSProblem,  # noqa: E402
                                              se_trajectory)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.amp_fused import amp_fused as k  # noqa: E402
from repro_torch.kernels.amp_fused import ref  # noqa: E402

DEV = torch.device("cuda:0")
SOURCE = "src/repro_torch/csrc/amp_local.cu"
REPLACES = {"amp_local_z": "src/repro/kernels/amp_fused/amp_fused.py:102",
            "amp_local_f": "src/repro/kernels/amp_fused/amp_fused.py:123"}

# NVIDIA H100 SXM data sheet: device memory rate and float32 rate outside
# the tensor cores (the kernels do float32 FMAs on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# The paper's operating point (Sec. 4) at full width.
N, M, P, EPS, SNR_DB = 10_000, 3_000, 30, 0.05, 20.0
T = PAPER_T[EPS]
BATCH = 8
KERNEL_RTOL = 1e-5      # max |kernel - plain| / max |plain|, float32 sums in
                        # different orders; bf16 A: both sides get the same
                        # bf16 matrix and accumulate in float32
SEED = 1234

RESULT: dict = {}


def emit(phase: str, **fields) -> None:
    RESULT[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


_BUSY: dict = {}


def _keep_device_busy() -> None:
    """Enqueue several milliseconds of unrelated work (a float32 matrix
    product), so that the calls enqueued next wait in the stream and run
    back to back: the events around them then see device time, not the
    host's pace of launching. It also leaves the L2 full of other data."""
    if not _BUSY:
        _BUSY["m"] = torch.randn(6144, 6144, device=DEV)
        _BUSY["out"] = torch.empty_like(_BUSY["m"])
    torch.mm(_BUSY["m"], _BUSY["m"], out=_BUSY["out"])


def time_ms(fn, repeats: int = 7, inner: int = 5, warmup: int = 2) -> dict:
    """Device time of one call of ``fn``: CUDA events around ``inner`` calls
    queued behind a busy device, median over ``repeats``. ``host_paced`` is
    true when, in any repeat, the device had already drained the queue
    when the last call was enqueued — the time is then the host's, not
    the kernels'. The A operands exceed (float32) or about equal
    (bfloat16) the 50 MB L2, so calls find A mostly cold, as the solve
    loop does."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times, host_paced = [], False
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        _keep_device_busy()
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        host_paced |= stop.query()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return {"ms": statistics.median(times), "host_paced": host_paced}


def time_call_ms(fn, repeats: int = 5, warmup: int = 1) -> float:
    """Time of one call as its caller sees it, host pace included: CUDA
    events around a single call on an idle device, median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

SHAPES = [
    # name, B (None = unbatched), shared A, P, Mp, N
    ("paper_P30", None, False, P, M // P, N),
    ("centralized_P1", None, False, 1, M, N),
    ("ragged_odd_N", None, False, 7, 33, 1001),
    ("batch8_per_instance_A", BATCH, False, P, M // P, N),
    ("batch8_shared_A", BATCH, True, P, M // P, N),
]


def lc_inputs(b, shared, p, mp, n, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    lead = () if b is None else (b,)
    a_lead = () if (b is None or shared) else (b,)
    rnd = lambda *s: torch.randn(*s, generator=g, device=DEV)
    a = (rnd(*a_lead, p, mp, n) / (p * mp) ** 0.5).to(dtype).contiguous()
    x, y, z = rnd(*lead, n), rnd(*lead, p, mp), rnd(*lead, p, mp)
    ons = torch.rand(lead, generator=g, device=DEV)
    return a, x, y, z, ons


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def lc_bounds(b, shared, p, mp, n, dtype):
    """Least time for the z-pass and the f-pass: every input read once,
    every output written once, over the memory rate; against the float32
    operations over the CUDA-core rate. Returns ms and which one binds."""
    bb = 1 if b is None else b
    a_bytes = (1 if shared else bb) * p * mp * n * (2 if dtype == torch.bfloat16 else 4)
    z_bytes = a_bytes + 4 * bb * (n + 3 * p * mp + 2)       # x, y, z, z', ons, ss
    f_bytes = a_bytes + 4 * bb * (p * mp + n + p * n)       # z', x, f
    flops = 2.0 * bb * p * mp * n
    out = {}
    for name, nbytes in (("amp_local_z", z_bytes), ("amp_local_f", f_bytes)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
        out[name] = {"bound_ms": 1e3 * max(t_b, t_o),
                     "bound_by": "bytes" if t_b >= t_o else "operations",
                     "bytes": nbytes, "flops": flops}
    return out


def check_kernels() -> dict:
    rows = []
    for name, b, shared, p, mp, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a, x, y, z, ons = lc_inputs(b, shared, p, mp, n, dtype, SEED)
            z_k, ss_k = k.amp_local_z_cuda(a, x, y, z, ons)
            torch.cuda.synchronize()
            f_k = k.amp_local_f_cuda(a, z_k, x, P)
            torch.cuda.synchronize()
            z_r, ss_r = ref.amp_local_z_ref(a, x, y, z, ons)
            f_r = ref.amp_local_f_ref(a, z_k, x, P)     # same z' into both
            torch.cuda.synchronize()
            _, ss_again = k.amp_local_z_cuda(a, x, y, z, ons)
            torch.cuda.synchronize()
            row = {"shape": name, "a_dtype": str(dtype).split(".")[-1],
                   "B": b, "shared_a": shared, "P": p, "Mp": mp, "N": n,
                   "vec": k.vec_width(n, dtype),
                   "z_rel_err": rel_err(z_k, z_r),
                   "ss_rel_err": rel_err(ss_k, ss_r),
                   "f_rel_err": rel_err(f_k, f_r),
                   "z_max_abs_err": float((z_k - z_r).abs().max()),
                   "f_max_abs_err": float((f_k - f_r).abs().max()),
                   "ss_bit_identical": bool(torch.equal(ss_k, ss_again))}
            rows.append(row)
            assert z_k.shape == y.shape and f_k.shape == y.shape[:-1] + (n,)
            assert ss_k.shape == y.shape[:-2]
            for key in ("z_rel_err", "ss_rel_err", "f_rel_err"):
                assert row[key] <= KERNEL_RTOL, (row, key)
            assert row["ss_bit_identical"], row
            del a, x, y, z, z_k, f_k, z_r, f_r
    emit("kernel_check", rtol=KERNEL_RTOL, cases=rows)
    return {(r["shape"], r["a_dtype"]): r for r in rows}


def check_against_cpu_reference() -> None:
    """End to end on a small input: the card (CUDA kernels) against the CPU
    (plain versions), same numpy-made problem; lossless, so no quantizer
    cell can differ and x agrees to float32 rounding."""
    n, m, p, t = 1000, 300, 6, 8
    rng = np.random.default_rng(SEED)
    prior = BernoulliGauss(0.1)
    prob = CSProblem(n=n, m=m, prior=prior)
    s0 = (rng.random(n) < 0.1) * rng.normal(size=n)
    a = (rng.normal(size=(m, n)) / np.sqrt(m)).astype(np.float32)
    y = (a @ s0 + np.sqrt(prob.sigma_e2) * rng.normal(size=m)).astype(np.float32)
    out = {}
    for a_dtype in ("float32", "bfloat16"):
        runs = {}
        for dev in ("cuda", "cpu"):
            eng = AmpEngine(prior, EngineConfig(n_proc=p, n_iter=t, device=dev,
                                                a_dtype=a_dtype),
                            EcsqTransport(), FixedSchedule([np.inf] * t))
            runs[dev] = eng.solve(y, a)
        dx = float(np.abs(runs["cuda"].x - runs["cpu"].x).max())
        ds = float(np.abs(runs["cuda"].sigma2_hat / runs["cpu"].sigma2_hat - 1).max())
        out[a_dtype] = {"max_abs_dx": dx, "max_rel_dsigma2": ds}
        assert np.all(np.isfinite(runs["cuda"].x)) and runs["cuda"].x.shape == (n,)
        assert dx <= 1e-4 and ds <= 1e-3, out
    emit("reference", small_problem={"N": n, "M": m, "P": p, "T": t},
         card_vs_cpu=out, limits={"max_abs_dx": 1e-4, "max_rel_dsigma2": 1e-3})


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def sdr_db(prior, mse: float) -> float:
    return float(10.0 * np.log10(prior.second_moment / max(mse, 1e-30)))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def run_main_path() -> dict:
    prior = BernoulliGauss(eps=EPS)
    prob = CSProblem(n=N, m=M, prior=prior, snr_db=SNR_DB)
    t0 = time.perf_counter()
    mm = make_mmse_interp(prior)
    rd = RDModel(prior)                      # table from the committed cache
    dp = dp_allocate(prob, P, T, 2.0 * T, rd=rd, mmse_fn=mm)
    dp_sched = DPSchedule(dp, rd, P)
    bt = BTController(prob, P, T, c_ratio=1.005, r_max=6.0,
                      rate_model="ecsq", mmse_fn=mm)
    setup_s = time.perf_counter() - t0

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    s0, a, y = sample_problem(gen, N, M, prior, prob.sigma_e2, device="cuda")
    s0_np = s0.cpu().numpy()
    cfg = MPAMPConfig(P, T)                  # device: the default, the card

    k.reset_launch_counts()
    counts = {}
    wall = {}

    def counted(name, fn):
        before = dict(k.launch_counts)
        out, wall[name] = timed(fn)
        counts[name] = {key: k.launch_counts[key] - before[key]
                        for key in before}
        return out

    cen = counted("amp_solve", lambda: amp_solve(y, a, prior, T, s0=s0_np))
    ll = counted("lossless", lambda: mp_amp_solve(y, a, prior, cfg,
                                                  [np.inf] * T, s0=s0_np))
    dpr = counted("dp", lambda: mp_amp_solve(
        y, a, prior, cfg, dp_sched, s0=s0_np,
        sigma2_for_model=dp.sigma2_d[:-1]))
    btr = counted("bt", lambda: mp_amp_solve(y, a, prior, cfg, bt, s0=s0_np))

    # a batch of 8 distinct problems, symbols off (memory), BT-rated
    gen_b = torch.Generator(device=DEV).manual_seed(SEED + 1)
    probs = [sample_problem(gen_b, N, M, prior, prob.sigma_e2, device="cuda")
             for _ in range(BATCH)]
    a_b = torch.stack([q[1] for q in probs])
    y_b = torch.stack([q[2] for q in probs])
    s0_b = np.stack([q[0].cpu().numpy() for q in probs])
    del probs
    eng_b = AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T,
                                          collect_symbols=False),
                      EcsqTransport(), bt._in_graph)
    many = counted("solve_many", lambda: eng_b.solve_many(y_b, a_b))
    main_path_launches = dict(k.launch_counts)      # read just after
    # instance 0 once more on its own, to hold the batch against
    one = AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T,
                                        collect_symbols=False),
                    EcsqTransport(), bt._in_graph).solve(y_b[0], a_b[0])
    del a_b, y_b

    # ---- checks -----------------------------------------------------------
    sdr = {"centralized": sdr_db(prior, cen.mse[-1]),
           "lossless": sdr_db(prior, ll.mse[-1]),
           "dp": sdr_db(prior, dpr.mse[-1]),
           "bt": sdr_db(prior, btr.mse[-1])}
    for r in (cen, ll, dpr, btr):
        assert r.x.shape == (N,) and np.all(np.isfinite(r.x))
    dx = float(np.abs(ll.x - cen.x).max())
    assert dx <= 1e-4, f"lossless MP-AMP != centralized AMP: max|dx|={dx}"
    sdr_limit_db = 0.5
    for name in ("dp", "bt"):
        assert sdr["lossless"] - sdr[name] < sdr_limit_db, sdr
    # SE envelope of the repo's own AMP test: one-iteration lag band on the
    # MSE curve, plateau within [0.65, 1.6] of the SE fixed point
    se = se_trajectory(prob, T, mm)
    se_mse = prob.kappa * (se[1:] - prob.sigma_e2)
    lo = 0.6 * np.minimum.reduce([se_mse, np.append(se_mse[1:], se_mse[-1])])
    hi = 1.7 * np.maximum.reduce([se_mse, np.insert(se_mse[:-1], 0, se_mse[0])])
    assert np.all(ll.mse >= lo) and np.all(ll.mse <= hi), (ll.mse / se_mse)
    assert 0.65 < ll.mse[-1] / se_mse[-1] < 1.6
    s2_ratio = ll.sigma2_hat / se[:T]
    assert np.all((s2_ratio > 0.6) & (s2_ratio < 1.7)), s2_ratio
    bits = {"dp_analytic": dpr.total_bits_analytic,
            "dp_empirical": dpr.total_bits_empirical,
            "bt_analytic": btr.total_bits_analytic,
            "bt_empirical": btr.total_bits_empirical,
            "uncompressed": 32.0 * T}
    for key in ("dp_analytic", "dp_empirical", "bt_analytic", "bt_empirical"):
        assert 0 < bits[key] < 0.3 * 32 * T, bits
    for name, c in counts.items():
        assert c == {"amp_local_z": T, "amp_local_f": T}, (name, c)
    assert all(v > 0 for v in main_path_launches.values())
    # batch: every instance solved, and instance 0 like a solve of its own
    assert many.x.shape == (BATCH, N) and np.all(np.isfinite(many.x))
    mse_b = np.mean((many.x - s0_b) ** 2, axis=-1)
    sdr_b = [sdr_db(prior, v) for v in mse_b]
    assert min(sdr_b) > sdr["lossless"] - 2.0, sdr_b
    np.testing.assert_allclose(many.sigma2_hat[0][:3], one.sigma2_hat[:3],
                               rtol=1e-3)
    assert abs(sdr_b[0] - sdr_db(prior, np.mean((one.x - s0_b[0]) ** 2))) < 0.5

    emit("solve", operating_point={"N": N, "M": M, "P": P, "T": T, "eps": EPS,
                                   "snr_db": SNR_DB, "seed": SEED},
         host_setup_s=setup_s, sdr_db=sdr, max_abs_dx_lossless_vs_centralized=dx,
         sdr_limit_db=sdr_limit_db, total_bits=bits,
         bt_rates=[float(v) for v in btr.rates_analytic],
         dp_rates=[float(v) for v in dpr.rates_analytic],
         sigma2_hat_over_se=[float(v) for v in s2_ratio],
         batch_sdr_db=sdr_b, launches_per_solve=counts,
         first_call_wall_ms=wall, a_bytes_batch=int(BATCH * M * N * 4))
    return {"prior": prior, "a": a, "y": y, "bt": bt._in_graph,
            "dp_sched": dp_sched, "launches": main_path_launches}


def check_no_host_sync(ctx) -> None:
    """One BT-rated solve with PyTorch's sync debug mode on: any call that
    makes the host wait for the device between iteration 0 and T is
    reported with the line of this repository that made it. All operands,
    the schedule included, are on the card before the mode is switched on."""
    eng = AmpEngine(ctx["prior"], EngineConfig(n_proc=P, n_iter=T),
                    EcsqTransport(), ctx["bt"])
    a_p, y_p = eng._split(ctx["y"], ctx["a"])
    sched = torch.zeros(T, device=DEV)
    eng.dispatch_single(a_p, y_p, M, N, sched)   # warm: allocator, tables
    torch.cuda.synchronize()
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "ynchroniz" in str(message):
            # frames of the port only: switching the debug mode itself
            # warns once, from this script, and is not part of the loop
            ours = [f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
                    for fr in traceback.extract_stack()
                    if fr.filename.startswith(os.path.join(ROOT, "src"))]
            if ours:
                sites.append(" <- ".join(reversed(ours[-3:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        x, outs = eng.dispatch_single(a_p, y_p, M, N, sched)
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert not sites, f"host syncs inside the solve loop at {sorted(set(sites))}"
    assert bool(torch.isfinite(x).all())
    emit("no_host_sync", solve="BT-rated, dispatch_single",
         synchronizing_calls_in_loop=len(sites))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_kernels() -> dict:
    table = {}
    for name, b, shared, p, mp, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a, x, y, z, ons = lc_inputs(b, shared, p, mp, n, dtype, SEED)
            z_new, _ = k.amp_local_z_cuda(a, x, y, z, ons)
            a32 = a.float()     # the library yardstick gets float32 A ready-made
            bounds = lc_bounds(b, shared, p, mp, n, dtype)
            calls = {
                "amp_local_z": {
                    "ms": lambda: k.amp_local_z_cuda(a, x, y, z, ons),
                    "plain_ms": lambda: ref.amp_local_z_ref(a, x, y, z, ons),
                    "library_ms": lambda: torch.einsum(
                        "...pmn,...n->...pm", a32, x)},
                "amp_local_f": {
                    "ms": lambda: k.amp_local_f_cuda(a, z_new, x, P),
                    "plain_ms": lambda: ref.amp_local_f_ref(a, z_new, x, P),
                    "library_ms": lambda: torch.einsum(
                        "...pmn,...pm->...pn", a32, z_new)},
            }
            row = {}
            for kernel, fns in calls.items():
                v = dict(bounds[kernel])
                for what, fn in fns.items():
                    t = time_ms(fn)
                    v[what] = t["ms"]
                    if t["host_paced"]:
                        v.setdefault("host_paced", []).append(what)
                v["wrapper_call_ms"] = time_call_ms(fns["ms"])
                v["share_of_bound"] = v["bound_ms"] / v["ms"]
                row[kernel] = v
            key = f"{name}/{str(dtype).split('.')[-1]}"
            table[key] = row
            del a, a32, x, y, z, z_new
    return table


def time_solves(ctx) -> dict:
    prior, a, y = ctx["prior"], ctx["a"], ctx["y"]
    out = {}
    engines = {
        "lossless": AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                              EcsqTransport(), FixedSchedule([np.inf] * T)),
        "dp": AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                        EcsqTransport(), ctx["dp_sched"]),
        "bt": AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                        EcsqTransport(), ctx["bt"]),
    }
    a_p, y_p = engines["lossless"]._split(y, a)
    for name, eng in engines.items():
        # device time of the T-iteration loop, operands already on the card
        out[f"{name}_solve_ms"] = time_call_ms(
            lambda: eng.dispatch_single(a_p, y_p, M, N))
    tables = ctx["bt"].tables_on(DEV)
    s2 = torch.tensor(0.01, device=DEV)

    def bt_decisions():
        for t in range(T):
            bt_delta_for(tables, t, s2)
    out["bt_controller_ms"] = time_call_ms(bt_decisions)
    out["bt_controller_share_of_bt_solve"] = \
        out["bt_controller_ms"] / out["bt_solve_ms"]
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every phase's result to "
                                      "this JSON file")
    args = parser.parse_args()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", nvidia_smi_name_power_limit=smi,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    paths = build.ensure_built(["amp_local"])
    k._library()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={n: os.path.relpath(str(p), ROOT) for n, p in paths.items()},
         nvcc=[{key: rec[key] for key in ("name", "command", "seconds")}
               for rec in build.build_log],
         ptxas=[line for rec in build.build_log
                for line in rec["stderr"].splitlines()
                if "registers" in line or "spill" in line])

    errs = check_kernels()
    check_against_cpu_reference()
    ctx = run_main_path()
    check_no_host_sync(ctx)

    kernel_times = time_kernels()
    solve_times = time_solves(ctx)
    emit("timing", card=smi,
         method="CUDA events, warm, median; kernels queued behind a busy "
                "device (device time), solves on an idle one (host pace "
                "included)",
         lc_step=kernel_times, solve=solve_times)

    main_key, err_key = "paper_P30/float32", ("paper_P30", "float32")
    kernels = []
    for name in ("amp_local_z", "amp_local_f"):
        tm = kernel_times[main_key][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": ctx["launches"][name],
            "max_abs_err": errs[err_key][f"{name[-1]}_max_abs_err"],
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({**RESULT, "kernels": kernels}, fh, indent=1)

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
