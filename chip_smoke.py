#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--out results.json] [--k6-only | --k5-only]

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc (one nvcc
per source, all at once), holds each against its plain PyTorch version on
the card, and drives the port's paths through the entry points a user
calls, at the paper's problem (N=10000, M=3000, eps=0.05, 20 dB, T=10):

  * the row layout (P=30): centralized, lossless, DP- and BT-rated ECSQ
    fusion, a batch of 8; and int8 / int4 block-quantized fusion;
  * the column layout, C-MP-AMP (P=25): lossless (== centralized AMP),
    ColDPSchedule- and column-BT-rated ECSQ, int8 block-quantized, two
    inner iterations per round, a batch of 4, bfloat16 A; and a wide
    problem of the shape the solve service routes to columns (N=20000,
    M=4000, P=20), BT-rated, and the same problem by centralized AMP,
    whose rows of 20000 K1 takes in clusters of two blocks;
  * LM serving (``repro_torch.launch.serve.generate``) at full width and
    depth from a random init: gemma3-1b (B=8; decode attention, K5, in
    every layer of every decode step) and rwkv6-3b (B=4; the WKV6
    recurrence, K6, in every layer of prefill), prompts of 1000 tokens and
    32 greedy steps; decode held against one prefill over the same tokens
    (bf16, and float32 weights); the small config of each family on the
    card against the CPU.

It checks the results, that the paths launched the kernels and made no host
sync inside their loops, and times the kernels against their bounds.

Prints one JSON object per phase, then the card's name and power limit,
then ``{"kernels": [...]}``, then as the last line ``{"ok": true,
"device": {...}}``. Any failed check raises, so the exit code is non-zero
and the last line is not printed. ``--out`` also writes all of it to one
JSON file. Needs a CUDA device and nvcc; needs no network. Takes about two
minutes on an H100. ``--k6-only`` builds the WKV6 kernel alone, holds it
against its plain version at every ``WKV_CASES`` case and times it at
rwkv6-3b's prefill shape for the plan's NV and NV = 1, 2, 4, then stops
(no other phase, no last line): the quick check of K6. ``--k5-only`` does
the same for decode attention: it builds K5 alone, holds it against its
plain version at every ``DA_CASES`` case and over calls of two plans in
turns, times it at gemma3-1b's decode shapes L2-hot and L2-cold and at
B=8, S=32768, and stops, with the card's line and the last line of a full
run.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import re
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
from repro_torch.core.engine import (AmpEngine, BlockQuantTransport,  # noqa: E402
                                     ColDPSchedule, ColumnBTRateControl,
                                     ColumnPartition, DPSchedule,
                                     EcsqTransport, EngineConfig, ExactFusion,
                                     FixedSchedule, bt_delta_for,
                                     col_bt_delta_for)
from repro_torch.core.mp_amp import MPAMPConfig, mp_amp_solve  # noqa: E402
from repro_torch.core.rate_alloc import (BTController, dp_allocate,  # noqa: E402
                                         dp_allocate_col)
from repro_torch.core.rate_distortion import RDModel  # noqa: E402
from repro_torch.core.state_evolution import (PAPER_T, CSProblem,  # noqa: E402
                                              se_trajectory)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.amp_fused import amp_fused as k  # noqa: E402
from repro_torch.kernels.amp_fused import col as kc  # noqa: E402
from repro_torch.kernels.amp_fused import ref  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.kernels.quantize import quantize as kq  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn as kd  # noqa: E402
from repro_torch.kernels.decode_attn.ref import (decode_attn_ref,  # noqa: E402
                                                 valid_rows)
from repro_torch.kernels.wkv6 import wkv6 as kw  # noqa: E402
from repro_torch.kernels.wkv6.ref import CHUNK, wkv_chunked  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

DEV = torch.device("cuda:0")
SOURCES = {"amp_local": "src/repro_torch/csrc/amp_local.cu",
           "amp_local_two_pass": "src/repro_torch/csrc/amp_local.cu",
           "col_residual": "src/repro_torch/csrc/amp_col.cu",
           "col_inner": "src/repro_torch/csrc/amp_col.cu",
           "quantize_blocks": "src/repro_torch/csrc/quantize.cu",
           "dequantize_blocks": "src/repro_torch/csrc/quantize.cu",
           "decode_attn": "src/repro_torch/csrc/decode_attn.cu",
           "wkv6": "src/repro_torch/csrc/wkv6.cu"}
K1_SITES = ("src/repro/kernels/amp_fused/amp_fused.py:102, "
            "src/repro/kernels/amp_fused/amp_fused.py:123")
REPLACES = {"amp_local": K1_SITES,
            "amp_local_two_pass": K1_SITES,
            "col_residual": "src/repro/kernels/amp_fused/col.py:67",
            "col_inner": "src/repro/kernels/amp_fused/col.py:175",
            "quantize_blocks": "src/repro/kernels/quantize/quantize.py:44",
            "dequantize_blocks": "src/repro/kernels/quantize/quantize.py:72",
            "decode_attn": "src/repro/kernels/decode_attn/decode_attn.py:85",
            "wkv6": "src/repro/kernels/wkv6/wkv6.py:80"}
COUNTERS = (k.launch_counts, kc.launch_counts, kq.launch_counts,
            kd.launch_counts, kw.launch_counts)

# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the
# tensor cores and the dense TF32 tensor-core rate (K6's products).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

# The paper's operating point (Sec. 4) at full width.
N, M, P, EPS, SNR_DB = 10_000, 3_000, 30, 0.05, 20.0
T = PAPER_T[EPS]
BATCH = 8
# The column layout: P must divide N (10000 / 30 does not), so P=25.
P_COL = 25
COL_BATCH = 4
# A wide problem of the regime the solve service sends to column buckets
# (N/M = 5 >= its col_aspect of 4).
WIDE_N, WIDE_M, WIDE_P = 20_000, 4_000, 20
COL_DP_BITS = 3.0 * T   # total bits per residual entry over the T rounds
PRIOR_SCALARS = (EPS, 0.0, 1.0)   # eps, mu_s, sigma_s^2 of the inner step
KERNEL_RTOL = 1e-5      # max |kernel - plain| / max |plain|, float32 sums in
                        # different orders; bf16 A: both sides get the same
                        # bf16 matrix and accumulate in float32. The block
                        # quantizer is held to bit-identity instead.
SEED = 1234

# LM serving (random init from SEED, full width and depth): gemma3-1b, B=8
# (26 layers: K5 26 times a decode step), and rwkv6-3b, B=4 (32 layers: K6
# once a layer in prefill); prompts of 1000 tokens, 32 greedy steps, so the
# cache holds 1032 rows (ragged against K5's stages of 32 rows and the TPU's 512)
# and pos > 512, where gemma3's window of 512 bites.
LM_DENSE, LM_DENSE_BATCH = "gemma3-1b", 8
LM_RWKV, LM_RWKV_BATCH = "rwkv6-3b", 4
LM_PROMPT, LM_GEN = 1000, 32
# the reference's own prefill/decode tolerance (tests/test_models.py:66)
LM_RTOL, LM_ATOL = 0.05, 0.15
# card against CPU, small configs: the CPU tests' port-vs-reference bound
# (tests/test_torch_models.py), 2 % of the logits' scale
LM_SMALL_TOL = 0.02
# decode against prefill with float32 weights: rounding of float32 sums in
# another order, amplified through the layers (6e-5 of the logits' scale
# seen at 32 layers in a CPU probe of a narrower rwkv6)
LM_F32_TOL = 1e-3
WKV_TOL = 3e-4          # rtol = atol, the reference's (tests/test_models.py:108)

RESULT: dict = {}


def reset_all_counts() -> None:
    k.reset_launch_counts()
    kc.reset_launch_counts()
    kq.reset_launch_counts()
    kd.reset_launch_counts()
    kw.reset_launch_counts()


def all_counts() -> dict:
    return {key: v for counts in COUNTERS for key, v in counts.items()}


def emit(phase: str, **fields) -> None:
    RESULT[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


def tensor_core_ops(lib_path) -> dict:
    """Tensor-core instructions in a built library's SASS (``cuobjdump
    -sass``, from the toolkit beside nvcc), counted by opcode."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    counts: dict = {}
    for op in re.findall(r"\b(?:HMMA|HGMMA)\.[\w.]+", out):
        counts[op] = counts.get(op, 0) + 1
    return counts


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
    the kernels'. The busy work before each repeat leaves the L2 full of
    other data, so the first of the ``inner`` calls finds its operands in
    device memory and the later ones find what of them the 50 MB L2 kept.
    K1's and K2's A exceed (float32) or about equal (bfloat16) the L2, so
    those calls find A mostly cold, as the solve loop does; K5's caches at
    the decode shape (8.4 MB) stay in it, so its hot rows are L2-hot, and
    its cold rows rotate over copies (``time_decode_attn``)."""
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
    # four rows a stage through the ring (N <= 4096, aligned)
    ("short_rows_N1000", None, False, 6, 50, 1000),
    # the widest rows one block takes: every register of a thread's share
    ("single_read_max_N", None, False, 4, 50, k.SINGLE_READ_MAX_N),
    # past it a cluster of C blocks a band: C = 2 at the wide problem's
    # centralized shape; C = 3 without 16-byte rows (no ring); C = 8 at the
    # widest rows one read takes
    ("wide_rows_P1", None, False, 1, WIDE_M, WIDE_N),
    ("cluster_C3_odd_N", None, False, 3, 40, 40_001),
    ("cluster_max_N", None, False, 1, 64, k.CLUSTER_MAX_N),
    # past that: the two-pass kernels
    ("two_pass_past_cluster", None, False, 1, 32, k.CLUSTER_MAX_N + 8),
]
WIDE_CASE = "wide_rows_P1"
TWO_PASS_CASE = "two_pass_past_cluster"


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


def bound(nbytes: float, flops: float) -> dict:
    """The least time of a call: its bytes over the memory rate or its
    float32 operations over the CUDA-core rate, whichever is longer."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "flops": flops}


def lc_route(n, dtype) -> str:
    """The launch-count key of the kernels K1 takes for rows of N: the
    single read (one block, or a cluster of up to 8, a band) up to
    ``CLUSTER_MAX_N``, the two-pass kernels past it."""
    return "amp_local" if k.single_read(n, dtype) else "amp_local_two_pass"


def lc_plan(b, p, mp, n, dtype, vec) -> dict | None:
    """The single read's plan for a case, as the wrapper makes it: cluster
    size, column slice width, the slots its bands aim at (SMs, or the
    card's active clusters) and the bands."""
    if not k.single_read(n, dtype):
        return None
    c = k.cluster_size(n, dtype)
    w = k.cluster_slices(n, dtype)[0][1]
    slots = (k.sm_count(DEV) if c == 1
             else k.max_active_clusters(DEV, c, dtype, vec, w))
    return {"cluster": c, "slice_w": w, "n_slots": slots,
            "split_plan": k.split_plan(b or 1, p, mp, n, dtype, slots)}


def check_clusters() -> dict:
    """cudaOccupancyMaxActiveClusters of the band kernel's cluster instance
    for clusters of 2 and 8 blocks (slices of 10000 and 16384 columns,
    through the ring and without it), float32 and bf16: the slots the
    wrapper plans its bands for. Raises if any is 0."""
    out = {}
    for c, w in ((2, WIDE_N // 2), (8, k.SINGLE_READ_MAX_N)):
        for dtype in (torch.float32, torch.bfloat16):
            for vec in (1, 0):
                key = f"C{c}/W{w}/{str(dtype).split('.')[-1]}/vec{vec}"
                out[key] = k.max_active_clusters(DEV, c, dtype, vec, w)
    emit("clusters", sm_count=k.sm_count(DEV),
         max_active_clusters=out)
    return out


def lc_bounds(b, shared, p, mp, n, dtype):
    """Least time of one LC step: A read once, x, y, z and the Onsager
    scalar read once, z', f and ss written once, over the memory rate;
    against its float32 operations (two multiply-adds an element of A) over
    the CUDA-core rate. Returns ms and which one binds."""
    bb = 1 if b is None else b
    a_bytes = (1 if shared else bb) * p * mp * n * (2 if dtype == torch.bfloat16 else 4)
    # x, y, z, ons; z', f, ss
    nbytes = a_bytes + 4 * bb * (n + 2 * p * mp + 1 + p * mp + p * n + 1)
    return bound(nbytes, 4.0 * bb * p * mp * n)


def check_kernels() -> dict:
    """K1 (``amp_local_cuda_grid``) against the plain step at every SHAPES
    case, float32 and bfloat16 A: the route each case must take (single
    read in one block or a cluster, or two-pass past the row limit), the
    results within KERNEL_RTOL, and z', f and ss the same bits over two
    calls."""
    rows = []
    for name, b, shared, p, mp, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a, x, y, z, ons = lc_inputs(b, shared, p, mp, n, dtype, SEED)
            route = lc_route(n, dtype)
            before = dict(k.launch_counts)
            got = k.amp_local_cuda_grid(a, x, y, z, ons, P)
            torch.cuda.synchronize()
            launched = {key: k.launch_counts[key] - before[key]
                        for key in before}
            again = k.amp_local_cuda_grid(a, x, y, z, ons, P)
            want = ref.amp_local_ref_grid(a, x, y, z, ons, P)
            torch.cuda.synchronize()
            (z_k, f_k, ss_k), (z_r, f_r, ss_r) = got, want
            row = {"shape": name, "a_dtype": str(dtype).split(".")[-1],
                   "B": b, "shared_a": shared, "P": p, "Mp": mp, "N": n,
                   "vec": k.vec_width(n, dtype), "route": route,
                   "plan": lc_plan(b, p, mp, n, dtype,
                                   k._vec_flag(n, a, x)),
                   "z_rel_err": rel_err(z_k, z_r),
                   "ss_rel_err": rel_err(ss_k, ss_r),
                   "f_rel_err": rel_err(f_k, f_r),
                   "z_max_abs_err": float((z_k - z_r).abs().max()),
                   "f_max_abs_err": float((f_k - f_r).abs().max()),
                   "bit_identical": all(bool(torch.equal(u, v))
                                        for u, v in zip(got, again))}
            rows.append(row)
            assert launched == {key: int(key == route) for key in before}, \
                (row, launched)
            assert z_k.shape == y.shape and f_k.shape == y.shape[:-1] + (n,)
            assert ss_k.shape == y.shape[:-2]
            for key in ("z_rel_err", "ss_rel_err", "f_rel_err"):
                assert row[key] <= KERNEL_RTOL, (row, key)
            assert row["bit_identical"], row
            del a, x, y, z, got, again, want, z_k, f_k, z_r, f_r
    emit("kernel_check", rtol=KERNEL_RTOL, cases=rows)
    return {(r["shape"], r["a_dtype"]): r for r in rows}


COL_SHAPES = [
    # name, B (None = unbatched), shared A, P, M, Np
    ("paper_P25", None, False, P_COL, M, N // P_COL),
    ("wide_P20", None, False, WIDE_P, WIDE_M, WIDE_N // WIDE_P),
    ("ragged_masked", None, False, 3, 101, 77),
    ("batch4_per_instance_A", COL_BATCH, False, P_COL, M, N // P_COL),
    ("batch4_shared_A", COL_BATCH, True, P_COL, M, N // P_COL),
]


def col_inputs(b, shared, p, m, np_, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    lead = () if b is None else (b,)
    a_lead = () if (b is None or shared) else (b,)
    rnd = lambda *s: torch.randn(*s, generator=g, device=DEV)
    a = (rnd(*a_lead, p, m, np_) / m ** 0.5).to(dtype).contiguous()
    x, x0 = 0.1 * rnd(*lead, p, np_), 0.1 * rnd(*lead, p, np_)
    return a, x, x0, rnd(*lead, p, m), rnd(*lead, m)


def check_col_kernels() -> dict:
    """K2 and K3 (both ``update_z``) against their plain versions; K3's
    ``c_p`` must be the same bits over two runs."""
    rows = []
    for name, b, shared, p, m, np_ in COL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a, x, x0, z, g = col_inputs(b, shared, p, m, np_, dtype, SEED)
            mask = ((torch.arange(np_, device=DEV) % 3) != 0).float() \
                if name.startswith("ragged") else None
            r_k = kc.col_residual_cuda(a, x)
            torch.cuda.synchronize()
            r_r = ref.col_residual_ref(a, x)
            row = {"shape": name, "a_dtype": str(dtype).split(".")[-1],
                   "B": b, "shared_a": shared, "P": p, "M": m, "Np": np_,
                   "vec": k.vec_width(np_, dtype),
                   "row_chunk": kc.row_chunk(DEV, (b or 1) * p, m, np_, dtype),
                   "r_rel_err": rel_err(r_k, r_r),
                   "r_max_abs_err": float((r_k - r_r).abs().max())}
            assert r_k.shape == x.shape[:-1] + (m,)
            for upd in (False, True):
                args = (a, x, x0, z, g, mask, float(m), *PRIOR_SCALARS, upd)
                x_k, c_k, z_k = kc.col_inner_cuda(*args)
                torch.cuda.synchronize()
                x_r, c_r, z_r = ref.col_inner_step_ref(*args)
                _, c_again, _ = kc.col_inner_cuda(*args)
                torch.cuda.synchronize()
                tag = "upd" if upd else "final"
                row[f"x_rel_err_{tag}"] = rel_err(x_k, x_r)
                row[f"c_rel_err_{tag}"] = rel_err(c_k, c_r)
                row[f"x_max_abs_err_{tag}"] = float((x_k - x_r).abs().max())
                row[f"c_bit_identical_{tag}"] = bool(torch.equal(c_k, c_again))
                if upd:
                    row["z_rel_err_upd"] = rel_err(z_k, z_r)
                    row["z_max_abs_err_upd"] = float((z_k - z_r).abs().max())
                else:
                    assert z_k is z
                assert x_k.shape == x.shape and c_k.shape == x.shape[:-1]
                assert row[f"c_bit_identical_{tag}"], row
            rows.append(row)
            for key in [key for key in row if "rel_err" in key]:
                assert row[key] <= KERNEL_RTOL, (row, key)
            del a, x, x0, z, g, r_k, r_r
    emit("kernel_check_col", rtol=KERNEL_RTOL, cases=rows)
    return {(r["shape"], r["a_dtype"]): r for r in rows}


Q_SHAPES = [("row_messages", P, N), ("col_contributions", P_COL, M),
            ("ragged", 7, 1001)]


def quant_inputs(r, n, seed):
    """Messages of three scales, a large-magnitude row and an all-zero row."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(r, n, generator=g, device=DEV)
    x[0] = 0.0
    x[1] *= 1e4
    x[2] *= 1e-3
    return x.contiguous()


def check_quantize_kernels() -> dict:
    """K4a/K4b against the plain versions: q, the scale bits and the
    dequantized values must be identical, bit for bit."""
    rows = []
    for name, r, n in Q_SHAPES:
        x = quant_inputs(r, n, SEED)
        for qmax in (127, 7):
            for block in (512, 256):
                q_k, s_k = kq.quantize_cuda(x, qmax, block)
                d_k = kq.dequantize_cuda(q_k, s_k, block)
                torch.cuda.synchronize()
                q_r, s_r = qops.quantize_plain(x, qmax, block)
                d_r = qops.dequantize_plain(q_r, s_r, block)
                bound = s_r.float().repeat_interleave(block, -1)[:, :n] / 2
                row = {"shape": name, "R": r, "N": n, "qmax": qmax,
                       "block": block,
                       "q_identical": bool(torch.equal(q_k, q_r)),
                       "scale_bits_identical": bool(torch.equal(
                           s_k.view(torch.int16), s_r.view(torch.int16))),
                       "dequantized_identical": bool(torch.equal(d_k, d_r)),
                       "q_max_abs_err": float((q_k.int() - q_r.int()).abs().max()),
                       "dequantized_max_abs_err": float((d_k - d_r).abs().max()),
                       "within_half_bin": bool(((d_k - x).abs() <= bound).all())}
                rows.append(row)
                assert q_k.shape == (r, n) and s_k.shape == (r, -(-n // block))
                assert all(row[key] for key in (
                    "q_identical", "scale_bits_identical",
                    "dequantized_identical", "within_half_bin")), row
    emit("kernel_check_quantize", limit="bit-identical", cases=rows)
    return {(r["shape"], r["qmax"], r["block"]): r for r in rows}


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
    for n_inner in (1, 2):
        runs = {}
        for dev in ("cuda", "cpu"):
            eng = AmpEngine(prior, EngineConfig(
                n_proc=4, n_iter=t, device=dev,
                layout=ColumnPartition(n_inner)), ExactFusion())
            runs[dev] = eng.solve(y, a)
        dx = float(np.abs(runs["cuda"].x - runs["cpu"].x).max())
        ds = float(np.abs(runs["cuda"].sigma2_hat / runs["cpu"].sigma2_hat - 1).max())
        out[f"column_n_inner{n_inner}"] = {"max_abs_dx": dx, "max_rel_dsigma2": ds}
        assert np.all(np.isfinite(runs["cuda"].x)) and runs["cuda"].x.shape == (n,)
        assert dx <= 1e-4 and ds <= 1e-3, out
    emit("reference", small_problem={"N": n, "M": m, "P": p, "P_col": 4, "T": t},
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
        assert c == {"amp_local": T, "amp_local_two_pass": 0}, (name, c)
    assert main_path_launches["amp_local"] > 0
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
    return {"prior": prior, "prob": prob, "mm": mm, "a": a, "y": y,
            "s0": s0_np, "cen_x": cen.x, "ll_mse": float(ll.mse[-1]),
            "bt": bt._in_graph, "dp_sched": dp_sched,
            "launches": main_path_launches}


def entropy_bits(sym: np.ndarray) -> float:
    """Empirical entropy (bits per symbol) of one round's symbols."""
    _, counts = np.unique(sym, return_counts=True)
    prob = counts / counts.sum()
    return float(-(prob * np.log2(prob)).sum())


def col_engine(prior, transport, controller=None, n_iter=T, n_inner=1,
               p=P_COL, **cfg):
    return AmpEngine(prior, EngineConfig(n_proc=p, n_iter=n_iter,
                                         layout=ColumnPartition(n_inner), **cfg),
                     transport, controller)


def run_col_path(ctx) -> dict:
    """The column layout through ``AmpEngine.solve`` / ``solve_many``."""
    prior, prob, mm = ctx["prior"], ctx["prob"], ctx["mm"]
    a, y, s0 = ctx["a"], ctx["y"], ctx["s0"]
    t0 = time.perf_counter()
    dp_col = dp_allocate_col(prob, P_COL, T, COL_DP_BITS, mmse_fn=mm)
    dp_sched = ColDPSchedule(dp_col, prob, P_COL)
    bt_col = ColumnBTRateControl(prob, P_COL, T, c_ratio=1.05, r_max=6.0,
                                 mmse_fn=mm)
    prob_w = CSProblem(n=WIDE_N, m=WIDE_M, prior=prior, snr_db=SNR_DB)
    bt_w = ColumnBTRateControl(prob_w, WIDE_P, T, c_ratio=1.05, r_max=6.0,
                               mmse_fn=mm)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    s0_w, a_w, y_w = sample_problem(gen, WIDE_N, WIDE_M, prior,
                                    prob_w.sigma_e2, device="cuda")
    s0_w = s0_w.cpu().numpy()
    gen_b = torch.Generator(device=DEV).manual_seed(SEED + 3)
    probs = [sample_problem(gen_b, N, M, prior, prob.sigma_e2, device="cuda")
             for _ in range(COL_BATCH)]
    a_b = torch.stack([q[1] for q in probs])
    y_b = torch.stack([q[2] for q in probs])
    del probs
    setup_s = time.perf_counter() - t0

    counts, wall = {}, {}

    def counted(name, fn):
        before = all_counts()
        out, wall[name] = timed(fn)
        counts[name] = {key: v - before[key] for key, v in all_counts().items()
                        if v != before[key]}
        return out

    reset_all_counts()
    ll = counted("lossless", lambda: col_engine(prior, ExactFusion()).solve(y, a))
    dpr = counted("dp", lambda: col_engine(prior, EcsqTransport(),
                                           dp_sched).solve(y, a))
    btr = counted("bt", lambda: col_engine(prior, EcsqTransport(),
                                           bt_col).solve(y, a))
    b8 = counted("block8", lambda: col_engine(
        prior, BlockQuantTransport(8)).solve(y, a))
    two = counted("n_inner2", lambda: col_engine(
        prior, ExactFusion(), n_iter=T // 2, n_inner=2).solve(y, a))
    bf = counted("bf16_a", lambda: col_engine(
        prior, ExactFusion(), a_dtype="bfloat16").solve(y, a))
    many = counted("solve_many", lambda: col_engine(
        prior, ExactFusion(), collect_symbols=False).solve_many(y_b, a_b))
    ll_w = counted("wide_lossless", lambda: col_engine(
        prior, ExactFusion(), p=WIDE_P).solve(y_w, a_w))
    bt_wr = counted("wide_bt", lambda: col_engine(
        prior, EcsqTransport(), bt_w, p=WIDE_P).solve(y_w, a_w))
    # the same wide problem solved by centralized AMP: rows of N=20000,
    # wider than one block takes, so K1 takes a cluster of two a band
    cen_w = counted("wide_centralized", lambda: amp_solve(
        y_w, a_w, prior, T, s0=s0_w))
    launches = all_counts()                    # read just after the path
    singles = [col_engine(prior, ExactFusion(), collect_symbols=False)
               .solve(y_b[i], a_b[i]) for i in range(COL_BATCH)]
    del a_b, y_b, a_w, y_w

    # ---- checks -----------------------------------------------------------
    mse = {name: float(tr.mse(s0)[-1]) for name, tr in (
        ("lossless", ll), ("dp", dpr), ("bt", btr), ("block8", b8),
        ("n_inner2", two), ("bf16_a", bf))}
    mse["wide_lossless"] = float(ll_w.mse(s0_w)[-1])
    mse["wide_bt"] = float(bt_wr.mse(s0_w)[-1])
    for tr in (ll, dpr, btr, b8, two, bf):
        assert tr.x.shape == (N,) and np.all(np.isfinite(tr.x))
    assert ll.symbols.shape == (T, P_COL, M), ll.symbols.shape
    dx = float(np.abs(ll.x - ctx["cen_x"]).max())
    assert dx <= 1e-4, f"lossless C-MP-AMP != centralized AMP: max|dx|={dx}"
    dx_w = float(np.abs(ll_w.x - cen_w.x).max())
    assert np.all(np.isfinite(cen_w.x)) and cen_w.x.shape == (WIDE_N,)
    assert dx_w <= 1e-4, f"wide: lossless C-MP-AMP != centralized AMP: {dx_w}"
    ratio = {name: mse[name] / mse["lossless"]
             for name in ("dp", "bt", "block8", "n_inner2", "bf16_a")}
    ratio["wide_bt"] = mse["wide_bt"] / mse["wide_lossless"]
    limits = {"dp": 1.5, "bt": 1.5, "block8": 1.3, "wide_bt": 1.5}
    for name, lim in limits.items():
        assert ratio[name] < lim, (name, ratio)
    for tr in (btr, bt_wr):
        assert np.isinf(tr.deltas[0]) and tr.rates[0] == 0.0, tr.rates
        assert np.all(np.isfinite(tr.deltas[1:]))
        assert np.all((tr.rates[1:] > 0) & (tr.rates[1:] <= 6.0 + 1e-5)), tr.rates
    assert np.isinf(dpr.deltas[0]) and np.all(np.isfinite(dpr.deltas[1:]))
    assert b8.extra_var[0] == 0.0 and np.all(b8.extra_var[1:] > 0), b8.extra_var
    np.testing.assert_allclose(dpr.extra_var[1:],
                               P_COL * dpr.deltas[1:] ** 2 / 12.0, rtol=1e-6)
    assert dpr.extra_var[0] == 0.0
    mse_two = two.mse(s0)
    assert np.all(np.diff(mse_two) < 0), mse_two
    assert abs(mse["bf16_a"] / mse["lossless"] - 1.0) <= 0.01, mse
    assert many.x.shape == (COL_BATCH, N) and np.all(np.isfinite(many.x))
    many_dx = [float(np.abs(many.x[i] - one.x).max() / np.abs(one.x).max())
               for i, one in enumerate(singles)]
    assert max(many_dx) <= 1e-5, many_dx
    assert counts["wide_centralized"] == {"amp_local": T}, counts
    for name, c in counts.items():
        if name == "wide_centralized":
            continue
        n_rounds = T // 2 if name == "n_inner2" else T
        n_inner = 2 if name == "n_inner2" else 1
        want = {"col_residual": n_rounds, "col_inner": n_rounds * n_inner}
        if name == "block8":
            want.update(quantize_blocks=T, dequantize_blocks=T)
        assert c == want, (name, c, want)
    assert launches["col_residual"] > 0 and launches["col_inner"] > 0

    bits = {"dp_analytic": float(np.sum(dp_col.rates)),
            "dp_empirical": sum(entropy_bits(dpr.symbols[t]) for t in range(1, T)),
            "bt_analytic": float(np.sum(btr.rates)),
            "bt_empirical": sum(entropy_bits(btr.symbols[t]) for t in range(1, T)),
            "block8_wire": (T - 1) * (8 + 16 / 512),
            "uncompressed": 32.0 * (T - 1)}
    emit("col_solve", operating_point={"N": N, "M": M, "P": P_COL, "T": T,
                                       "eps": EPS, "snr_db": SNR_DB,
                                       "seed": SEED},
         wide={"N": WIDE_N, "M": WIDE_M, "P": WIDE_P, "seed": SEED + 2},
         host_setup_s=setup_s,
         sdr_db={name: sdr_db(prior, v) for name, v in mse.items()},
         mse_ratio_to_lossless=ratio, limits=limits,
         max_abs_dx_lossless_vs_centralized=dx,
         wide_max_abs_dx_lossless_vs_centralized=dx_w,
         n_inner2_mse_per_round=[float(v) for v in mse_two],
         batch_vs_single_rel_dx=many_dx,
         bits_per_residual_entry=bits,
         bt_rates=[float(v) for v in btr.rates],
         dp_rates=[float(v) for v in dp_col.rates],
         wide_bt_rates=[float(v) for v in bt_wr.rates],
         launches_per_solve=counts, first_call_wall_ms=wall,
         a_bytes_batch=int(COL_BATCH * M * N * 4))
    return {"dp_sched": dp_sched, "bt": bt_col, "launches": launches}


def run_block_quant_row(ctx) -> dict:
    """int8 and int4 block-quantized fusion on the row solve (P=30)."""
    prior, a, y, s0 = ctx["prior"], ctx["a"], ctx["y"], ctx["s0"]
    reset_all_counts()
    runs = {bits: AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                            BlockQuantTransport(bits)).solve(y, a)
            for bits in (8, 4)}
    launches = all_counts()                    # read just after the path
    ratio = {f"int{bits}": float(tr.mse(s0)[-1]) / ctx["ll_mse"]
             for bits, tr in runs.items()}
    for tr in runs.values():
        assert tr.x.shape == (N,) and np.all(np.isfinite(tr.x))
        assert tr.symbols.shape == (T, P, N) and np.all(tr.extra_var > 0)
    assert np.abs(runs[4].symbols).max() <= 7
    assert ratio["int8"] < 1.3, ratio
    want = {"amp_local": 2 * T, "amp_local_two_pass": 0,
            "quantize_blocks": 2 * T, "dequantize_blocks": 2 * T}
    assert {key: launches[key] for key in want} == want, launches
    emit("block_quant_row", P=P, mse_ratio_to_lossless=ratio,
         limits={"int8": 1.3},
         sdr_db={f"int{bits}": sdr_db(prior, float(tr.mse(s0)[-1]))
                 for bits, tr in runs.items()})
    return {"launches": launches}



def sync_sites(fn) -> list:
    """Run ``fn`` with PyTorch's sync debug mode on: every call that makes
    the host wait for the device is reported with the lines of this
    repository that made it. The caller warms ``fn`` up first."""
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
        try:
            x, _ = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())
    return sites


def check_no_host_sync(ctx, col_ctx) -> None:
    """Solves with the sync debug mode on (``sync_sites``): the row
    lossless, BT-rated and int8 solves and the column lossless, DP, BT and
    int8 solves. All operands, the schedule included, are on the card
    before the mode is switched on."""
    prior = ctx["prior"]
    row = {"row_lossless": AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                                     EcsqTransport(),
                                     FixedSchedule([np.inf] * T)),
           "row_bt": AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                               EcsqTransport(), ctx["bt"]),
           "row_block8": AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                                   BlockQuantTransport(8))}
    a_p, y_p = row["row_bt"]._split(ctx["y"], ctx["a"])
    found = {}
    for name, eng in row.items():
        sched = eng._f32(eng._sched_operand())
        run = lambda e=eng, s=sched: e.dispatch_single(a_p, y_p, M, N, s)
        run()                                  # warm: allocator, tables
        found[name] = sync_sites(run)
    col = {"col_lossless": col_engine(prior, ExactFusion()),
           "col_dp": col_engine(prior, EcsqTransport(), col_ctx["dp_sched"]),
           "col_bt": col_engine(prior, EcsqTransport(), col_ctx["bt"]),
           "col_block8": col_engine(prior, BlockQuantTransport(8))}
    a_cp, y_d = col["col_lossless"]._split_col(ctx["y"], ctx["a"])
    for name, ceng in col.items():
        sched_c = ceng._f32(ceng._sched_operand())
        run = lambda e=ceng, s=sched_c: e._col_solve_core(a_cp, y_d, s, M, N)
        run()
        found[name] = sync_sites(run)
    bad = {name: sorted(set(v)) for name, v in found.items() if v}
    assert not bad, f"host syncs inside the solve loop: {bad}"
    emit("no_host_sync", solves=sorted(found),
         synchronizing_calls_in_loop={name: len(v) for name, v in found.items()})


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _time_calls(calls: dict, bounds: dict) -> dict:
    """ms / plain_ms / library_ms of each kernel (``time_ms``), its
    wrapper's call time on an idle card and its share of the bound."""
    row = {}
    for kernel, fns in calls.items():
        v = dict(bounds[kernel])
        for what, fn in fns.items():
            t = time_ms(fn)
            v[what] = t["ms"]
            if t["host_paced"]:
                v.setdefault("host_paced", []).append(what)
        v.setdefault("library_ms", None)
        v["wrapper_call_ms"] = time_call_ms(fns["ms"])
        v["share_of_bound"] = v["bound_ms"] / v["ms"]
        row[kernel] = v
    return row


def time_kernels() -> dict:
    """K1 at every SHAPES case under the name of the route it takes. The
    library yardstick is the step's two contractions, one einsum each, in
    one call (z' for the second is the kernel's, made beforehand)."""
    table = {}
    for name, b, shared, p, mp, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a, x, y, z, ons = lc_inputs(b, shared, p, mp, n, dtype, SEED)
            z_new, _, _ = k.amp_local_cuda_grid(a, x, y, z, ons, P)
            a32 = a.float()     # the library yardstick gets float32 A ready-made
            route = lc_route(n, dtype)
            calls = {route: {
                "ms": lambda: k.amp_local_cuda_grid(a, x, y, z, ons, P),
                "plain_ms": lambda: ref.amp_local_ref_grid(a, x, y, z, ons, P),
                "library_ms": lambda: (
                    torch.einsum("...pmn,...n->...pm", a32, x),
                    torch.einsum("...pmn,...pm->...pn", a32, z_new))}}
            row = _time_calls(calls, {route: lc_bounds(b, shared, p, mp, n,
                                                       dtype)})
            table[f"{name}/{str(dtype).split('.')[-1]}"] = row
            del a, a32, x, y, z, z_new
    return table


def col_bounds(b, shared, p, m, np_, dtype):
    """Least times of K2 and K3 (each input read once, each output written
    once, over the memory rate; against the float32 operations over the
    CUDA-core rate). K3's derivative and denoiser are ~40 flops a column."""
    bb = 1 if b is None else b
    a_bytes = (1 if shared else bb) * p * m * np_ * (2 if dtype == torch.bfloat16 else 4)
    vec_x, vec_z = 4 * bb * p * np_, 4 * bb * p * m
    mac = 2.0 * bb * p * m * np_
    return {
        "col_residual": bound(a_bytes + vec_x + vec_z, mac),           # x; r
        # x, z; x', c
        "col_inner_final": bound(a_bytes + 2 * vec_x + vec_z + 4 * bb * p,
                                 mac + 40.0 * bb * p * np_),
        # x, x0, z, g; x', c, z'
        "col_inner_upd": bound(
            a_bytes + 3 * vec_x + 2 * vec_z + 4 * bb * (p + m),
            2 * mac + 40.0 * bb * p * np_),
    }


def quant_bounds(r, n, block):
    """Least times of K4a/K4b: x read and q + scales written, and back;
    about 5 float32 operations an element (abs, max, divide, round,
    clamp) for K4a, 2 for K4b."""
    scales = 2 * r * (-(-n // block))
    return {"quantize_blocks": bound(5 * r * n + scales, 5.0 * r * n),
            "dequantize_blocks": bound(5 * r * n + scales, 2.0 * r * n)}


COL_TIMED = [s for s in COL_SHAPES if s[0] in ("paper_P25", "wide_P20",
                                               "batch4_per_instance_A")]


def time_col_kernels() -> dict:
    table = {}
    for name, b, shared, p, m, np_ in COL_TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            a, x, x0, z, g = col_inputs(b, shared, p, m, np_, dtype, SEED)
            a32 = a.float()   # the library yardstick gets float32 A ready-made
            inner = lambda upd: (a, x, x0, z, g, None, float(m),
                                 *PRIOR_SCALARS, upd)
            stage0 = lambda: torch.einsum("...pmn,...pm->...pn", a32, z)
            calls = {
                "col_residual": {
                    "ms": lambda: kc.col_residual_cuda(a, x),
                    "plain_ms": lambda: ref.col_residual_ref(a, x),
                    "library_ms": lambda: torch.einsum(
                        "...pmn,...pn->...pm", a32, x)},
                "col_inner_final": {
                    "ms": lambda: kc.col_inner_cuda(*inner(False)),
                    "plain_ms": lambda: ref.col_inner_step_ref(*inner(False)),
                    "library_ms": stage0},
                "col_inner_upd": {
                    "ms": lambda: kc.col_inner_cuda(*inner(True)),
                    "plain_ms": lambda: ref.col_inner_step_ref(*inner(True)),
                    "library_ms": stage0},
            }
            table[f"{name}/{str(dtype).split('.')[-1]}"] = _time_calls(
                calls, col_bounds(b, shared, p, m, np_, dtype))
            del a, a32, x, x0, z, g
    return table


def time_quantize_kernels() -> dict:
    """At the transports' shapes: the row messages (P=30, N) and the column
    contributions (P=25, M), qmax 127, block 512. No single PyTorch call
    computes the block quantizer, so there is no library yardstick."""
    table = {}
    for name, r, n in Q_SHAPES[:2]:
        x = quant_inputs(r, n, SEED)
        q, s = kq.quantize_cuda(x, 127, 512)
        calls = {
            "quantize_blocks": {
                "ms": lambda: kq.quantize_cuda(x, 127, 512),
                "plain_ms": lambda: qops.quantize_plain(x, 127, 512)},
            "dequantize_blocks": {
                "ms": lambda: kq.dequantize_cuda(q, s, 512),
                "plain_ms": lambda: qops.dequantize_plain(q, s, 512)},
        }
        table[name] = _time_calls(calls, quant_bounds(r, n, 512))
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
    b8 = AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                   BlockQuantTransport(8))
    out["block8_solve_ms"] = time_call_ms(
        lambda: b8.dispatch_single(a_p, y_p, M, N))
    return out


def time_col_solves(ctx, col_ctx) -> dict:
    """Device-resident column solves (operands already on the card), host
    pace included, as ``time_solves``; and the column BT decisions alone."""
    prior, out = ctx["prior"], {}
    engines = {"lossless": col_engine(prior, ExactFusion()),
               "dp": col_engine(prior, EcsqTransport(), col_ctx["dp_sched"]),
               "bt": col_engine(prior, EcsqTransport(), col_ctx["bt"]),
               "block8": col_engine(prior, BlockQuantTransport(8))}
    a_cp, y_d = engines["lossless"]._split_col(ctx["y"], ctx["a"])
    for name, eng in engines.items():
        sched = eng._f32(eng._sched_operand())
        out[f"{name}_solve_ms"] = time_call_ms(
            lambda e=eng, s=sched: e._col_solve_core(a_cp, y_d, s, M, N))
    tables = col_ctx["bt"].tables_on(DEV)
    v = torch.tensor(0.01, device=DEV)

    def bt_decisions():
        for t in range(T):
            col_bt_delta_for(tables, t, v)
    out["bt_controller_ms"] = time_call_ms(bt_decisions)
    out["bt_controller_share_of_bt_solve"] = \
        out["bt_controller_ms"] / out["bt_solve_ms"]
    return out


# ---------------------------------------------------------------------------
# LM serving: K5 (decode attention) and K6 (WKV6), gemma3-1b and rwkv6-3b
# ---------------------------------------------------------------------------

DA_CASES = [
    # name, B, H, KV, Dh, S, pos, window, dtype of q, dtype of the caches,
    # NaN in every cache row outside lo..hi (which must never be read)
    ("gemma3_global", 8, 4, 1, 256, 1032, 1031, 0, torch.bfloat16, torch.bfloat16, False),
    ("gemma3_local", 8, 4, 1, 256, 1032, 1031, 512, torch.bfloat16, torch.bfloat16, False),
    ("gemma3_local_pos_lt_window", 8, 4, 1, 256, 1032, 300, 512, torch.bfloat16,
     torch.bfloat16, False),
    ("pos0_global", 8, 4, 1, 256, 1032, 0, 0, torch.bfloat16, torch.bfloat16, False),
    ("pos0_local", 8, 4, 1, 256, 1032, 0, 512, torch.bfloat16, torch.bfloat16, False),
    ("ragged_f32_global", 8, 4, 1, 256, 1001, 1000, 0, torch.float32, torch.float32, False),
    ("ragged_f32_local", 8, 4, 1, 256, 1001, 777, 512, torch.float32, torch.float32, False),
    ("glm4_gqa_G16", 2, 32, 2, 128, 600, 599, 0, torch.bfloat16, torch.bfloat16, False),
    ("smoke_Dh16", 2, 4, 2, 16, 40, 20, 32, torch.bfloat16, torch.bfloat16, False),
    ("long_B8_S32768", 8, 4, 1, 256, 32768, 32767, 0, torch.bfloat16, torch.bfloat16, False),
    # rows 389..900 of 1032: 0 < lo and hi < S - 1, the rest NaN; one bulk
    # copy a stage (KV = 1) and one a row (KV = 2, float32)
    ("nan_outside_rows", 8, 4, 1, 256, 1032, 900, 512, torch.bfloat16, torch.bfloat16, True),
    ("nan_outside_rows_kv2_f32", 2, 8, 2, 128, 700, 500, 300, torch.float32,
     torch.float32, True),
    # yi-34b's heads: 64 (b, kv head) groups of G = 7, two head slices each
    ("yi34b_G7", 8, 56, 8, 128, 1032, 1031, 0, torch.bfloat16, torch.bfloat16, False),
    # 21 rows: one split a group
    ("one_split_per_group", 8, 4, 1, 256, 1032, 20, 0, torch.bfloat16, torch.bfloat16,
     False),
    # bf16 caches, float32 q (and output)
    ("f32_q_bf16_cache", 8, 4, 1, 256, 1032, 1031, 512, torch.float32, torch.bfloat16,
     False),
]
# two shapes of different plans, called in turns: each call must give the
# bits of its shape's first call (the last block of a group resets its
# counter; a counter left behind would change the next launch)
DA_ALTERNATE = ("gemma3_global", "b2_global")
DA_B2 = ("b2_global", 2, 4, 1, 256, 1032, 1031, 0, torch.bfloat16,
         torch.bfloat16, False)


def da_inputs(b, h, kv, dh, s, q_dtype, c_dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    rnd = lambda dt, *shape: torch.randn(*shape, generator=g, device=DEV).to(dt)
    return rnd(q_dtype, b, h, dh), rnd(c_dtype, b, s, kv, dh), rnd(c_dtype, b, s, kv, dh)


def da_plan(b, h, kv, dh, lo, hi, c_dtype) -> dict | None:
    """The wrapper's launch plan for these shapes: (b, kv head, head slice)
    units, runs of rows and the resident blocks it planned for. None for a
    wrapper without the occupancy query (the two-kernel version before it,
    timed by ``--k5-only`` beside this one)."""
    if not hasattr(kd, "resident_blocks"):
        return None
    units = b * kv * kd.head_slices(h // kv)
    slots = kd.resident_blocks(DEV, c_dtype, dh)
    rows, nsplit = kd.split_plan(units, lo, hi, slots)
    return {"units": units, "rows_per_split": rows, "nsplit": nsplit,
            "blocks": units * nsplit, "resident_blocks": slots,
            "layout": kd.layout(dh, torch.empty((), dtype=c_dtype).element_size())}


def check_decode_attn_kernel() -> dict:
    """K5 against its plain version on the card. float32 output: 1e-5 of
    the output's scale (softmax sums in another order). bfloat16 output:
    both round a float32 result to bf16 once, so they may differ by one
    bf16 ulp (2^-7 relative, plus 1e-6 for values near zero). Bit-identical
    over two calls, and over calls of two plans in turns (``DA_ALTERNATE``).
    In the NaN cases the plain version gets the caches before the NaN is
    written."""
    rows, firsts = [], {}
    for name, b, h, kv, dh, s, pos, win, q_dt, c_dt, nan in DA_CASES + [DA_B2]:
        q, kc_, vc_ = da_inputs(b, h, kv, dh, s, q_dt, c_dt, SEED)
        lo, hi = valid_rows(s, pos, win)
        want = decode_attn_ref(q, kc_, vc_, pos, win)
        if nan:
            outside = torch.ones(s, dtype=torch.bool, device=DEV)
            outside[lo:hi + 1] = False
            kc_[:, outside] = float("nan")
            vc_[:, outside] = float("nan")
        out = kd.decode_attn_cuda(q, kc_, vc_, pos, win)
        again = kd.decode_attn_cuda(q, kc_, vc_, pos, win)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        row = {"case": name, "B": b, "H": h, "KV": kv, "Dh": dh, "S": s,
               "pos": pos, "window": win, "q_dtype": str(q_dt).split(".")[-1],
               "cache_dtype": str(c_dt).split(".")[-1], "nan_outside": nan,
               "lo": lo, "hi": hi, "rows_read": hi - lo + 1,
               "plan": da_plan(b, h, kv, dh, lo, hi, c_dt),
               "max_abs_err": float(diff.max()),
               "rel_err": float(diff.max() / want.float().abs().max()),
               "bit_identical": bool(torch.equal(out, again))}
        rows.append(row)
        assert out.shape == q.shape and out.dtype == q.dtype, row
        assert bool(torch.isfinite(out).all()), row
        if q_dt == torch.float32:
            assert row["rel_err"] <= KERNEL_RTOL, row
        else:
            assert bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-6).all()), row
        assert row["bit_identical"], row
        if name in DA_ALTERNATE:
            firsts[name] = ((q, kc_, vc_, pos, win), out)
        del q, kc_, vc_, out, again, want
    turns = []
    for _ in range(3):
        for name in DA_ALTERNATE:
            args, first = firsts[name]
            turns.append(bool(torch.equal(kd.decode_attn_cuda(*args), first)))
    torch.cuda.synchronize()
    assert all(turns), turns
    emit("kernel_check_decode_attn", f32_rtol=KERNEL_RTOL,
         bf16_limit="1 bf16 ulp", cases=rows,
         alternating={"shapes": DA_ALTERNATE, "calls_bit_identical": turns})
    return {r["case"]: r for r in rows}


WKV_CASES = [
    # name, B, T, H, Dh, dtype of r/k/v, non-zero state0
    ("rwkv6_3b_prefill", 4, 1000, 40, 64, torch.bfloat16, False),
    ("rwkv6_3b_state0", 4, 1000, 40, 64, torch.bfloat16, True),
    ("ragged_T70_f32", 2, 70, 3, 64, torch.float32, True),
    ("smoke_Dh16", 2, 45, 4, 16, torch.bfloat16, True),
    # two (b, h): the plan takes the largest NV (slices of 8 columns)
    ("max_nv_T70_f32", 1, 70, 2, 64, torch.float32, True),
    # rows of 8 bytes, under the 16-byte copies: plain loads; NV = 1
    ("rows_8B_Dh4_bf16", 2, 45, 3, 4, torch.bfloat16, True),
]


def wkv_inputs(b, t, h, dh, dtype, state, seed):
    """As the CPU tests draw them: log-decay clamped at -2, as the model
    clamps it."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=DEV)
    r, k_, v = (0.5 * rnd(b, t, h, dh) for _ in range(3))
    logw = torch.clamp(-torch.exp(0.5 * rnd(b, t, h, dh) - 1.0), min=-2.0)
    u = 0.3 * rnd(h, dh)
    s0 = 0.3 * rnd(b, h, dh, dh) if state else None
    return r.to(dtype), k_.to(dtype), v.to(dtype), logw, u, s0


def wkv_plan_of(b, h, dh, dtype) -> dict:
    """The wrapper's plan for a case: NV value slices of VB columns, and the
    blocks the card holds at once for each slice width."""
    slots = {dh // nv: kw.max_active_blocks(DEV, dtype, dh, dh // nv)
             for nv in kw.value_splits(dh)}
    nv = kw.wkv_plan(b, h, dh, slots.__getitem__)
    return {"nv": nv, "vb": dh // nv, "blocks": b * h * nv,
            "slots_by_vb": slots}


def check_wkv6_kernel() -> dict:
    """K6 against its plain version (``wkv_chunked``) on the card, y and the
    final state: the reference's tolerance, 3e-4 relative and absolute.
    Bit-identical over two runs. Each case records its plan."""
    rows = []
    for name, b, t, h, dh, dtype, state in WKV_CASES:
        args = wkv_inputs(b, t, h, dh, dtype, state, SEED)
        y, s_fin = kw.wkv6_cuda(*args)
        y2, s2 = kw.wkv6_cuda(*args)
        torch.cuda.synchronize()
        y_r, s_r = wkv_chunked(*args)
        row = {"case": name, "B": b, "T": t, "H": h, "Dh": dh,
               "dtype": str(dtype).split(".")[-1], "state0": state,
               "plan": wkv_plan_of(b, h, dh, dtype),
               "y_max_abs_err": float((y - y_r).abs().max()),
               "y_rel_err": rel_err(y, y_r),
               "state_max_abs_err": float((s_fin - s_r).abs().max()),
               "state_rel_err": rel_err(s_fin, s_r),
               "bit_identical": bool(torch.equal(y, y2) and torch.equal(s_fin, s2))}
        rows.append(row)
        assert y.shape == (b, t, h, dh) and s_fin.shape == (b, h, dh, dh)
        assert torch.allclose(y, y_r, rtol=WKV_TOL, atol=WKV_TOL), row
        assert torch.allclose(s_fin, s_r, rtol=WKV_TOL, atol=WKV_TOL), row
        assert row["bit_identical"], row
        del args, y, y2, s_fin, s2, y_r, s_r
    emit("kernel_check_wkv6", rtol=WKV_TOL, atol=WKV_TOL, cases=rows)
    return {r["case"]: r for r in rows}


def teacher_forced_logits(model, prompts, fed):
    """Prefill ``prompts``, then one decode step per column of ``fed``:
    float32 logits (B, steps, V) of every step."""
    p, n = prompts.shape[1], fed.shape[1]
    state = serve.prefill(model, prompts, p + n)
    out = []
    for i in range(n):
        h, state = model.decode_step(fed[:, i:i + 1], state, p + i)
        out.append(model.logits(h)[:, -1])
    return torch.stack(out, 1)


def check_lm_small() -> dict:
    """The smoke config of each family on the card (K5 / K6) against the CPU
    (plain versions), with the same weights: prefill hidden and 8
    teacher-forced decode steps' logits within 2 % of their scale."""
    out = {}
    for arch in (LM_DENSE, "granite-3-8b", LM_RWKV):
        cfg = get_config(arch).smoke_config()
        cpu = get_model(cfg, device="cpu", seed=SEED)
        gpu = get_model(cfg, state={n: p.detach() for n, p in
                                    cpu.named_parameters()})
        toks = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (2, 48)))
        prompts, fed = toks[:, :40], toks[:, 40:]
        reset_all_counts()
        h_g, _ = gpu(prompts.to(DEV), mode="prefill")
        l_g = teacher_forced_logits(gpu, prompts.to(DEV), fed.to(DEV))
        torch.cuda.synchronize()
        launches = all_counts()
        h_c, _ = cpu(prompts, mode="prefill")
        l_c = teacher_forced_logits(cpu, prompts, fed)
        h_err = float((h_g.float().cpu() - h_c.float()).abs().max()
                      / h_c.float().abs().max())
        l_err = float((l_g.cpu() - l_c).abs().max() / l_c.abs().max())
        want = ({"decode_attn": cfg.n_layers * 8, "wkv6": 0}
                if cfg.family == "dense" else
                {"decode_attn": 0, "wkv6": 2 * cfg.n_layers})
        got = {key: launches[key] for key in want}
        out[arch] = {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                                "n_heads": cfg.n_heads,
                                "n_kv_heads": cfg.n_kv_heads,
                                "d_head": cfg.d_head, "vocab": cfg.vocab},
                     "hidden_err_of_scale": h_err,
                     "logits_err_of_scale": l_err, "launches": got}
        assert got == want, (arch, got, want)
        assert h_err <= LM_SMALL_TOL and l_err <= LM_SMALL_TOL, out[arch]
        del cpu, gpu
    emit("lm_small_card_vs_cpu", limit_of_scale=LM_SMALL_TOL, models=out)
    return out


def lm_decode_sync_sites(model, prompts) -> list:
    """``sync_sites`` over the greedy decode loop alone (prefill before)."""
    state = serve.prefill(model, prompts, LM_PROMPT + LM_GEN)
    run = lambda: (serve.decode(model, state, prompts[:, -1:], LM_PROMPT,
                                LM_GEN).float(), None)
    run()                                           # warm: allocator, cuBLAS
    return sync_sites(run)


def lm_consistency(model, prompts) -> tuple:
    """``serve.generate`` with the logits kept, then one prefill over the
    prompt and the tokens the loop was fed (prompt[-1], then the generated
    ids but the last): the decode logits of every generated position
    against that prefill's. Returns (the generation, the kernel launches of
    the generate call alone, the comparison)."""
    reset_all_counts()
    out = serve.generate(model, prompts, LM_GEN, keep_logits=True)
    launches = all_counts()                          # read just after the path
    p_dev = torch.as_tensor(prompts, device=DEV)
    ids = torch.as_tensor(out.tokens, device=DEV)
    seq = torch.cat([p_dev, p_dev[:, -1:], ids[:, :-1]], dim=1)
    with torch.inference_mode():
        h, _ = model(seq, mode="prefill")
        want = model.logits(h[:, LM_PROMPT:])
    dec, out.logits = out.logits, None
    err = (dec - want).abs()
    scale = float(want.abs().max())
    cmp = {"max_abs_err": float(err.max()), "logits_scale": scale,
           "err_of_scale": float(err.max()) / scale,
           "within_rtol_atol": bool((err <= LM_ATOL + LM_RTOL * want.abs()).all()),
           "argmax_agree": float((want.argmax(-1) == ids).float().mean()),
           "finite": bool(torch.isfinite(dec).all())}
    return out, launches, cmp


def run_lm(arch: str, batch: int) -> dict:
    """``serve.generate`` at full width and depth (random init from SEED):
    the kernel launches of the path, zero host syncs inside the decode loop,
    warm prefill and decode times, and decode against prefill
    (``lm_consistency``) — in bf16, the model as served, and again with the
    same weights in float32, where bf16 rounding cannot hide a fault of the
    cache or state handoff. The dense model is held to the reference's
    tolerance in bf16 too; rwkv6-3b's bf16 numbers are recorded only: its
    random init amplifies bf16 rounding through the layers (the reference's
    own prefill and decode differ by a quarter of the logits' scale at 32
    layers in bf16, ROADMAP Queue 3)."""
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(cfg, seed=SEED)               # the default device: the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                   (batch, LM_PROMPT))
    first, launches, cmp16 = lm_consistency(model, prompts)
    with torch.inference_mode():
        sites = lm_decode_sync_sites(model, torch.as_tensor(prompts, device=DEV))
    warm = [serve.generate(model, prompts, LM_GEN) for _ in range(2)][-1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    state32 = {n: p.detach().float() for n, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    model32 = get_model(cfg, state=state32)
    del state32
    first32, launches32, cmp32 = lm_consistency(model32, prompts)
    del model32
    torch.cuda.empty_cache()

    want_launch = ({"decode_attn": cfg.n_layers * LM_GEN, "wkv6": 0}
                   if cfg.family == "dense" else
                   {"decode_attn": 0, "wkv6": cfg.n_layers})
    got = {key: launches[key] for key in want_launch}
    got32 = {key: launches32[key] for key in want_launch}
    result = {
        "arch": arch, "batch": batch, "prompt": LM_PROMPT, "gen": LM_GEN,
        "seed": SEED, "n_params": n_params, "init_s": init_s,
        "first_ids": first.tokens[0].tolist(),
        "decode_vs_prefill_bf16": cmp16, "decode_vs_prefill_f32": cmp32,
        "launches": got, "launches_f32": got32,
        "synchronizing_calls_in_decode_loop": len(sites),
        "ids_same_on_rerun": bool(np.array_equal(first.tokens, warm.tokens)),
        "first_call_prefill_s": first.prefill_s,
        "first_call_decode_s": first.decode_s,
        "prefill_ms": 1e3 * warm.prefill_s,
        "prefill_tok_per_s": batch * LM_PROMPT / warm.prefill_s,
        "decode_ms_per_step": 1e3 * warm.decode_s / LM_GEN,
        "decode_tok_per_s": batch * LM_GEN / warm.decode_s,
        "peak_memory_gb_bf16": peak_gb,
    }
    assert first.tokens.shape == (batch, LM_GEN), first.tokens.shape
    assert cmp16["finite"] and cmp32["finite"], result
    assert cmp32["within_rtol_atol"] and cmp32["err_of_scale"] <= LM_F32_TOL, result
    if cfg.family == "dense":
        assert cmp16["within_rtol_atol"], result
    assert got == want_launch and got32 == want_launch, (got, got32, want_launch)
    assert not sites, f"host syncs inside the decode loop: {sorted(set(sites))}"
    emit(f"lm_{cfg.family}", limits={"rtol": LM_RTOL, "atol": LM_ATOL,
                                     "f32_err_of_scale": LM_F32_TOL},
         **result)
    return result


def decode_attn_bound(b, h, kv, dh, rows, dtype) -> dict:
    """K5's least time: q read and the output written once, and K and V of
    the rows the position attends to (the only ones needed) read once; two
    float32 FMAs per head, row and channel (scores and PV) plus ~5
    operations per head and row for the softmax."""
    e = 2 if dtype == torch.bfloat16 else 4
    nbytes = 2 * b * h * dh * e + 2 * rows * b * kv * dh * e
    return bound(nbytes, 4.0 * b * h * dh * rows + 5.0 * b * h * rows)


def wkv6_bound(b, t, h, dh, dtype, state) -> dict:
    """K6's least time: r, k, v, logw, u and the initial state read once, y
    and the final state written once; the operations of the chunked form
    over the T real steps, the four products (per chunk of c steps and head:
    r'k'^T and its product with v over the lower triangle, r'S, the state
    update) at the dense TF32 tensor-core rate, the rest (u-bonus,
    rebasing, decay of S) at the float32 CUDA-core rate. The ragged last
    chunk counts its real steps, not the padded ones.
    ``bound_ms_cuda_cores`` keeps the earlier figure, every operation at
    the CUDA-core rate."""
    e = 2 if dtype == torch.bfloat16 else 4
    n = b * t * h * dh
    st = b * h * dh * dh * 4
    nbytes = 3 * n * e + 4 * n + 4 * h * dh + (st if state else 0) + 4 * n + st

    def products(c):
        return (2 * c * (c - 1) * dh                 # A and A v, lower triangle
                + 2 * c * dh * dh                    # r' S
                + 2 * dh * dh * c)                   # (k' e^{l_tot})^T v

    def rest_ops(c):
        return (2 * c * dh                           # diag v
                + 3 * c * dh + 4 * c * dh            # u-bonus, rebasing
                + c * dh                             # k' scaled by e^{l_tot}
                + 2 * dh * dh)                       # decay of S, and the sum
    full, rest = divmod(t, CHUNK)
    prod = b * h * (full * products(CHUNK) + (products(rest) if rest else 0))
    other = b * h * (full * rest_ops(CHUNK) + (rest_ops(rest) if rest else 0))
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = prod / TF32_FLOP_PER_S + other / FP32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "flops": float(prod + other),
            "tensor_core_flops": float(prod), "cuda_core_flops": float(other),
            "bound_ms_cuda_cores": bound(nbytes, float(prod + other))["bound_ms"]}


def time_wkv6() -> dict:
    """K6 at rwkv6-3b's prefill shape (bf16, a state in): the plan's NV
    with its plain version beside it, and NV = 1, 2 and 4 given to the
    wrapper. No one PyTorch call computes the recurrence."""
    b, t, h, dh = LM_RWKV_BATCH, LM_PROMPT, 40, 64
    args = wkv_inputs(b, t, h, dh, torch.bfloat16, True, SEED)
    bnd = {"wkv6": wkv6_bound(b, t, h, dh, torch.bfloat16, True)}
    plan = wkv_plan_of(b, h, dh, torch.bfloat16)
    table = {"rwkv6_3b_prefill": {**_time_calls(
        {"wkv6": {"ms": lambda: kw.wkv6_cuda(*args),
                  "plain_ms": lambda: wkv_chunked(*args)}}, bnd)["wkv6"],
        "plan": plan}}
    for nv in (1, 2, 4):
        row = _time_calls({"wkv6": {"ms": lambda: kw.wkv6_cuda(*args, nv=nv)}},
                          bnd)["wkv6"]
        table[f"rwkv6_3b_prefill_nv{nv}"] = {
            key: row[key] for key in ("ms", "bound_ms", "share_of_bound",
                                      "wrapper_call_ms")}
        table[f"rwkv6_3b_prefill_nv{nv}"]["blocks"] = b * h * nv
    return table


# copies of the caches a cold row rotates over: at gemma3-1b's decode shape
# 8 x 8.4 MB, more than the 50 MB L2, so each call finds its rows in device
# memory, as the decode path does (a step reads the rest of the model's
# weights between two uses of one layer's cache)
DA_COLD_COPIES = 8


def _rotating(fn, args_list):
    """``fn`` over ``args_list`` in turns, one set of arguments a call."""
    it = itertools.cycle(args_list)
    return lambda: fn(*next(it))


def time_decode_attn() -> dict:
    """K5 at gemma3-1b's decode shapes (a global and a local layer at the
    path's last step), L2-hot (one set of caches, as ``time_ms`` leaves
    them) and L2-cold (``DA_COLD_COPIES`` sets in turns), and one layer at
    B=8, S=32768 (268 MB: cold by itself). Library yardstick:
    ``scaled_dot_product_attention`` with GQA and the boolean mask over the
    whole cache, timed the same way."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    table = {}
    pos = LM_PROMPT + LM_GEN - 1
    b, h, kv, dh, dtype = LM_DENSE_BATCH, 4, 1, 256, torch.bfloat16
    for name, s, p_, win, copies in (
            ("gemma3_global", LM_PROMPT + LM_GEN, pos, 0, 1),
            ("gemma3_local", LM_PROMPT + LM_GEN, pos, 512, 1),
            ("gemma3_global_cold", LM_PROMPT + LM_GEN, pos, 0, DA_COLD_COPIES),
            ("gemma3_local_cold", LM_PROMPT + LM_GEN, pos, 512, DA_COLD_COPIES),
            ("long_B8_S32768", 32768, 32767, 0, 1)):
        t_idx = torch.arange(s, device=DEV)
        mask = t_idx <= p_
        if win:
            mask &= t_idx > p_ - win
        mask = mask[None, None, None]
        ours, lib = [], []
        for i in range(copies):
            q, kc_, vc_ = da_inputs(b, h, kv, dh, s, dtype, dtype, SEED + i)
            ours.append((q, kc_, vc_, p_, win))
            lib.append((q[:, :, None], kc_.transpose(1, 2).contiguous(),
                        vc_.transpose(1, 2).contiguous()))
        calls = {"decode_attn": {
            "ms": _rotating(kd.decode_attn_cuda, ours),
            "plain_ms": _rotating(decode_attn_ref, ours),
            "library_ms": _rotating(lambda q4, k_t, v_t: sdpa(
                q4, k_t, v_t, attn_mask=mask, enable_gqa=True), lib)}}
        lo, hi = valid_rows(s, p_, win)
        bounds = {"decode_attn": decode_attn_bound(b, h, kv, dh, hi - lo + 1,
                                                   dtype)}
        table[name] = _time_calls(calls, bounds)["decode_attn"]
        table[name].update(S=s, pos=p_, window=win, rows_read=hi - lo + 1,
                           cache_copies=copies,
                           plan=da_plan(b, h, kv, dh, lo, hi, dtype))
        del ours, lib
    return table


def time_lm_kernels() -> dict:
    """K5 (``time_decode_attn``) and K6 at rwkv6-3b's prefill shape
    (``time_wkv6``; no one PyTorch call computes the recurrence)."""
    return {**time_decode_attn(), **time_wkv6()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every phase's result to "
                                      "this JSON file")
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--k6-only", action="store_true",
                      help="build the WKV6 kernel, check it and time it "
                           "(kernel_check_wkv6, timing_wkv6), and stop: no "
                           "other phase and no last line")
    only.add_argument("--k5-only", action="store_true",
                      help="build the decode-attention kernel, check it and "
                           "time it hot and cold (kernel_check_decode_attn, "
                           "timing_k5), and stop: no other phase; the last "
                           "line as in a full run")
    args = parser.parse_args()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", nvidia_smi_name_power_limit=smi,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    names = (["wkv6"] if args.k6_only else ["decode_attn"] if args.k5_only
             else ["amp_local", "amp_col", "quantize", "decode_attn", "wkv6"])
    paths = build.ensure_built(names)
    libraries = {"amp_local": k, "amp_col": kc, "quantize": kq,
                 "decode_attn": kd, "wkv6": kw}
    for name in names:
        libraries[name]._library()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={n: os.path.relpath(str(p), ROOT) for n, p in paths.items()},
         nvcc=[{key: rec[key] for key in ("name", "command", "seconds")}
               for rec in build.build_log],
         ptxas=[line for rec in build.build_log
                for line in rec["stderr"].splitlines()
                if "registers" in line or "spill" in line
                or "Function properties" in line],
         # K6's four products run on tensor cores: mma.sync TF32 is HMMA
         wkv6_sass_tensor_ops=(tensor_core_ops(paths["wkv6"])
                               if "wkv6" in paths else None))
    if "wkv6" in paths:
        assert any(op.startswith("HMMA") for op in
                   RESULT["build"]["wkv6_sass_tensor_ops"]), RESULT["build"]
    if args.k6_only or args.k5_only:
        if args.k6_only:
            check_wkv6_kernel()
            emit("timing_wkv6", card=smi, kernels=time_wkv6())
        else:
            check_decode_attn_kernel()
            emit("timing_k5", card=smi, kernels=time_decode_attn())
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(RESULT, fh, indent=1)
        if args.k5_only:
            print(smi, flush=True)
            print_last_line()
        return

    check_clusters()
    errs = check_kernels()
    errs_col = check_col_kernels()
    errs_q = check_quantize_kernels()
    check_against_cpu_reference()
    ctx = run_main_path()
    col_ctx = run_col_path(ctx)
    bq_ctx = run_block_quant_row(ctx)
    check_no_host_sync(ctx, col_ctx)
    errs_da = check_decode_attn_kernel()
    errs_wkv = check_wkv6_kernel()
    check_lm_small()
    lm_dense = run_lm(LM_DENSE, LM_DENSE_BATCH)
    lm_rwkv = run_lm(LM_RWKV, LM_RWKV_BATCH)

    kernel_times = time_kernels()
    col_times = time_col_kernels()
    quant_times = time_quantize_kernels()
    solve_times = time_solves(ctx)
    col_solve_times = time_col_solves(ctx, col_ctx)
    emit("timing", card=smi,
         method="CUDA events, warm, median; kernels queued behind a busy "
                "device (device time), solves on an idle one (host pace "
                "included)",
         lc_step=kernel_times, col_kernels=col_times,
         quantize_kernels=quant_times, solve=solve_times,
         col_solve=col_solve_times)
    lm_times = time_lm_kernels()
    emit("timing_lm", card=smi,
         method="kernels as above (device time, queued behind a busy "
                "device); prefill and decode from serve.generate, host "
                "clock, device synchronised at both ends, warm",
         kernels=lm_times,
         serve={arch: {key: r[key] for key in (
             "batch", "prompt", "gen", "prefill_ms", "prefill_tok_per_s",
             "decode_ms_per_step", "decode_tok_per_s", "peak_memory_gb_bf16")}
             for arch, r in ((LM_DENSE, lm_dense), (LM_RWKV, lm_rwkv))})

    # each kernel: its time at the shape its main path gives it, its
    # launches on the path(s) that drove it (counts reset just before each)
    col_launches, bq_launches = col_ctx["launches"], bq_ctx["launches"]
    q_err = max(r["q_max_abs_err"] for r in errs_q.values())
    d_err = max(r["dequantized_max_abs_err"] for r in errs_q.values())
    paper_col = errs_col[("paper_P25", "float32")]
    lc_err = lambda case: max(errs[(case, "float32")]["z_max_abs_err"],
                              errs[(case, "float32")]["f_max_abs_err"])
    rows = {
        "amp_local": (kernel_times["paper_P30/float32"]["amp_local"],
                      ctx["launches"]["amp_local"], lc_err("paper_P30")),
        # no driven path takes it any more (N <= 131072 everywhere); timed
        # and checked past the cluster's reach
        "amp_local_two_pass": (
            kernel_times[f"{TWO_PASS_CASE}/float32"]["amp_local_two_pass"],
            ctx["launches"]["amp_local_two_pass"]
            + col_launches["amp_local_two_pass"]
            + bq_launches["amp_local_two_pass"], lc_err(TWO_PASS_CASE)),
        "col_residual": (col_times["paper_P25/float32"]["col_residual"],
                         col_launches["col_residual"],
                         paper_col["r_max_abs_err"]),
        "col_inner": (col_times["paper_P25/float32"]["col_inner_final"],
                      col_launches["col_inner"],
                      max(paper_col["x_max_abs_err_final"],
                          paper_col["x_max_abs_err_upd"],
                          paper_col["z_max_abs_err_upd"])),
        "quantize_blocks": (quant_times["row_messages"]["quantize_blocks"],
                            col_launches["quantize_blocks"]
                            + bq_launches["quantize_blocks"], q_err),
        "dequantize_blocks": (quant_times["row_messages"]["dequantize_blocks"],
                              col_launches["dequantize_blocks"]
                              + bq_launches["dequantize_blocks"], d_err),
        "decode_attn": (lm_times["gemma3_global"],
                        lm_dense["launches"]["decode_attn"],
                        errs_da["gemma3_global"]["max_abs_err"]),
        "wkv6": (lm_times["rwkv6_3b_prefill"], lm_rwkv["launches"]["wkv6"],
                 max(errs_wkv["rwkv6_3b_prefill"]["y_max_abs_err"],
                     errs_wkv["rwkv6_3b_state0"]["y_max_abs_err"])),
    }
    kernels = []
    for name, (tm, launches, err) in rows.items():
        assert launches > 0 or name == "amp_local_two_pass", (name, launches)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({**RESULT, "kernels": kernels}, fh, indent=1)

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print_last_line()


def print_last_line() -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
