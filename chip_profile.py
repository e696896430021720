#!/usr/bin/env python3
"""Where the device time of one solve, or of one LM serving step, goes, on
one NVIDIA GPU.

    python3 chip_profile.py [--amp-only | --fuse-only | --lm-only
                             | --train-only]

Runs under ``torch.profiler``: the PyTorch/CUDA port's row-layout MP-AMP
solve at the paper's size (N=10000, M=3000, P=30, T=10, eps=0.05, 20 dB;
operands already on the card) — lossless, DP-rated and BT-rated — and the
centralized AMP solve of ``chip_smoke.py``'s wide problem (N=20000, M=4000,
T=10: one shard of rows of 20000, K1's widest driven rows); then the
block-quantized transport: one ``BlockQuantTransport(8).fuse`` call on the
row messages (P=30, N) and on the column contributions (P=25, M), each
also timed on the device, and one row int8 solve; then the heterogeneous
batch solve (``AmpEngine.dispatch_het``, the solve service's call) of a
row bucket of 8 at the paper's size and a column bucket of 4 at the wide
problem (P=20), each without and with BT-rated instances; then, unless
``--amp-only``, at ``chip_smoke.py``'s LM shapes (random init from seed
1234, prompts of 1000 tokens), one gemma3-1b decode step (B=8), one rwkv6-3b
prefill (B=4) and one rwkv6-3b decode step, and one decode step of each
model of ``chip_smoke.py``'s LM zoo at its batch and prompt (gemma3-1b
after 32768 tokens, qwen3-moe-30b-a3b, recurrentgemma-2b, qwen2-vl-7b,
whisper-small). ``--fuse-only`` runs the block-quantized part alone,
``--lm-only`` the LM part alone, ``--train-only`` one LM train step alone:
``chip_smoke.py``'s gemma3-1b int8 step (8 x 4096 tokens in 4
microbatches, every layer recomputed, the 13 leaves' ``compressed_psum``
over a "pod" of one on an NCCL world of one), with its device time by
kind of kernel and the peak device memory after each part of the step
(gradients, fusion, the whole step). It prints one JSON object per call: the number
of kernels launched (for a solve also per iteration), the span from the
first kernel's start to the last one's end, the time the device was busy
inside it, the launches of the call's hand-written kernels (for a solve
also per iteration: K1's band kernel and its combine, two a step; the
block-quantized fusion, one a step; for a decode step K5, one an attention
layer, two a Whisper layer) and their share of the busy time, beside the launches the kernels'
wrappers counted (which tell whether the trace dropped events), and the ten
heaviest kernels by name. The profiler slows the host
down, so the span is longer than an unprofiled call's (``chip_smoke.py``
times that); the busy time and the kernel counts are not affected.

Informational: it checks nothing. Needs a CUDA device and nvcc (the kernels
are built at first use); needs no network.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

if not torch.cuda.is_available():
    sys.exit("chip_profile.py: torch.cuda.is_available() is False; "
             "this script needs one CUDA device")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core.amp import sample_problem  # noqa: E402
from repro_torch.core.denoisers import (BernoulliGauss,  # noqa: E402
                                        make_mmse_interp)
from repro_torch.core.engine import (AmpEngine,  # noqa: E402
                                     BlockQuantTransport, BTRateControl,
                                     BTTables, ColBTTables,
                                     ColumnBTRateControl, ColumnPartition,
                                     DPSchedule, EcsqTransport, EngineConfig,
                                     ExactFusion, FixedSchedule, HetParams,
                                     pad_bt_tables, split_problem_cols,
                                     stack_bt_tables)
from repro_torch.core.rate_alloc import dp_allocate  # noqa: E402
from repro_torch.core.rate_distortion import RDModel  # noqa: E402
from repro_torch.core.state_evolution import PAPER_T, CSProblem  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.amp_fused import amp_fused as k1  # noqa: E402
from repro_torch.kernels.amp_fused import col as k23  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn as k5  # noqa: E402
from repro_torch.kernels.quantize import quantize as k4  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6 as k6  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import init_cluster, make_mesh  # noqa: E402
from repro_torch.launch.steps import (TrainStepConfig,  # noqa: E402
                                      build_train_step)
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

N, M, P, EPS, SNR_DB, SEED = 10_000, 3_000, 30, 0.05, 20.0, 1234
P_COL = 25
T = PAPER_T[EPS]
WIDE_N, WIDE_M = 20_000, 4_000
LM_PROMPT = 1000
# (arch, batch, prompt) as chip_smoke.py's LM_ZOO
LM_ZOO = [("gemma3-1b", 1, 32768), ("qwen3-moe-30b-a3b", 8, 1000),
          ("recurrentgemma-2b", 4, 3000), ("qwen2-vl-7b", 4, 2048),
          ("whisper-small", 8, 448)]


def profile_call(fn, tag: str) -> dict:
    """Profile one call of ``fn`` (after a warm one); ``tag`` names the
    hand-written kernels whose share of the busy time is reported."""
    fn()                                         # warm
    torch.cuda.synchronize()
    counts = (k1.launch_counts, k23.launch_counts, k4.launch_counts,
              k5.launch_counts, k6.launch_counts)
    before = {key: v for c in counts for key, v in c.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the wrappers count their own launches: a trace that holds fewer of
    # their kernels than that (K1: two a single-read step) has dropped events
    counted = {key: v - before[key] for c in counts for key, v in c.items()
               if v != before[key]}
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not kernels:
        return {"device_events": 0}
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    ours = sum(v for name, v in by_name.items() if tag in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    kinds: dict[str, float] = {}
    for name, v in by_name.items():
        kind = next((k for k, keys in KINDS
                     if any(key in name.lower() for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + v / 1e3
    return {"device_events": len(kernels), "span_ms": span / 1e3,
            "wrapper_launches": counted,
            "busy_ms": busy / 1e3, "busy_share_of_span": busy / span,
            "kernel_tag": tag, "tagged_kernels_ms": ours / 1e3,
            "tagged_launches": sum(tag in e.name for e in kernels),
            "tagged_share_of_busy": ours / busy, "busy_ms_by_kind": kinds,
            "top": [{"ms": v / 1e3, "name": name[:100]} for name, v in top]}


def device_ms(fn, repeats: int = 7, inner: int = 5) -> float:
    """Device time of one call of ``fn``: CUDA events around ``inner``
    calls queued behind a few milliseconds of other work (so that the host's
    pace of launching is hidden), median of ``repeats`` (as
    ``chip_smoke.py::time_ms``)."""
    busy = torch.randn(6144, 6144, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.mm(busy, busy)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return sorted(times)[len(times) // 2]


def profile_block_quant(smi: str, prior, a, y) -> None:
    """One ``BlockQuantTransport(8).fuse`` call at the two transports'
    shapes (kernels a call, device ms), then one row int8 solve."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    transport = BlockQuantTransport(8)
    for name, p, n in (("row_messages", P, N), ("col_contributions", P_COL, M)):
        f_p = torch.randn(p, n, generator=gen, device="cuda")
        row = profile_call(lambda: transport.fuse(f_p, None), "quant")
        row["device_ms"] = device_ms(lambda: transport.fuse(f_p, None))
        print(json.dumps({"fuse": name, "P": p, "L": n, "card": smi, **row}),
              flush=True)
    eng = AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T), transport)
    a_p, y_p = eng._split(y, a)
    row = profile_call(lambda: eng.dispatch_single(a_p, y_p, M, N), "quant")
    row["kernels_per_iteration"] = row.get("device_events", 0) / T
    row["tagged_launches_per_iteration"] = row.get("tagged_launches", 0) / T
    print(json.dumps({"solve": "int8", "card": smi, "T": T, **row}),
          flush=True)


def _het_params(b, n, m, p, t, eps, use_bt, tables, dummy):
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device="cuda")
    return HetParams(
        sched=torch.full((b, t), float("inf"), device="cuda"),
        t_active=torch.full((b,), t, device="cuda"),
        m_real=f32([float(m)] * b), n_real=torch.full((b,), n, device="cuda"),
        eps=f32(eps), mu_s=f32([0.0] * b), sigma_s=f32([1.0] * b),
        use_bt=torch.tensor(use_bt, device="cuda"),
        bt=stack_bt_tables([tables if u else dummy for u in use_bt]))


def profile_het(smi: str) -> None:
    """The heterogeneous batch solve: a row bucket of B=8 at the paper's
    size (P=30; eps 0.05 and 0.10 in turns, lossless) and a column bucket
    of B=4 at the wide problem (P=20), each with no BT instance and with
    every other instance BT-rated (the per-instance tables' controller:
    ``bt_delta_for`` / ``col_bt_delta_for`` run for the whole batch)."""
    for layout, b, n, m, p, tag in (("row", 8, N, M, P, "amp_local_"),
                                    ("col", 4, WIDE_N, WIDE_M, 20, "col_")):
        eps = [0.05, 0.10] * (b // 2)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
        prob = CSProblem(n=n, m=m, prior=BernoulliGauss(0.05), snr_db=SNR_DB)
        probs = [sample_problem(gen, n, m, BernoulliGauss(e), prob.sigma_e2)
                 for e in eps]
        if layout == "col":
            a_b = torch.stack([split_problem_cols(q[1], p) for q in probs])
            y_b = torch.stack([q[2] for q in probs])
            tables = ColumnBTRateControl(prob, p, T, 1.005, 6.0).tables
            dummy = ColBTTables.dummy(T)
            cfg = dict(layout=ColumnPartition(1))
        else:
            a_b = torch.stack([q[1].reshape(p, m // p, n) for q in probs])
            y_b = torch.stack([q[2].reshape(p, m // p) for q in probs])
            tables = BTRateControl(prob, p, T, 1.005, 6.0).tables
            dummy = BTTables.dummy(T)
            cfg = {}
        del probs
        eng = AmpEngine(BernoulliGauss(), EngineConfig(
            n_proc=p, n_iter=T, collect_symbols=False, collect_xs=False,
            **cfg), EcsqTransport())
        tables, dummy = pad_bt_tables(tables, T).to("cuda"), dummy.to("cuda")
        for with_bt in (False, True):
            use_bt = [with_bt and i % 2 == 1 for i in range(b)]
            hp = _het_params(b, n, m, p, T, eps, use_bt, tables, dummy)
            run = lambda h=hp, w=with_bt: eng.dispatch_het(a_b, y_b, h, w)
            row = profile_call(run, tag)
            row["kernels_per_iteration"] = row.get("device_events", 0) / T
            row["tagged_launches_per_iteration"] = \
                row.get("tagged_launches", 0) / T
            row["device_ms"] = device_ms(run, repeats=3, inner=2)
            print(json.dumps({"het": layout, "B": b, "N": n, "M": m, "P": p,
                              "with_bt": with_bt, "card": smi, "T": T,
                              **row}), flush=True)
        del a_b, y_b


def profile_lm(smi: str) -> None:
    """One gemma3-1b decode step (B=8, at position 1000 after a prefill of
    1000 tokens), one rwkv6-3b prefill (B=4, 1000 tokens) and one rwkv6-3b
    decode step; then one decode step of each ``LM_ZOO`` model after its
    prompt (with the stub inputs)."""
    runs = [("gemma3-1b", 8, LM_PROMPT), ("rwkv6-3b", 4, LM_PROMPT)] + LM_ZOO
    with torch.inference_mode():
        for arch, batch, prompt in runs:
            cfg = get_config(arch)
            model = get_model(cfg, seed=SEED)
            prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
                0, cfg.vocab, (batch, prompt)), device="cuda")
            state = serve.prefill(model, prompts, prompt + 1,
                                  serve.stub_inputs(model, batch, prompt))
            tok = prompts[:, -1:]
            tag = "wkv6_chunk" if cfg.family == "rwkv6" else "decode_attn"
            calls = {"decode_step": lambda: model.decode_step(tok, state,
                                                              prompt)}
            if cfg.family == "rwkv6":
                calls = {"prefill": lambda: model(prompts, mode="prefill"),
                         **calls}
            for what, fn in calls.items():
                print(json.dumps({"lm": arch, "call": what, "batch": batch,
                                  "prompt": prompt, "card": smi,
                                  **profile_call(fn, tag)}), flush=True)
            del model, state
            torch.cuda.empty_cache()


# kinds of kernel by name, first match wins: the block quantizer (K4), the
# collectives, the matrix products (cuBLAS / CUTLASS), the rest
KINDS = (("k4", ("quantize",)), ("nccl", ("nccl",)),
         ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "cublas")))


def profile_train(smi: str) -> None:
    """One gemma3-1b int8 train step as ``chip_smoke.py``'s phase ``train``
    runs it (world of one, mesh (1, 1, 1), seed 1234), profiled after a
    warm step; the device time by kind (``KINDS``), and the peak device
    memory after the microbatches' gradients, after their fusion and after
    the whole step, each from a reset."""
    import tempfile
    import torch.distributed as dist
    store = os.path.join(tempfile.mkdtemp(prefix="amp_prof_"), "store")
    init_cluster(num_processes=1, process_id=0, backend="nccl",
                 store_path=store, device="cuda:0")
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                         device="cuda:0")
        cfg = get_config("gemma3-1b")
        shape = ShapeSpec("train_4k_cut", 4096, 8, "train")
        step = build_train_step(cfg, mesh, shape, TrainStepConfig(
            microbatches=4, compression_bits=8))
        params = step.init_params(SEED)
        opt = step.init_opt_state(params)
        tok, lab = SyntheticLMData(cfg.vocab, 4096, 8,
                                   seed=SEED).global_arrays(0, mesh)
        peaks = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = step._grads(params, tok, lab)
        torch.cuda.synchronize()
        peaks["gradients"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            loss, grads, _ = step._fuse(loss, grads)
        torch.cuda.synchronize()
        peaks["fusion"] = torch.cuda.max_memory_allocated() / 1e9
        del loss, grads
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step(params, opt, tok, lab)
        torch.cuda.synchronize()
        peaks["step"] = torch.cuda.max_memory_allocated() / 1e9
        peaks["resident_params_and_state"] = torch.cuda.memory_allocated() / 1e9
        row = profile_call(lambda: step(params, opt, tok, lab), "quantize")
    finally:
        dist.destroy_process_group()
    print(json.dumps({"train": "gemma3-1b", "call": "int8_step",
                      "tokens": 8 * 4096, "microbatches": 4, "card": smi,
                      "peak_gb": peaks, **row}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--amp-only", action="store_true",
                      help="profile the AMP solves only, not LM serving")
    only.add_argument("--fuse-only", action="store_true",
                      help="profile the block-quantized transport only: "
                           "two fuse calls and one row int8 solve")
    only.add_argument("--lm-only", action="store_true",
                      help="profile LM serving only")
    only.add_argument("--train-only", action="store_true",
                      help="profile one gemma3-1b int8 train step only")
    args = parser.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.lm_only:
        profile_lm(smi)
        return
    if args.train_only:
        profile_train(smi)
        return
    prior = BernoulliGauss(eps=EPS)
    prob = CSProblem(n=N, m=M, prior=prior, snr_db=SNR_DB)
    _, a, y = sample_problem(SEED, N, M, prior, prob.sigma_e2)
    if args.fuse_only:
        profile_block_quant(smi, prior, a, y)
        return
    mm = make_mmse_interp(prior)
    rd = RDModel(prior)
    controllers = {
        "lossless": FixedSchedule([np.inf] * T),
        "dp": DPSchedule(dp_allocate(prob, P, T, 2.0 * T, rd=rd, mmse_fn=mm),
                         rd, P),
        "bt": BTRateControl(prob, P, T, c_ratio=1.005, r_max=6.0,
                            mmse_fn=mm),
    }
    for name, ctrl in controllers.items():
        eng = AmpEngine(prior, EngineConfig(n_proc=P, n_iter=T),
                        EcsqTransport(), ctrl)
        a_p, y_p = eng._split(y, a)
        row = profile_call(lambda e=eng: e.dispatch_single(a_p, y_p, M, N),
                           "amp_local_")
        row["tagged_launches_per_iteration"] = row.get("tagged_launches",
                                                       0) / T
        print(json.dumps({"solve": name, "card": smi, "T": T, **row}),
              flush=True)
    profile_block_quant(smi, prior, a, y)
    del a, y
    # centralized AMP (amp_solve's engine: one shard, lossless) of the wide
    # problem
    prob_w = CSProblem(n=WIDE_N, m=WIDE_M, prior=prior, snr_db=SNR_DB)
    _, a, y = sample_problem(SEED + 2, WIDE_N, WIDE_M, prior, prob_w.sigma_e2)
    eng = AmpEngine(prior, EngineConfig(n_proc=1, n_iter=T,
                                        collect_symbols=False), ExactFusion())
    a_p, y_p = eng._split(y, a)
    row = profile_call(lambda: eng.dispatch_single(a_p, y_p, WIDE_M, WIDE_N),
                       "amp_local_")
    row["tagged_launches_per_iteration"] = row.get("tagged_launches", 0) / T
    print(json.dumps({"solve": "wide_centralized", "card": smi, "T": T,
                      "N": WIDE_N, "M": WIDE_M, **row}), flush=True)
    del a, y, a_p, y_p
    profile_het(smi)
    if not args.amp_only:
        profile_lm(smi)


if __name__ == "__main__":
    main()
