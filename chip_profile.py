#!/usr/bin/env python3
"""Where the device time of one solve, or of one LM serving step, goes, on
one NVIDIA GPU.

    python3 chip_profile.py [--amp-only | --fuse-only | --lm-only
                             | --train-only] [--src DIR]

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
``--lm-only`` the LM part alone, ``--train-only`` two LM train steps alone:
``chip_smoke.py``'s gemma3-1b int8 step (8 x 4096 tokens in 4
microbatches, every layer recomputed, the 13 leaves' ``compressed_psum``
over a "pod" of one on an NCCL world of one), with its device time by
kind of kernel and the peak device memory after each part of the step
(gradients, fusion, the whole step), and rwkv6-3b's exact step as the
``train_zoo`` phase runs it (the same shape and microbatches), with K6's
backward's share of the busy time and the first step's loss, after
``rwkv_sensitivity`` (the step-1 gradient under the kernel against float64
autograd as K6's backward, beside two float32-exact controls, at two
seeds). ``--src DIR``
profiles the port under DIR instead of this checkout's ``src`` (a paired
run against another tree, whose kernels build into its own ``build/``).
It prints one JSON object per call: the number
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

# --src DIR: the port's package from another tree (a `git archive` of the
# parent under a git-ignored directory), for a paired run; read before the
# imports below, which it decides
SRC = (os.path.abspath(sys.argv[sys.argv.index("--src") + 1])
       if "--src" in sys.argv[:-1]
       else os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
sys.path.insert(0, SRC)

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
# collectives, K6's backward and K6, the matrix products (cuBLAS /
# CUTLASS), the rest
KINDS = (("k4", ("quantize",)), ("nccl", ("nccl",)),
         ("k6_backward", ("wkv6_bwd",)), ("k6", ("wkv6_chunk",)),
         ("gemm", ("gemm", "cutlass", "xmma", "sm90_", "cublas")))


def profile_train(smi: str) -> None:
    """One gemma3-1b int8 train step as ``chip_smoke.py``'s phase ``train``
    runs it (world of one, mesh (1, 1, 1), seed 1234), profiled after a
    warm step; the device time by kind (``KINDS``), and the peak device
    memory after the microbatches' gradients, after their fusion and after
    the whole step, each from a reset. Then rwkv6-3b's exact step as the
    ``train_zoo`` phase runs it (``profile_train_rwkv``)."""
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
        loss, grads = step._grads(params, tok, lab, {})
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
        step(params, opt, tok, lab, donate=True)
        torch.cuda.synchronize()
        peaks["step"] = torch.cuda.max_memory_allocated() / 1e9
        peaks["resident_params_and_state"] = torch.cuda.memory_allocated() / 1e9
        row = profile_call(lambda: step(params, opt, tok, lab, donate=True),
                           "quantize")
        print(json.dumps({"train": "gemma3-1b", "call": "int8_step",
                          "tokens": 8 * 4096, "microbatches": 4, "card": smi,
                          "src": SRC, "peak_gb": peaks, **row}), flush=True)
        del step, params, opt
        torch.cuda.empty_cache()
        profile_train_rwkv(smi, mesh)
    finally:
        dist.destroy_process_group()


def profile_train_rwkv(smi: str, mesh) -> None:
    """rwkv6-3b's exact donated step as ``chip_smoke.py``'s phase
    ``train_zoo`` (b) runs it: full width and depth, 8 x 4096 tokens in 4
    microbatches, seed 1234. Step 1 runs on batch 0 (its loss printed in
    full, the number that phase holds the change to), then one more step
    warms on batch 1 and the next is profiled on it: device busy share,
    device ms by kind, and K6's backward's (``wkv6_bwd``) share of the busy
    time with its launches."""
    cfg = get_config("rwkv6-3b")
    shape = ShapeSpec("train_4k_cut", 4096, 8, "train")
    step = build_train_step(cfg, mesh, shape, TrainStepConfig(microbatches=4))
    data = SyntheticLMData(cfg.vocab, 4096, 8, seed=SEED)
    tok0, lab0 = data.global_arrays(0, mesh)
    tok1, lab1 = data.global_arrays(1, mesh)
    print(json.dumps({"train": "rwkv6-3b", "call": "backward_sensitivity",
                      "card": smi, "src": SRC,
                      **rwkv_sensitivity(step, step.init_params, tok0,
                                         lab0)}),
          flush=True)
    params = step.init_params(SEED)
    opt = step.init_opt_state(params)
    loss1 = float(step(params, opt, tok0, lab0, donate=True)[2]["loss"])
    row = profile_call(lambda: step(params, opt, tok1, lab1, donate=True),
                       "wkv6_bwd")
    print(json.dumps({"train": "rwkv6-3b", "call": "exact_step",
                      "tokens": 8 * 4096, "microbatches": 4, "card": smi,
                      "src": SRC, "step1_loss": repr(loss1), **row}),
          flush=True)
    del step, params, opt
    torch.cuda.empty_cache()


# leaves of rwkv6-3b whose step-1 gradient rwkv_sensitivity reports: the
# decay's (reached by dlogw alone), those dr / dk reach, and two others
SENSITIVE_LEAVES = ("layers/w0", "layers/w_lora1", "layers/w_lora2",
                    "layers/wr", "layers/wk", "layers/wv", "layers/wo",
                    "layers/u", "embed/table")
# the parameters' seeds rwkv_sensitivity reads the step-1 gradient at
SENSITIVITY_SEEDS = (SEED, SEED + 1)


def _f64_grads(r, k, v, logw, u, dy):
    """dr, dk, dv, dlogw, du of y = wkv_chunked(r, k, v, logw, u) against
    dy, by autograd in float64."""
    from repro_torch.kernels.wkv6.ref import wkv_chunked
    with torch.enable_grad():
        ins = [x.detach().double().requires_grad_(True)
               for x in (r, k, v, logw, u)]
        y, _ = wkv_chunked(*ins)
        return torch.autograd.grad((y * dy.double()).sum(), ins)


def _f32_grads(r, k, v, logw, u, dy):
    """The same by autograd of ``wkv_chunked`` in float32 (the plain version
    ``chip_smoke.py`` holds the kernel to)."""
    from repro_torch.kernels.wkv6.ref import wkv_chunked
    with torch.enable_grad():
        ins = [x.detach().float().requires_grad_(True)
               for x in (r, k, v, logw, u)]
        y, _ = wkv_chunked(*ins)
        return torch.autograd.grad((y * dy.float()).sum(), ins)


def _ulp_moved(g, gen):
    """``g`` (float64) rounded to float32 and moved one float32 ulp, up or
    down at random (``gen``): a result as good as float32 can hold, with
    an error of one unit."""
    x = g.float()
    up = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
    inf = torch.full_like(x, float("inf"))
    return torch.nextafter(x, torch.where(up, inf, -inf))


def rwkv_sensitivity(step, params_of, tok, lab) -> dict:
    """How much K6's backward decides rwkv6-3b's step-1 gradient, beside
    how much the step's own rounding does. At each SENSITIVITY_SEEDS seed's
    parameters (``params_of(seed)``) on (tok, lab), the gradient with four
    backwards in WKV6Function: float64 autograd of ``wkv_chunked`` (the
    referee), the kernel, and two controls that are as right as float32
    can be: float32 autograd of ``wkv_chunked``, and the referee's results
    each moved one float32 ulp at random. dr, dk, dv round to the inputs'
    bf16 in every one, as the kernel's do; the rest of the step is the
    same. Reported: the gradient norms, and each SENSITIVE_LEAVES leaf's
    distance from the referee's (norm of the difference over the referee's
    norm). A kernel whose leaves part from the referee as far as the
    controls' do is as right as the step can tell. Then, at the inputs of
    the first and the last backward call of the first seed's kernel step
    (captured), the kernel's results, the kernel's on float32 copies of r,
    k, v (its dr, dk, dv before their bf16 rounding) and float32 autograd's
    against float64 autograd (norm of the error over the referee's), and
    the same for the
    part of the decay leaves' gradient that call gives: sum over (b, t) of
    dlogw * logw where logw > -2 (w0's, by chain rule through logw =
    -exp(min(w, ln 2)))."""
    from repro_torch.kernels.wkv6 import ops as k6_ops
    kernel = k6_ops.wkv6_bwd_cuda
    captured, calls = [], [0]

    def capture(*args, **kw):
        if calls[0] in (0, 127) and len(captured) < 2:
            captured.append([x.detach().clone() if torch.is_tensor(x) else x
                             for x in args[:8]])
        calls[0] += 1
        return kernel(*args, **kw)

    def backward_of(grads_fn):
        def bwd(r, k, v, logw, u, state0, dy, ds=None,
                need_state0_grad=False):
            g = grads_fn(r, k, v, logw, u, dy)
            return (g[0].to(r.dtype), g[1].to(r.dtype), g[2].to(r.dtype),
                    g[3].float(), g[4].float(), None)
        return bwd

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ulp = backward_of(lambda *a: [_ulp_moved(g, gen) for g in _f64_grads(*a)])
    variants = (("float64_referee", backward_of(_f64_grads)),
                ("kernel", capture),
                ("float32_autograd", backward_of(_f32_grads)),
                ("float64_referee_one_ulp", ulp))
    out = {"seeds": {}}
    for seed in SENSITIVITY_SEEDS:
        params = params_of(seed)
        row, ref = {}, None
        for name, fn in variants:
            k6_ops.wkv6_bwd_cuda = fn
            try:
                _, g = step._grads(params, tok, lab, {})
            finally:
                k6_ops.wkv6_bwd_cuda = kernel
            row[f"grad_norm_{name}"] = float(torch.sqrt(sum(
                (x.float() ** 2).sum() for x in g.values())))
            leaves = {key: g[key].float() for key in SENSITIVE_LEAVES}
            del g
            if ref is None:
                ref = leaves
            else:
                row[f"leaf_gap_of_norm_{name}"] = {
                    key: float((leaves[key] - ref[key]).norm()
                               / ref[key].norm()) for key in SENSITIVE_LEAVES}
            del leaves
            torch.cuda.empty_cache()
        out["seeds"][str(seed)] = row
        del params, ref
        torch.cuda.empty_cache()
    names = ("dr", "dk", "dv", "dlogw", "du")
    errs = []
    for r, k, v, logw, u, state0, dy, ds in captured:
        want = _f64_grads(r, k, v, logw, u, dy)
        keep = (logw > -2.0).double()
        decay = lambda dlogw: (dlogw.double() * logw.double() * keep).sum((0, 1))
        row = {}
        u32 = u.float().contiguous()
        for name, got in (
                ("kernel", kernel(r, k, v, logw, u32, state0, dy, ds)),
                ("kernel_float32_inputs", kernel(r.float(), k.float(),
                                                 v.float(), logw, u32,
                                                 state0, dy, ds)),
                ("float32_autograd", _f32_grads(r, k, v, logw, u, dy))):
            row[name] = {key: float((a.double() - b).norm() / b.norm())
                         for key, a, b in zip(names, got, want)}
            row[name]["decay_leaf_part"] = float(
                (decay(got[3]) - decay(want[3])).norm()
                / decay(want[3]).norm())
        errs.append(row)
    out["err_of_norm_at_captured_inputs"] = errs
    return out


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
                      help="profile one gemma3-1b int8 train step and one "
                           "rwkv6-3b exact train step only")
    parser.add_argument("--src", metavar="DIR",
                        help="profile the port under DIR (another tree's "
                             "src, for a paired run) instead of this one's")
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
