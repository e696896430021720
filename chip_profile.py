#!/usr/bin/env python3
"""Where the device time of one solve, or of one LM serving step, goes, on
one NVIDIA GPU.

    python3 chip_profile.py [--amp-only]

Runs under ``torch.profiler``: the PyTorch/CUDA port's row-layout MP-AMP
solve at the paper's size (N=10000, M=3000, P=30, T=10, eps=0.05, 20 dB;
operands already on the card) — lossless, DP-rated and BT-rated — and the
centralized AMP solve of ``chip_smoke.py``'s wide problem (N=20000, M=4000,
T=10: one shard of rows of 20000, K1's widest driven rows); then, unless
``--amp-only``, at ``chip_smoke.py``'s LM shapes (random init from seed
1234, prompts of 1000 tokens), one gemma3-1b decode step (B=8), one rwkv6-3b
prefill (B=4) and one rwkv6-3b decode step. It prints one JSON object per
call: the number of kernels launched, the span from the first kernel's start
to the last one's end, the time the device was busy inside it, the launches
of the call's hand-written kernels (for a solve also per iteration: K1's
band kernel and its combine, two a step; for a gemma3-1b decode step K5,
one a layer) and their share of the busy time, beside the launches the
kernels' wrappers counted (which tell whether the trace dropped events),
and the ten heaviest kernels by name. The profiler slows the host
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
from repro_torch.core.engine import (AmpEngine, BTRateControl,  # noqa: E402
                                     DPSchedule, EcsqTransport, EngineConfig,
                                     ExactFusion, FixedSchedule)
from repro_torch.core.rate_alloc import dp_allocate  # noqa: E402
from repro_torch.core.rate_distortion import RDModel  # noqa: E402
from repro_torch.core.state_evolution import PAPER_T, CSProblem  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.amp_fused import amp_fused as k1  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn as k5  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6 as k6  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

N, M, P, EPS, SNR_DB, SEED = 10_000, 3_000, 30, 0.05, 20.0, 1234
T = PAPER_T[EPS]
WIDE_N, WIDE_M = 20_000, 4_000
LM_PROMPT = 1000


def profile_call(fn, tag: str) -> dict:
    """Profile one call of ``fn`` (after a warm one); ``tag`` names the
    hand-written kernels whose share of the busy time is reported."""
    fn()                                         # warm
    torch.cuda.synchronize()
    counts = (k1.launch_counts, k5.launch_counts, k6.launch_counts)
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
    return {"device_events": len(kernels), "span_ms": span / 1e3,
            "wrapper_launches": counted,
            "busy_ms": busy / 1e3, "busy_share_of_span": busy / span,
            "kernel_tag": tag, "tagged_kernels_ms": ours / 1e3,
            "tagged_launches": sum(tag in e.name for e in kernels),
            "tagged_share_of_busy": ours / busy,
            "top": [{"ms": v / 1e3, "name": name[:100]} for name, v in top]}


def profile_lm(smi: str) -> None:
    """One gemma3-1b decode step (B=8, at position 1000 after a prefill of
    1000 tokens), one rwkv6-3b prefill (B=4, 1000 tokens) and one rwkv6-3b
    decode step."""
    with torch.inference_mode():
        for arch, batch in (("gemma3-1b", 8), ("rwkv6-3b", 4)):
            cfg = get_config(arch)
            model = get_model(cfg, seed=SEED)
            prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
                0, cfg.vocab, (batch, LM_PROMPT)), device="cuda")
            state = serve.prefill(model, prompts, LM_PROMPT + 1)
            tok = prompts[:, -1:]
            tag = "decode_attn" if cfg.family == "dense" else "wkv6_chunk"
            calls = {"decode_step": lambda: model.decode_step(tok, state,
                                                              LM_PROMPT)}
            if cfg.family == "rwkv6":
                calls = {"prefill": lambda: model(prompts, mode="prefill"),
                         **calls}
            for what, fn in calls.items():
                print(json.dumps({"lm": arch, "call": what, "batch": batch,
                                  "card": smi, **profile_call(fn, tag)}),
                      flush=True)
            del model, state
            torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--amp-only", action="store_true",
                        help="profile the AMP solves only, not LM serving")
    args = parser.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    prior = BernoulliGauss(eps=EPS)
    prob = CSProblem(n=N, m=M, prior=prior, snr_db=SNR_DB)
    mm = make_mmse_interp(prior)
    rd = RDModel(prior)
    controllers = {
        "lossless": FixedSchedule([np.inf] * T),
        "dp": DPSchedule(dp_allocate(prob, P, T, 2.0 * T, rd=rd, mmse_fn=mm),
                         rd, P),
        "bt": BTRateControl(prob, P, T, c_ratio=1.005, r_max=6.0,
                            mmse_fn=mm),
    }
    _, a, y = sample_problem(SEED, N, M, prior, prob.sigma_e2)
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
    if not args.amp_only:
        profile_lm(smi)


if __name__ == "__main__":
    main()
