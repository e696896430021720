#!/usr/bin/env python3
"""Where the device time of one solve goes, on one NVIDIA GPU.

    python3 chip_profile.py

Runs the PyTorch/CUDA port's row-layout MP-AMP solve at the paper's size
(N=10000, M=3000, P=30, T=10, eps=0.05, 20 dB; operands already on the
card) under ``torch.profiler`` — lossless, DP-rated and BT-rated — and
prints one JSON object per solve: the number of kernels launched, the span
from the first kernel's start to the last one's end, the time the device was
busy inside it, the share of the busy time spent in the hand-written LC
kernels, and the ten heaviest kernels by name. The profiler slows the host
down, so the span is longer than an unprofiled solve's (``chip_smoke.py``
times that); the busy time and the kernel counts are not affected.

Informational: it checks nothing. Needs a CUDA device and nvcc (the kernels
are built at first use); needs no network.
"""
from __future__ import annotations

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
                                     FixedSchedule)
from repro_torch.core.rate_alloc import dp_allocate  # noqa: E402
from repro_torch.core.rate_distortion import RDModel  # noqa: E402
from repro_torch.core.state_evolution import PAPER_T, CSProblem  # noqa: E402

N, M, P, EPS, SNR_DB, SEED = 10_000, 3_000, 30, 0.05, 20.0, 1234
T = PAPER_T[EPS]


def profile_solve(eng: AmpEngine, a_p, y_p) -> dict:
    eng.dispatch_single(a_p, y_p, M, N)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.dispatch_single(a_p, y_p, M, N)
        torch.cuda.synchronize()
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
    lc = sum(v for name, v in by_name.items() if "amp_local_" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_events": len(kernels), "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "busy_share_of_span": busy / span,
            "lc_kernels_ms": lc / 1e3, "lc_share_of_busy": lc / busy,
            "top": [{"ms": v / 1e3, "name": name[:100]} for name, v in top]}


def main() -> None:
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
        print(json.dumps({"solve": name, "card": smi, "T": T,
                          **profile_solve(eng, a_p, y_p)}), flush=True)


if __name__ == "__main__":
    main()
