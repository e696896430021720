#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py [--out results.json] [--k3-parent DIR]
                          [--k6-only | --k5-only | --k4-only | --sharded-only
                           | --zoo-only | --train-only | --train-zoo-only
                           | --train-tp-only | --serve-tp-only
                           | --tp-zoo-only | --examples-only]

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
  * the solve service (``repro_torch.serving.SolveService``, phase
    ``serve``): prewarm, then a row bucket of 8 (the paper's point and
    N=9000, M=2700, T=8 beside it; lossless, fixed, DP and BT) and a column
    bucket of 4 at the wide problem in one ``solve``, a block8 pair and a
    lone lossless request; every result against the port's own single
    solve, the early exit, drift, rates, launches, no host sync in the
    heterogeneous loops; and K3 with per-instance operands on the card;
  * erasure (phase ``erasure``, 10 % of the fusion packets lost, Bernoulli
    and Gilbert bursts of 4): the row solves (lossless, fixed ECSQ, DP and
    BT planned for the link, int8 blocks) and the column solves (lossless,
    int8 blocks, under the reset), each held to its drop-free bits under
    an all-zero mask, to the port's CPU solve on the same mask, to an MSE
    above the lossless one and under 50x it, to the SE envelope, to no
    host sync and to one K4 launch an int8 iteration; and two served row
    buckets of 8 with erasure and lossless requests mixed, ECSQ and int8
    blocks (K4 with each instance's keep row), each request against its
    own single solve;
  * the cluster plane (phase ``cluster``): a ``ClusterService`` over two
    ``SolveService``s on the card against one ``SolveService`` on a stream
    of a row bucket of 8 and a column bucket of 4 with erasure requests
    (the same bits, every host serves, no program after prewarm), a host
    killed at its first flush (nothing lost, the same bits), the same
    stream through a ``TcpBackend`` to a ``BackendServer`` on loopback
    (frames of 100-300 MiB: the same bits, the submit round trip by
    layout), and ``launch/multihost.py --smoke`` (a child process behind
    a ``BackendServer`` over TCP at its toy load: the same bits);
  * multi-device solves (phase ``sharded``): (a) an NCCL world of one rank
    on the card, in this process, at the paper's row point (P=30):
    ``PsumFusion`` against the emulated lossless solve, the int8 and int4
    ``CompressedPsumTransport`` (the two-phase ``compressed_psum`` on K4a,
    K4b and K4b's summing form, the int4 symbols packed on the card), their
    launches an iteration and no host sync in the loops; (b) a world of two
    gloo ranks sharing the card (spawned; NCCL refuses two ranks on one
    GPU): the exact, ECSQ-local, straggler and compressed row solves, the
    wide column problem, the wire bytes by dtype, and ``SolveService(mesh=)``
    serving a ``"data"`` bucket of 8 and two ``"proc"`` requests at the
    paper's size, each against the local service's answer;
  * the examples' twins (phase ``examples``, ``repro_torch.examples``):
    each twin's ``run`` on the card at the reference example's sizes —
    quickstart (centralized, lossless, BT), serve_mixed (five requests in
    four buckets, both layouts), observe (spans, the drift alert, the
    metrics), wire_demo (the BT solve's rANS accounting, at its defaults
    and --smoke), mp_amp_cluster (part 1 at the paper's point, BT and DP;
    part 2 on 8 gloo ranks sharing the card: exact, int8, int4 and int8
    with 15 % stragglers) and train_lm (--scale 100m, 8 steps, a
    checkpoint every 4) — each with its wall time, its launches by kernel
    held to the counts worked out from the code, the gates this script
    holds at the paper's point, and each kernel it reached held against
    its plain version on the inputs it was given;
  * LM training (phase ``train``, after the solve phases' operands are
    freed): (a) gemma3-1b at its published width and depth through
    ``launch/steps.py::build_train_step``, train_4k's sequence of 4096 and
    a global batch of 8 in 4 microbatches, 2 steps with the gradients
    fused over "pod" by the int8 ``compressed_psum`` (K4a, K4b-sum, K4b: 52
    launches a step, asserted) and 2 exact from the same init and data,
    the donated (in-place) step the Trainer runs, on an NCCL world of one,
    the first int8 step under the sync debug mode
    "warn" (no site), the others under "error", the int8 losses from step
    2 on not the exact ones; (b) K4a, K4b-sum and K4b, int8 and packed, at
    the gradient chunks of gemma3-1b's embed/table and its 26 x 1152 x 6912
    leaves, bit for bit with their plain versions and timed, the int8
    forms' kernels-line rows with the launches (a) made at that shape; (c)
    the reference's red ``test_compressed_gradient_training_converges`` on
    two gloo ranks sharing the card, (pod=2, data=1, model=1): exact and int8
    both drop >= 0.3 in 12 steps and end within 0.5, int8 payloads over
    "pod" (int4 run beside them); (d) the ``Trainer`` preempted at step 8
    and resumed from its step-5 checkpoint == the uninterrupted run, bit
    for bit;
  * LM training of the other families (phase ``train_zoo``): (a) K6's
    backward kernel (``wkv6_bwd``) against autograd of its plain forward
    at fifteen cases (rwkv6-3b's microbatch of 2 x 4096, ragged T, a state
    in, a cotangent of the final state, float32, Dh 32 and 16, and each
    value split its plan can take), and with a NaN in dy, timed beside K6
    at that shape; (b) rwkv6-3b at its published width and depth, 8 x
    4096 tokens in 4 microbatches, 5 exact and 5 int8 donated (in-place)
    steps on an NCCL world of one: K6 256 and its backward 128 launches a
    step, K4a/K4b-sum/K4b 48/24/24 an int8 step, the loss lower after five
    steps than at the first, int8 within 1 % of exact's loss at every step,
    the exact curve the parent tree's (step 1 bit for bit, then within 1
    %), K6's backward at two of step 1's calls' inputs against float64, no
    host sync from step 2 on, peak under 80 GB; (c) the smoke configs of
    rwkv6 (K6 and its backward through ``WKV6Function``), qwen3-moe,
    mixtral, recurrentgemma, qwen2-vl (vision embeddings) and whisper
    (frames): one loss and its gradients on the card against the CPU
    (float32 weights, limits from the float32 readings; bf16 recorded;
    recurrentgemma's also by block, with and without the LM head's bf16
    cast), then 8 int8 steps whose loss falls;
  * tensor parallelism over "model" in LM training (phase ``train_tp``),
    on gloo ranks sharing the card (spawned: NCCL refuses two ranks on one
    GPU; the times are oversubscription, not scaling): (1) gemma3-1b at its
    published width and depth, 'tp' at (data=1, model=2), 4096 positions,
    3 steps against the world of one on the same rows (loss 1e-3, gradient
    norm 1e-2, the loss falling), each rank's parameter and optimizer
    bytes equal to the rules' slices, per step its peak, times and the
    collectives' bytes; (2) a float32 guard at 2 layers (loss 1e-6, every
    leaf's gradient 1e-5 of its scale); (3) (pod=2, data=1, model=2), four
    ranks, exact and int8 over "pod" at 4 layers, K4a / K4b-sum / K4b 52
    launches an int8 step on every rank, at the slices' chunks; (4)
    'tp_sp' and 'fsdp' at 2 layers against the world of one; (5) rwkv6-3b
    'tp' at full width and 2 layers, K6 and its backward at H = 20 on each
    rank, step 1's loss against the world of one, and a float32 guard at 1
    layer (the loss 1e-6, every leaf within 2 x a rounding control's gap,
    or 1e-5 of its scale); (6) K6 and its backward at
    (1, 4096, 20, 64) and K4's int8 forms at (3)'s chunks, each against
    its plain version; (7) MoE with whole experts under 'tp_sp' (qwen3-moe's
    smoke config with 3 experts of a d_ff of 129, capacity factors 1.25
    and 1.0) in float32 against the world of one: the loss 1e-6, every
    leaf 1e-5 of its scale, the same dropped slots. The int8 run is held
    to the exact one (step 1's
    gradient norm 1e-2, every loss 1 %). Every K4 and K6 row of the
    kernels line carries its launches on these paths
    (``train_tp_launches``) and its error at (6)'s shapes;
  * LM serving (``repro_torch.launch.serve.generate``) at full width and
    depth from a random init: gemma3-1b (B=8; decode attention, K5, in
    every layer of every decode step) and rwkv6-3b (B=4; the WKV6
    recurrence, K6, in every layer of prefill), prompts of 1000 tokens and
    32 greedy steps; decode held against one prefill over the same tokens
    (bf16, and float32 weights); the small config of each family on the
    card against the CPU, mixtral-8x7b's among them;
  * sharded LM serving (phase ``serve_tp``, ``build_serve_step``): gloo
    ranks sharing the card, each case against the world of one computed on
    rank 0 in the same call: (a) gemma3-1b at full width and depth on
    (data 1, model 2), B=8, prompts of 1000, 32 greedy steps teacher-forced
    on the world of one's ids, its cache of 1032 rows 516 a rank: logits at
    the bf16 serving limits, ids, K5's slice form launched on each rank
    exactly where its rows meet the window (worked out from the positions);
    (b) rwkv6-3b at full width (1, 2), float32 weights, K6 at H = 20; (c)
    gemma3-1b B=1 at (2, 2), a prompt of 16384, the cache over ("data",
    "model"), 4104 rows a rank; (d) float32 guards at 2 layers (gemma3-1b,
    qwen2-vl-7b, qwen3-moe-30b-a3b, mixtral-8x7b) within 1e-5 of scale;
    (e) K5's slice form against its plain version at (a)'s and (c)'s
    shapes and an empty slice (no launch), and timed beside SDPA on the
    same slice; (f) the dry-run's count of (a)'s rank bytes against the
    rise of ``torch.cuda.memory_allocated``;
  * the "model" axis across the zoo (phase ``tp_zoo``): gloo worlds of 4,
    8, 2 and 16 ranks sharing the card, each case against the world of one
    on rank 0: (a) recurrentgemma-2b at full width and depth on (1, 4), its
    10 heads on the head_dim fallback and its LRU columns over "model",
    B=2 x 3000 + 16 steps; (b) gemma3-1b on (1, 8), the fallback, B=2 x
    508 + 4; (c) whisper-small on (1, 2), B=8 x (1500 frames + 448), its
    self and cross caches over "kv_seq": logits at the bf16 serving limits,
    K5's slice-form launches as worked out; (d) K6's value-column form
    (rwkv6-3b's 2 x 4096 x 40 x 64 at Dv = 32, 16, 4 in bf16, and the
    16-rank path's 2 x 512 at Dv = 4 in float32) forward and backward
    against its plain versions, and rwkv6-3b at 1 layer on (1, 16) in
    float32, one train step and its serving; (e) float32 training guards
    at 2 layers (gemma3-1b 'tp' and 'tp_sp' and qwen2-vl-7b on (1, 8),
    recurrentgemma-2b on (1, 4), whisper-small on (1, 2)) within 1e-5 of
    scale; (f) K5's slice form at these shapes, checked and timed;
  * the dry run (phase ``dryrun``): four cells of
    ``repro_torch.launch.dryrun`` on meta, in a CPU subprocess from the
    build on, read after the last phase;
  * the LM zoo (phase ``lm_zoo``): every other family at its published
    width and depth, one model at a time — gemma3-1b with a prompt of
    32768 (the streaming attention; K5 over 32 800 rows), qwen3-moe-30b-a3b
    (128 experts top-8, 61 GB of bf16; decode compared on a no-drop copy,
    its float32 twin 4 layers deep), recurrentgemma-2b (RG-LRU, window
    2048 biting), qwen2-vl-7b (M-RoPE, 1024 vision-stub embeddings) and
    whisper-small (1500 frames; K5 for self- and cross-attention) — each
    with its K5 launches, no host sync in decode, times, peak memory and
    decode against prefill in bf16 and float32.

It checks the results, that the paths launched the kernels and made no host
sync inside their loops, and times the kernels against their bounds.

Prints one JSON object per phase, then the card's name and power limit,
then ``{"kernels": [...]}``, then as the last line ``{"ok": true,
"device": {...}}``. Any failed check raises, so the exit code is non-zero
and the last line is not printed. ``--out`` also writes all of it to one
JSON file. Needs a CUDA device and nvcc; needs no network. Takes about
ten minutes on an H100. ``--k3-parent DIR`` (DIR holding a parent tree's
``src/repro_torch/csrc``) also times that tree's K3 in turns with this
one's (phase ``k3_operands``). ``--k6-only`` builds the WKV6 kernel alone, holds it
against its plain version at every ``WKV_CASES`` case and times it at
rwkv6-3b's prefill shape for the plan's NV and NV = 1, 2, 4, then stops
(no other phase, no last line): the quick check of K6. ``--k5-only`` does
the same for decode attention: it builds K5 alone, holds it against its
plain version at every ``DA_CASES`` case and over calls of two plans in
turns, times it at gemma3-1b's decode shapes L2-hot and L2-cold and at
B=8, S=32768, and stops, with the card's line and the last line of a full
run. ``--k4-only`` does the same for block quantization: it builds
``quantize.cu`` alone, holds the standalone quantizer and its inverse and
the fused block-quantized fusion against their plain versions (every
``FUSE_CASES`` case, and its erasure form at ``FUSE_MASK_CASES``), times them at the transports' shapes beside the
fusion composed of the standalone kernels and an empty launch, and stops,
with the card's line and the last line. ``--sharded-only`` builds every
kernel, holds the wire forms against their plain versions, runs the
``sharded`` phase and times the wire forms, and stops the same way.
``--zoo-only`` builds the decode-attention kernel, holds it against its
plain version at every ``DA_CASES`` case and every shape of the zoo's
decode paths, runs ``lm_zoo`` and stops the same way. ``--train-only``
builds ``quantize.cu``, holds the wire forms against their plain versions,
runs the ``train`` phase and stops with its kernels rows, the card's line
and the last line. ``--train-zoo-only`` builds the WKV6 and block-quantize
kernels, runs the ``train_zoo`` phase and stops the same way;
``--train-tp-only`` builds the same two, runs the ``train_tp`` phase and
stops with the card's line and the last line. ``--serve-tp-only`` builds
the decode-attention and WKV6 kernels, runs the ``serve_tp`` phase and
stops with its kernels rows, the card's line and the last line;
``--tp-zoo-only`` builds the same two, runs the ``tp_zoo`` phase (the
"model" axis across the zoo: the head_dim fallback, recurrentgemma and
whisper over "model", K6's value-column form; worlds of 4, 8, 2 and 16
gloo ranks sharing the card) and stops the same way. ``--examples-only``
builds the AMP and block-quantize kernels, runs the ``examples`` phase and
stops with the card's line and the last line.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import math
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
                                     BTRateControl, ColDPSchedule,
                                     ColumnBTRateControl, ColumnPartition,
                                     CompressedPsumTransport,
                                     DPSchedule, EcsqTransport, EngineConfig,
                                     ErasureSpec, ExactFusion, FixedSchedule,
                                     PsumFusion, bt_delta_for,
                                     col_bt_delta_for, split_problem)
from repro_torch.core.mp_amp import MPAMPConfig, mp_amp_solve  # noqa: E402
from repro_torch.core.rate_alloc import (BTController, dp_allocate,  # noqa: E402
                                         dp_allocate_col)
from repro_torch.core.rate_distortion import RDModel  # noqa: E402
from repro_torch.core.state_evolution import (PAPER_T, CSProblem,  # noqa: E402
                                              se_trajectory,
                                              se_trajectory_col,
                                              se_trajectory_erasure,
                                              se_trajectory_quantized)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import launch_counts as all_counts  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    reset_launch_counts as reset_all_counts)
from repro_torch.kernels.amp_fused.check import (  # noqa: E402
    captured_inputs, check_captured)
from repro_torch.kernels.amp_fused import amp_fused as k  # noqa: E402
from repro_torch.kernels.amp_fused import col as kc  # noqa: E402
from repro_torch.kernels.amp_fused import ref  # noqa: E402
from repro_torch.kernels.quantize import ops as qops  # noqa: E402
from repro_torch.kernels.quantize import quantize as kq  # noqa: E402
from repro_torch.kernels.quantize.ref import block_quant_fuse_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attn import decode_attn as kd  # noqa: E402
from repro_torch.kernels.decode_attn import ops as kd_ops  # noqa: E402
from repro_torch.kernels.decode_attn.ref import (decode_attn_ref,  # noqa: E402
                                                 decode_attn_slice_ref,
                                                 slice_rows, valid_rows)
from repro_torch.kernels.wkv6 import ops as k6_ops  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6 as kw  # noqa: E402
from repro_torch.kernels.wkv6.ref import CHUNK, wkv_chunked  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.core.collectives import psum  # noqa: E402
from repro_torch.launch.mesh import (GridMesh, Mesh,  # noqa: E402
                                     init_cluster, make_host_mesh,
                                     make_mesh, make_serve_mesh,
                                     spawn_world)
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch.steps import (TrainStepConfig,  # noqa: E402
                                      build_serve_step, build_train_step)
from repro_torch.launch.dryrun import (serve_argument_bytes,  # noqa: E402
                                       train_argument_bytes)
from repro_torch.core.collectives import broadcast_object  # noqa: E402
from repro_torch.models.layers import init_from_schema  # noqa: E402
from repro_torch.models.model_api import schema_for  # noqa: E402
from repro_torch.sharding import flat_tree  # noqa: E402
from repro_torch.launch.steps import loss_fn as train_loss_fn  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.models import get_model, moe as lm_moe  # noqa: E402
from repro_torch.serving import (BackendServer,  # noqa: E402
                                 BucketPolicy, ChaosBackend,
                                 ClusterService, FaultPlan, FaultSpec,
                                 LocalBackend,
                                 PrewarmSpec, RouterPolicy, SolveRequest,
                                 SolveService, TcpBackend, encode_request)

DEV = torch.device("cuda:0")
SOURCES = {"amp_local": "src/repro_torch/csrc/amp_local.cu",
           "amp_local_two_pass": "src/repro_torch/csrc/amp_local.cu",
           "col_residual": "src/repro_torch/csrc/amp_col.cu",
           "col_inner": "src/repro_torch/csrc/amp_col.cu",
           "quantize_blocks": "src/repro_torch/csrc/quantize.cu",
           "dequantize_blocks": "src/repro_torch/csrc/quantize.cu",
           "block_quant_fuse": "src/repro_torch/csrc/quantize.cu",
           "quantize_blocks_packed": "src/repro_torch/csrc/quantize.cu",
           "dequantize_blocks_packed": "src/repro_torch/csrc/quantize.cu",
           "dequantize_sum": "src/repro_torch/csrc/quantize.cu",
           "dequantize_sum_packed": "src/repro_torch/csrc/quantize.cu",
           "decode_attn": "src/repro_torch/csrc/decode_attn.cu",
           "decode_attn_slice": "src/repro_torch/csrc/decode_attn.cu",
           "wkv6": "src/repro_torch/csrc/wkv6.cu",
           "wkv6_bwd": "src/repro_torch/csrc/wkv6.cu"}
K1_SITES = ("src/repro/kernels/amp_fused/amp_fused.py:102, "
            "src/repro/kernels/amp_fused/amp_fused.py:123")
REPLACES = {"amp_local": K1_SITES,
            "amp_local_two_pass": K1_SITES,
            "col_residual": "src/repro/kernels/amp_fused/col.py:67",
            "col_inner": "src/repro/kernels/amp_fused/col.py:175",
            "quantize_blocks": "src/repro/kernels/quantize/quantize.py:44",
            "dequantize_blocks": "src/repro/kernels/quantize/quantize.py:72",
            "block_quant_fuse": ("src/repro/kernels/quantize/quantize.py:44, "
                                 "src/repro/kernels/quantize/quantize.py:72"),
            "quantize_blocks_packed": "src/repro/kernels/quantize/quantize.py:44",
            "dequantize_blocks_packed":
                "src/repro/kernels/quantize/quantize.py:72",
            "dequantize_sum": "src/repro/kernels/quantize/quantize.py:72",
            "dequantize_sum_packed": "src/repro/kernels/quantize/quantize.py:72",
            "decode_attn": "src/repro/kernels/decode_attn/decode_attn.py:85",
            "decode_attn_slice":
                "src/repro/kernels/decode_attn/decode_attn.py:85",
            "wkv6": "src/repro/kernels/wkv6/wkv6.py:80",
            # no TPU kernel: the reference takes jax.grad of its jnp
            # wkv_chunked
            "wkv6_bwd": "src/repro/models/rwkv6.py:102"}
# kernels that no driven path launches any more, checked and timed all the
# same: K1's two passes (rows past 131072) and the standalone quantizer and
# its inverse (the transport runs the fused kernel)
UNDRIVEN = ("amp_local_two_pass",)

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
FUSE_RTOL = 1e-6        # the fused quantizer: its extra against the plain
                        # version's (the same sums in the same order), and
                        # its f against the fusion composed of the standalone
                        # kernels and torch.sum (P float32 terms an element
                        # in another order), relative to max |f| of the entry
FUSE_EXTRA_CHAIN_RTOL = 1e-4  # extra against that composition's torch.mean:
                        # up to 70 x 20 positive squares summed in another
                        # order, n * 2^-24 = 8.3e-5 at worst
SEED = 1234

# LM serving (random init from SEED, full width and depth): gemma3-1b, B=8
# (26 layers: K5 26 times a decode step), and rwkv6-3b, B=4 (32 layers: K6
# once a layer in prefill); prompts of 1000 tokens, 32 greedy steps, so the
# cache holds 1032 rows (ragged against K5's stages of 32 rows and the TPU's 512)
# and pos > 512, where gemma3's window of 512 bites.
LM_DENSE, LM_DENSE_BATCH = "gemma3-1b", 8
LM_RWKV, LM_RWKV_BATCH = "rwkv6-3b", 4
LM_PROMPT, LM_GEN = 1000, 32
# The LM zoo (phase lm_zoo): every other family at its published width,
# random init from SEED, 32 greedy steps through serve.generate; (arch,
# batch, prompt). gemma3-1b's prompt of 32768 takes the streaming attention
# and puts K5 on its long-cache case; recurrentgemma's 3000 make its window
# of 2048 bite; qwen2-vl's 2048 are 1024 vision-stub embeddings and 1024 text
# tokens; whisper-small decodes 448 tokens against 1500 frames.
LM_ZOO = [("gemma3-1b", 1, 32768), ("qwen3-moe-30b-a3b", 8, 1000),
          ("recurrentgemma-2b", 4, 3000), ("qwen2-vl-7b", 4, 2048),
          ("whisper-small", 8, 448)]
# qwen3-moe's float32 twin at its full depth would need 122 GB: 4 layers of
# the full width instead
LM_F32_LAYERS = {"moe": 4}
# the models whose decode is held to their prefill in bf16 at full depth;
# the others' bf16 pair is recorded, as their random init amplifies bf16
# rounding through depth: rwkv6-3b (13 % of the logits' scale), qwen2-vl-7b
# (3.6-4.0 %, argmax 90-94 % the same, at 28 layers of d 3584, where
# float32 gives 1.4e-5; both on an H100 80GB HBM3 at 700 W, lm_rwkv6 and
# lm_zoo), and qwen3-moe, whose router's near ties let a bf16 difference
# pick another expert. Every model is held in float32.
LM_BF16_HELD = ("gemma3-1b", "recurrentgemma-2b", "whisper-small")
# qwen2-vl-7b in bf16 is held at LM_BF16_CUT layers of its weights instead,
# and its gap recorded at every depth of LM_BF16_LADDER and with 1-D
# positions at full depth: a gap that grows with depth alike with and
# without M-RoPE is rounding carried through the layers, not the decode path
LM_BF16_CUT = {"qwen2-vl-7b": 7}
LM_BF16_LADDER = (1, 2, 4, 7, 14)
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

# The serve phase: SolveService at the paper's width. One row bucket of 8
# (the paper's point and N=9000, M=2700, T=8 beside it, in one bucket of
# n_pad 10240, mp_pad 112, T_max 12 under these quanta), one column bucket
# of 4 at the wide problem, a block8 pair and a lone lossless request.
SERVE_POLICY = BucketPolicy(max_batch=BATCH, n_quantum=2048, mp_quantum=112,
                            t_quantum=6)
# (n, m, T, eps, snr_db, policy)
SERVE_ROW = [(N, M, T, 0.05, 20.0, "lossless"), (9000, 2700, 8, 0.10, 15.0, "lossless"),
             (N, M, T, 0.10, 20.0, "fixed"), (9000, 2700, 8, 0.05, 20.0, "fixed"),
             (N, M, T, 0.05, 20.0, "dp"), (9000, 2700, 8, 0.10, 20.0, "dp"),
             (N, M, T, 0.10, 15.0, "bt"), (9000, 2700, 8, 0.05, 20.0, "bt")]
SERVE_COL = [(WIDE_N, WIDE_M, T, 0.05, 20.0, "lossless"),
             (WIDE_N, WIDE_M, T, 0.02, 20.0, "lossless"),
             (WIDE_N, WIDE_M, T, 0.05, 20.0, "bt"),
             (WIDE_N, WIDE_M, T, 0.02, 15.0, "bt")]
SERVE_CACHE_BYTES = 4 << 30     # every A slice of both buckets stays resident
SERVE_RTOL = 1e-4               # batched vs single: sigma2_hat and bins
SERVE_MSE = 1e-5                # batched vs single: mean (x_b - x_1)^2
# K3 with per-instance operands: B instances of the paper's column shape,
# each with its own [m_eff, eps, mu_s, sigma_s^2] and real columns
K3_PAR = [(3000.0, 0.05, 0.0, 1.0), (2800.0, 0.10, 0.1, 0.5),
          (2600.0, 0.02, -0.2, 2.0), (3000.0, 0.20, 0.0, 1.0)]
K3_NREAL = [400, 384, 250, 17]

# Erasure (the lossy link, phase ``erasure``): 10 % of the fusion packets
# lost, i.i.d. or in Gilbert-Elliott bursts of mean 4 rounds, masks drawn
# from SEED. Each masked solve on the card equals the port's CPU solve on
# the same mask (plain versions; tests/test_torch_erasure.py ties those to
# the JAX reference): a lossless one to ERASURE_CPU_DX in x and
# ERASURE_CPU_DS in sigma2_hat (the ``reference`` phase's limits), a
# quantized one by assert_traces_agree's rule (``_traces_agree``). MSE
# stays finite, above the lossless solve's and under 50x it (the
# reference's own bound, tests/test_erasure.py). The realised plug-in
# sigma2_hat stays within [1/2, 2] of the SE recursion of
# se_trajectory_erasure (row) / se_trajectory_col (column, its reset) run
# on the run's own mask: each round's survivors in place of the configured
# rate's expectation (``se_on_mask``). The SE at the configured rate is
# recorded beside it: it averages over masks, and a single realisation of
# 25-30 packets a round (a burst, or a round of 6 losses) leaves it by up
# to 3x in the column layout, where a reset costs a whole block's MSE.
ERASURE_RATE, ERASURE_BURST = 0.1, 4.0
ERASURE_MODELS = ("bernoulli", "gilbert")
ERASURE_MSE_MAX = 50.0
ERASURE_ENVELOPE = (0.5, 2.0)
ERASURE_CPU_DX, ERASURE_CPU_DS = 1e-4, 1e-3
# the served bucket of 8 with erasure and lossless requests mixed:
# (n, m, T, eps, snr_db, policy, erasure_rate, erasure_model)
ERASURE_SERVE = [(N, M, T, 0.05, 20.0, "lossless", 0.0, "bernoulli"),
                 (N, M, T, 0.05, 20.0, "lossless", ERASURE_RATE, "bernoulli"),
                 (9000, 2700, 8, 0.10, 15.0, "lossless", ERASURE_RATE,
                  "gilbert"),
                 (N, M, T, 0.10, 20.0, "fixed", 0.0, "bernoulli"),
                 (N, M, T, 0.10, 20.0, "fixed", ERASURE_RATE, "bernoulli"),
                 (9000, 2700, 8, 0.05, 20.0, "fixed", ERASURE_RATE, "gilbert"),
                 (N, M, T, 0.05, 20.0, "dp", ERASURE_RATE, "bernoulli"),
                 (9000, 2700, 8, 0.10, 15.0, "lossless", 0.0, "bernoulli")]
# the cluster phase's column requests (the wide problem, P=20)
CLUSTER_COL = [(WIDE_N, WIDE_M, T, 0.05, 20.0, "lossless", 0.0, "bernoulli"),
               (WIDE_N, WIDE_M, T, 0.02, 20.0, "lossless", ERASURE_RATE,
                "bernoulli"),
               (WIDE_N, WIDE_M, T, 0.05, 15.0, "lossless", ERASURE_RATE,
                "gilbert"),
               (WIDE_N, WIDE_M, T, 0.02, 20.0, "fixed", 0.0, "bernoulli")]

RESULT: dict = {}


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
            par = ref.col_params(float(m), *PRIOR_SCALARS, device=DEV)
            for upd in (False, True):
                args = (a, x, x0, z, g, mask, par, upd)
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
    x[1:2] *= 1e4
    x[2:3] *= 1e-3
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


# compressed_psum's chunks: the paper's row message (N = 10000, padded to a
# multiple of D * 512 * 2) over D = 2 ranks (two chunks of 5120) and a world
# of 1 (one of 10240), the wide column problem's (M = 4000 -> 4096: two of
# 2048), and ragged rows (odd length: the packed forms' tail, scalar loads)
WIRE_CASES = [("row_D2", 2, 5120), ("row_D1", 1, 10240), ("col_D2", 2, 2048),
              ("ragged", 7, 1001), ("D4", 4, 3072)]


def check_wire_kernels(cases=WIRE_CASES, phase="kernel_check_wire") -> dict:
    """The forms of ``compressed_psum``'s wire against their plain versions,
    bit for bit, at each (name, R, N) of ``cases``: K4a int8 ==
    ``quantize_ref`` and K4b int8 == ``dequantize_ref``; K4a packed (int4
    symbols two a byte) == ``quantize_ref`` then ``pack_int4``; K4b packed
    == ``unpack_int4`` then ``dequantize_ref``; K4b's sum over rows (int8
    and packed) == ``dequantize_ref(...)`` summed in row order. Scales bit
    for bit too."""
    rows = []
    for name, r, n in cases:
        x = quant_inputs(r, n, SEED + 3)
        for block in (512, 256):
            pk, sk = kq.quantize_cuda(x, 7, block, packed=True)
            dk = kq.dequantize_cuda(pk, sk, block, packed=True, n=n)
            q8, s8 = kq.quantize_cuda(x, 127, block)
            d8 = kq.dequantize_cuda(q8, s8, block)
            sum8 = kq.dequantize_sum_cuda(q8, s8, block)
            sum4 = kq.dequantize_sum_cuda(pk, sk, block, packed=True, c=n)
            torch.cuda.synchronize()
            pr, sr = qops.quantize_plain(x, 7, block, packed=True)
            dr = qops.dequantize_plain(pr, sr, block, packed=True, n=n)
            q8r, s8r = qops.quantize_plain(x, 127, block)
            d8r = qops.dequantize_plain(q8r, s8r, block)
            sum8r = qops.dequantize_sum_plain(q8r, s8r, block)
            sum4r = qops.dequantize_sum_plain(pr, sr, block, packed=True, c=n)
            row = {"shape": name, "R": r, "N": n, "block": block,
                   "int8_q_identical": bool(torch.equal(q8, q8r)),
                   "int8_scale_bits_identical": bool(torch.equal(
                       s8.view(torch.int16), s8r.view(torch.int16))),
                   "int8_dequantized_identical": bool(torch.equal(d8, d8r)),
                   "packed_identical": bool(torch.equal(pk, pr)),
                   "packed_scale_bits_identical": bool(torch.equal(
                       sk.view(torch.int16), sr.view(torch.int16))),
                   "unpacked_dequantized_identical": bool(torch.equal(dk, dr)),
                   "sum_int8_identical": bool(torch.equal(sum8, sum8r)),
                   "sum_packed_identical": bool(torch.equal(sum4, sum4r)),
                   "max_abs_err": max(float((q8.int() - q8r.int()).abs()
                                            .max()),
                                      float((d8 - d8r).abs().max()),
                                      float((dk - dr).abs().max()),
                                      float((sum8 - sum8r).abs().max()),
                                      float((sum4 - sum4r).abs().max()))}
            rows.append(row)
            assert pk.shape == (r, (n + 1) // 2) and pk.dtype == torch.uint8
            assert q8.shape == (r, n) and d8.shape == (r, n)
            assert sum8.shape == (n,), sum8.shape
            assert all(v for key, v in row.items()
                       if key.endswith("identical")), row
    emit(phase, limit="bit-identical", cases=rows)
    return {(r["shape"], r["block"]): r for r in rows}


FUSE_CASES = [("row_messages", 1, P, N), ("col_contributions", 1, P_COL, M),
              ("batch4", 4, P, N), ("ragged", 2, 7, 1001),
              ("P33", 1, 33, N), ("P70", 1, 70, M)]


def fuse_inputs(b, p, n, seed):
    """(B, P, L) messages: ``quant_inputs`` rows, so entry 0 holds an
    all-zero, a large and a small message."""
    return quant_inputs(b * p, n, seed).reshape(b, p, n)


def chain_fuse(x, qmax, block):
    """The block-quantized fusion composed of the standalone kernels and
    PyTorch ops (quantize, dequantize, torch.sum over P, the noise
    variance's mean, the symbols cast to float32): what the fused kernel
    replaces on the transport's path."""
    b, p, n = x.shape
    q, scale = kq.quantize_cuda(x.reshape(-1, n), qmax, block)
    f = torch.sum(kq.dequantize_cuda(q, scale, block).reshape(x.shape), dim=-2)
    d = scale.reshape(b, p, -1).to(torch.float32)
    extra = torch.mean(d * d, dim=(1, 2)) / 12.0 * p
    return f, extra, q.reshape(x.shape).to(torch.float32)


def check_block_quant_fuse() -> dict:
    """The fused kernel against ``block_quant_fuse_ref`` at every
    FUSE_CASES case, qmax 127 and 7, blocks 512 and 256, symbols on and
    off: f and the symbols bit-identical, extra within FUSE_RTOL, the same
    bits over two calls; against ``chain_fuse``; and at the row shape with
    clusters of 1, 2 and 8 blocks in place of the plan's."""
    rows = []
    for name, b, p, n in FUSE_CASES:
        x = fuse_inputs(b, p, n, SEED)
        for qmax in (127, 7):
            for block in (512, 256):
                f_r, e_r, s_r = block_quant_fuse_ref(x, qmax, block)
                f_c, e_c, s_c = chain_fuse(x, qmax, block)
                scale = f_r.abs().amax(dim=-1).clamp_min(1e-30)
                for symbols in (True, False):
                    f1, e1, s1 = kq.block_quant_fuse_cuda(x, qmax, block,
                                                          symbols)
                    f2, e2, s2 = kq.block_quant_fuse_cuda(x, qmax, block,
                                                          symbols)
                    torch.cuda.synchronize()
                    rel = lambda got, want: float(
                        ((got - want).abs() / want.abs().clamp_min(1e-38))
                        .max())
                    row = {"case": name, "B": b, "P": p, "L": n,
                           "qmax": qmax, "block": block, "symbols": symbols,
                           "f_identical": bool(torch.equal(f1, f_r)),
                           "symbols_identical": bool(
                               torch.equal(s1, s_r) and torch.equal(s1, s_c)
                               if symbols else s1 is None and s2 is None),
                           "extra_identical": bool(torch.equal(e1, e_r)),
                           "extra_rel_err": rel(e1, e_r),
                           "repeat_identical": bool(
                               torch.equal(f1, f2) and torch.equal(e1, e2)
                               and (not symbols or torch.equal(s1, s2))),
                           "f_max_abs_err": float((f1 - f_r).abs().max()),
                           "chain_f_rel_err": float(
                               ((f1 - f_c).abs().amax(dim=-1) / scale).max()),
                           "chain_extra_rel_err": rel(e1, e_c)}
                    rows.append(row)
                    assert f1.shape == (b, n) and e1.shape == (b,), row
                    assert bool(torch.isfinite(f1).all()), row
                    assert all(row[key] for key in (
                        "f_identical", "symbols_identical",
                        "repeat_identical")), row
                    assert row["extra_rel_err"] <= FUSE_RTOL, row
                    assert row["chain_f_rel_err"] <= FUSE_RTOL, row
                    assert row["chain_extra_rel_err"] <= \
                        FUSE_EXTRA_CHAIN_RTOL, row
                    del f1, e1, s1, f2, e2, s2
        del x
    # the plan's clusters (4 blocks at block 512) against forced ones: the
    # same bits whatever the split of a scale block over a cluster
    x = fuse_inputs(1, P, N, SEED)
    want = block_quant_fuse_ref(x, 127, 512)
    same_any_cluster = {}
    for cluster in (1, 2, 8):
        got = kq.block_quant_fuse_cuda(x, 127, 512, cluster=cluster)
        same_any_cluster[cluster] = all(
            bool(torch.equal(g, w)) for g, w in zip(got, want))
    assert all(same_any_cluster.values()), same_any_cluster
    mask_rows = check_block_quant_fuse_masks()
    emit("kernel_check_block_quant_fuse", limit="f and symbols "
         "bit-identical, repeat bit-identical", extra_rtol=FUSE_RTOL,
         chain_f_rtol=FUSE_RTOL, chain_extra_rtol=FUSE_EXTRA_CHAIN_RTOL,
         row_shape_identical_with_cluster=same_any_cluster, cases=rows,
         erasure_limit="f, symbols and extra bit-identical to the plain "
         "version; every flag 1 == the drop-free launch",
         erasure_cases=mask_rows)
    out = {(r["case"], r["qmax"], r["block"], r["symbols"]): r for r in rows}
    out.update({("keep", r["case"], r["mask"]): r for r in mask_rows})
    return out


# (case, B, P, L): the row and column messages, and a batch of 4 row
# messages for the per-instance (B, P) keep rows
FUSE_MASK_CASES = [("row_messages", 1, P, N), ("col_contributions", 1, P_COL, M),
                   ("batch4", 4, P, N)]


def fuse_keep_rows(b, p, seed) -> dict:
    """The keep rows of the erasure form, float32 on the card: a random
    row shared by every batch entry ((P,), stride 0) and one per entry
    ((B, P)), one survivor, none, and all (which must give the drop-free
    launch's bits)."""
    g = np.random.default_rng(seed)
    one = np.zeros(p, np.float32)
    one[p // 2] = 1.0
    rows = {"random_shared": (g.random(p) >= ERASURE_RATE * 2),
            "random_per_instance": (g.random((b, p)) >= ERASURE_RATE * 2),
            "one_survivor": one, "none": np.zeros(p), "all": np.ones(p)}
    return {name: torch.as_tensor(np.asarray(v, np.float32), device=DEV)
            for name, v in rows.items()}


def check_block_quant_fuse_masks() -> list:
    """K4's erasure form against ``block_quant_fuse_ref(keep=)`` at the
    row (30, 10000) and column (25, 3000) messages and a batch of 4 row
    messages, qmax 127, block 512: f, symbols and extra bit-identical, the
    same bits over two calls, and an all-survivor row equal to the
    drop-free launch bit for bit."""
    rows = []
    for name, b, p, n in FUSE_MASK_CASES:
        x = fuse_inputs(b, p, n, SEED + 7)
        plain = kq.block_quant_fuse_cuda(x, 127, 512)
        for mask, keep in fuse_keep_rows(b, p, SEED + 8).items():
            got = kq.block_quant_fuse_cuda(x, 127, 512, keep=keep)
            again = kq.block_quant_fuse_cuda(x, 127, 512, keep=keep)
            want = block_quant_fuse_ref(x, 127, 512, keep=keep)
            torch.cuda.synchronize()
            row = {"case": name, "B": b, "P": p, "L": n, "mask": mask,
                   "survivors": [int(v) for v in
                                 keep.reshape(-1, p).sum(-1).tolist()],
                   "identical": all(bool(torch.equal(g_, w))
                                    for g_, w in zip(got, want)),
                   "repeat_identical": all(bool(torch.equal(g_, a_))
                                           for g_, a_ in zip(got, again)),
                   "f_max_abs_err": float((got[0] - want[0]).abs().max()),
                   "extra": [float(v) for v in got[1].tolist()]}
            if mask == "all":
                row["drop_free_identical"] = all(
                    bool(torch.equal(g_, d)) for g_, d in zip(got, plain))
                assert row["drop_free_identical"], row
            rows.append(row)
            assert bool(torch.isfinite(got[0]).all()), row
            assert row["identical"] and row["repeat_identical"], row
            del got, again, want
        del x, plain
    return rows


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
            want.update(block_quant_fuse=T)    # one fusion a round
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
            "block_quant_fuse": 2 * T, "quantize_blocks": 0,
            "dequantize_blocks": 0}
    assert {key: launches[key] for key in want} == want, launches
    emit("block_quant_row", P=P, mse_ratio_to_lossless=ratio,
         limits={"int8": 1.3},
         sdr_db={f"int{bits}": sdr_db(prior, float(tr.mse(s0)[-1]))
                 for bits, tr in runs.items()})
    return {"launches": launches}



def check_k3_per_instance() -> dict:
    """K3 with a (B, 4) ``par`` and (B, Np) masks, distinct per instance,
    at the paper's column shape (B=4, ragged real columns), both
    ``update_z``: against its plain version, the same bits over two calls,
    and under a batch of one the (4,) and (1, 4) forms the same bits."""
    b, p, m, np_ = len(K3_PAR), P_COL, M, N // P_COL
    a, x, x0, z, g = col_inputs(b, False, p, m, np_, torch.float32, SEED + 7)
    par = torch.tensor(K3_PAR, dtype=torch.float32, device=DEV)
    mask = (torch.arange(np_, device=DEV)[None, :]
            < torch.tensor(K3_NREAL, device=DEV)[:, None]).float()
    rows = {}
    for upd in (False, True):
        args = (a, x, x0, z, g, mask, par, upd)
        got = kc.col_inner_cuda(*args)
        again = kc.col_inner_cuda(*args)
        want = ref.col_inner_step_ref(*args)
        torch.cuda.synchronize()
        one = [v[:1] for v in (a, x, x0, z, g)]
        shared = kc.col_inner_cuda(*one, mask[0], par[0], upd)
        per = kc.col_inner_cuda(*one, mask[:1], par[:1], upd)
        torch.cuda.synchronize()
        tag = "upd" if upd else "final"
        row = {"x_rel_err": rel_err(got[0], want[0]),
               "c_rel_err": rel_err(got[1], want[1]),
               "x_max_abs_err": float((got[0] - want[0]).abs().max()),
               "bit_identical": all(bool(torch.equal(u, v))
                                    for u, v in zip(got, again)),
               "b1_shared_equals_per_instance": all(
                   bool(torch.equal(u, v)) for u, v in zip(shared, per)),
               "masked_columns_zero": bool(
                   (got[0][3, :, K3_NREAL[3]:] == 0).all())}
        if upd:
            row["z_rel_err"] = rel_err(got[2], want[2])
        rows[tag] = row
        for key in [key for key in row if "rel_err" in key]:
            assert row[key] <= KERNEL_RTOL, (tag, row)
        assert row["bit_identical"] and row["b1_shared_equals_per_instance"], row
        assert row["masked_columns_zero"], row
    emit("kernel_check_k3_per_instance", B=b, P=p, M=m, Np=np_, par=K3_PAR,
         n_real=K3_NREAL, rtol=KERNEL_RTOL, cases=rows)
    return rows


def _parent_k3(parent: str):
    """The parent tree's K3, its prior taken as host numbers: ``amp_col.cu``
    of ``parent`` built beside this tree's (one nvcc) and a call of its
    ``col_inner_launch`` as the parent's wrapper made it."""
    import ctypes
    import math
    src = os.path.join(parent, "src", "repro_torch", "csrc", "amp_col.cu")
    out = build.build_dir() / "libamp_col_parent.so"
    build.build_dir().mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, capture_output=True, text=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    vp, ci, ll, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
    lib.col_inner_launch.argtypes = [
        vp, ci, ll, vp, vp, vp, vp, vp, cf, cf, cf, cf, vp, vp, vp, vp,
        vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
    lib.col_inner_launch.restype = ci

    def call(a, x, x0, z, g, m_eff, eps, mu_s, sigma_s2, upd):
        p, m, np_ = a.shape
        chunk = kc.row_chunk(DEV, p, m, np_, a.dtype)
        n_chunks = -(-m // chunk)
        fpart = torch.empty((p, n_chunks, np_), device=DEV)
        sspart = torch.empty((p, n_chunks), device=DEV)
        x_new, c_p = torch.empty_like(x), torch.empty(p, device=DEV)
        z_new = torch.empty_like(z) if upd else z
        vec = k._vec_flag(np_, a, x0, x_new)
        plan = kc._ring_plan(DEV, 1, p, m, np_, a.dtype, vec)
        code = lib.col_inner_launch(
            a.data_ptr(), 0, 0, x.data_ptr(), x0.data_ptr(), z.data_ptr(),
            g.data_ptr(), None, m_eff, math.log(eps) - math.log1p(-eps),
            mu_s, sigma_s2, fpart.data_ptr(), sspart.data_ptr(),
            x_new.data_ptr(), c_p.data_ptr(), z_new.data_ptr(), 1, p, m, np_,
            chunk, k.Z_WARPS, int(upd), vec, *plan,
            torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return x_new, c_p, z_new
    return call


def time_k3_operands(parent: str | None) -> dict:
    """K3 at the paper's column shape (P=25, M=3000, Np=400, float32) with
    its operands on the card (``par``), in turns with the parent's K3 with
    host-number operands when ``parent`` names the parent's tree (parent,
    change, change, parent; the parent's bits checked equal first)."""
    p, m, np_ = P_COL, M, N // P_COL
    a, x, x0, z, g = col_inputs(None, False, p, m, np_, torch.float32, SEED)
    par = ref.col_params(float(m), *PRIOR_SCALARS, device=DEV)
    new = {upd: (lambda u=upd: kc.col_inner_cuda(a, x, x0, z, g, None, par, u))
           for upd in (False, True)}
    out = {"shape": {"P": p, "M": m, "Np": np_, "a_dtype": "float32"}}
    if parent is None:
        for upd in (False, True):
            out[f"after_ms_update_z_{upd}"] = time_ms(new[upd])["ms"]
        out["before_ms"] = "not measured (pass --k3-parent)"
        return out
    old_fn = _parent_k3(parent)
    old = {upd: (lambda u=upd: old_fn(a, x, x0, z, g, float(m), *PRIOR_SCALARS, u))
           for upd in (False, True)}
    for upd in (False, True):
        xo, co, _ = old[upd]()
        xn, cn, _ = new[upd]()
        torch.cuda.synchronize()
        out[f"max_abs_dx_vs_parent_update_z_{upd}"] = float((xo - xn).abs().max())
        assert rel_err(xn, xo) <= KERNEL_RTOL and rel_err(cn, co) <= KERNEL_RTOL
        runs = [time_ms(f)["ms"] for f in (old[upd], new[upd], new[upd], old[upd])]
        out[f"before_ms_update_z_{upd}"] = [runs[0], runs[3]]
        out[f"after_ms_update_z_{upd}"] = [runs[1], runs[2]]
        out[f"after_over_before_update_z_{upd}"] = \
            (runs[1] + runs[2]) / (runs[0] + runs[3])
    return out


def _draw_problem(rng, n, m, eps, snr):
    """(prior, prob, s0, A, y) of one served request, drawn with numpy."""
    prior = BernoulliGauss(eps)
    prob = CSProblem(n=n, m=m, prior=prior, snr_db=snr)
    s0 = np.where(rng.random(n) < eps, rng.standard_normal(n),
                  0.0).astype(np.float32)
    a = rng.standard_normal((m, n), dtype=np.float32) / np.float32(m ** 0.5)
    y = (a @ s0 + np.float32(prob.sigma_e2 ** 0.5)
         * rng.standard_normal(m, dtype=np.float32)).astype(np.float32)
    return prior, prob, s0, a, y


def _serve_requests(rng, specs, p, prior_cache, tag):
    """SolveRequests of the serve phase, drawn with numpy, with their
    ground truth: fixed and DP bins from the DP allocation (fixed: 3 bits
    an iteration, DP: 2), so that the single solves take the same bins."""
    reqs, s0s = [], []
    for i, (n, m, t, eps, snr, policy) in enumerate(specs):
        prior, prob, s0, a, y = _draw_problem(rng, n, m, eps, snr)
        deltas = None
        if policy in ("fixed", "dp"):
            if eps not in prior_cache:
                prior_cache[eps] = RDModel(prior)
            rd = prior_cache[eps]
            dp = dp_allocate(prob, p, t, (3.0 if policy == "fixed" else 2.0) * t,
                             rd=rd)
            deltas = DPSchedule(dp, rd, p).deltas
        reqs.append(SolveRequest(y=y, a=a, prior=prior, snr_db=snr, n_proc=p,
                                 n_iter=t, policy=policy, deltas=deltas,
                                 a_id=f"{tag}{i}"))
        s0s.append(s0)
    return reqs, s0s


def _serve_single(req, col: bool, transport=None):
    """The port's own single solve of a served request, on the card; an
    erasure request with its own mask (``SolveService._drop_mask``'s
    draw)."""
    prob = req.problem()
    er = dict(erasure_rate=req.erasure_rate, recovery=req.recovery)
    if req.policy == "bt":
        ctrl = (ColumnBTRateControl(prob, req.n_proc, req.n_iter,
                                    req.bt_c_ratio, req.bt_r_max, **er) if col
                else BTRateControl(prob, req.n_proc, req.n_iter,
                                   req.bt_c_ratio, req.bt_r_max, "ecsq",
                                   **er))
    else:
        ctrl = FixedSchedule(req.deltas if req.deltas is not None
                             else np.full(req.n_iter, np.inf))
    cfg = dict(layout=ColumnPartition(1)) if col else {}
    eng = AmpEngine(req.prior, EngineConfig(n_proc=req.n_proc,
                                            n_iter=req.n_iter,
                                            collect_symbols=False, **cfg),
                    transport or EcsqTransport(), ctrl)
    drop = None
    if req.erasure_rate > 0.0:
        drop = ErasureSpec(req.erasure_rate, req.erasure_model,
                           req.erasure_burst, req.erasure_seed).sample_mask(
                               req.n_iter, req.n_proc)
    return eng.solve(req.y, req.a, drop_sched=drop)


def _serve_agree(req, res, one, s0) -> dict:
    """A served result against its single solve on the card. A lossless
    request: SERVE_RTOL on sigma2_hat and SERVE_MSE between the estimates.
    A quantized one (fixed, DP, BT, block transports) by
    assert_traces_agree's rule (tests/test_torch_engine.py): SERVE_RTOL on
    sigma2_hat and the bins until the first iteration where the plug-ins
    part, sigma2_hat within 10 % and the final MSE within 1 dB after, and a
    fixed or DP request's bins are its schedule on both sides. The batch and
    the single solve sum in other orders, and at the paper's size (300 000
    quantized entries an iteration) some entry lands across a cell edge:
    the single solve on the card and on the CPU part the same way (the
    serve phase's record, PERF.md PR 20)."""
    mse_dx = float(np.mean((res.x - one.x) ** 2))
    mse_res, mse_one = res.mse(s0), float(np.mean((one.x - s0) ** 2))
    rel = np.abs(res.sigma2_hat / one.sigma2_hat - 1)
    row = {"policy": req.policy, "transport": req.transport, "N": req.n,
           "T": req.n_iter, "mse_between": mse_dx,
           "sdr_db": sdr_db(req.prior, mse_res),
           "sdr_db_single": sdr_db(req.prior, mse_one),
           "max_rel_dsigma2": float(rel.max())}
    if req.policy == "lossless" and req.transport == "ecsq":
        np.testing.assert_allclose(res.sigma2_hat, one.sigma2_hat,
                                   rtol=SERVE_RTOL)
        assert mse_dx <= SERVE_MSE, row
        return row
    if req.policy in ("fixed", "dp"):
        assert np.array_equal(res.deltas, np.asarray(req.deltas, np.float32)) \
            and np.array_equal(one.deltas, res.deltas), row
    close = (rel <= SERVE_RTOL) & \
        np.isclose(res.deltas, one.deltas, rtol=SERVE_RTOL)
    first = int(np.argmin(close)) if not close.all() else len(close)
    row["first_parting_iteration"] = first
    assert first >= 1, row
    if req.policy == "bt":     # the controller's rates; block: the wire's
        np.testing.assert_allclose(res.rates[:first], one.rates[:first],
                                   rtol=SERVE_RTOL)
    np.testing.assert_allclose(res.sigma2_hat, one.sigma2_hat, rtol=0.10)
    assert abs(10 * np.log10(mse_res / mse_one)) < 1.0, row
    if first == len(close):
        assert mse_dx <= SERVE_MSE, row
    return row


def _het_timing(eng, key, batch, svc) -> dict:
    """One bucket's batch solve with its operands resident: device time
    (queued behind a busy device; host_paced when the host could not keep
    it fed) and the host-paced time of one call on an idle card."""
    a_b, y_b, params, has_bt = svc._het_operands(key, batch)
    y_b = y_b.to(DEV)
    run = lambda: eng.dispatch_het(a_b, y_b, params, has_bt=has_bt)
    dev = time_ms(run, repeats=3, inner=2, warmup=1)
    call = time_call_ms(run, repeats=3)
    return {"B": len(batch), "has_bt": has_bt, "device_ms": dev["ms"],
            "host_paced": dev["host_paced"], "call_ms": call,
            "solves_per_s": len(batch) / (call / 1e3)}


def run_serve() -> dict:
    """The solve service (``repro_torch.serving.SolveService``) on the card
    at the paper's width, through the entry points a user calls: prewarm,
    then one row bucket of 8 and one column bucket of 4 in one ``solve``
    (SERVE_ROW, SERVE_COL), a block8 pair and a lone lossless request on a
    second service with the default policy. Checks every result against
    the port's own single solve, the early exit, SE drift, rate accounting,
    launches, no new programs after prewarm and no host sync in the het
    loops."""
    rng = np.random.default_rng(SEED + 20)
    rds: dict = {}
    t0 = time.perf_counter()
    row_reqs, row_s0 = _serve_requests(rng, SERVE_ROW, P, rds, "row")
    col_reqs, col_s0 = _serve_requests(rng, SERVE_COL, WIDE_P, rds, "col")
    svc = SolveService(policy=SERVE_POLICY,
                       operand_cache_bytes=SERVE_CACHE_BYTES)
    menu = [PrewarmSpec(n=r.n, m=r.m, n_proc=r.n_proc, n_iter=r.n_iter,
                        policy=r.policy, prior=r.prior, snr_db=r.snr_db,
                        layout=layout, batch_widths=(width,))
            for reqs, layout, width in ((row_reqs, "row", BATCH),
                                        (col_reqs, "col", len(col_reqs)))
            for r in reqs if r.policy in ("lossless", "bt")]
    setup_s = time.perf_counter() - t0
    prewarm = svc.prewarm(menu)
    warmed = svc.compile_count()

    reset_all_counts()
    (results, wall_ms) = timed(lambda: svc.solve(row_reqs + col_reqs))
    launches = all_counts()                       # read just after the path
    assert svc.compile_count() == warmed, (svc.compile_count(), warmed)
    row_res, col_res = results[:len(row_reqs)], results[len(row_reqs):]
    key_row, key_col = row_res[0].bucket, col_res[0].bucket
    assert {r.bucket for r in row_res} == {key_row} and \
        {r.bucket for r in col_res} == {key_col}
    assert (key_row.n_pad, key_row.mp_pad, key_row.t_max) == (10240, 112, 12)
    assert key_col.layout == "col" and key_col.t_max == 12
    t_max = key_row.t_max
    want = {"amp_local": t_max, "col_residual": t_max, "col_inner": t_max}
    assert {key: launches[key] for key in want} == want, launches
    assert launches["block_quant_fuse"] == 0 and \
        launches["amp_local_two_pass"] == 0, launches

    # the block8 pair (a batch of two: the het path) and the lone lossless
    # request (the singleton path), on the default bucket policy
    svc2 = SolveService(policy=BucketPolicy(max_batch=BATCH))
    b8_req, lone = row_reqs[0], row_reqs[0]
    b8_req = SolveRequest(y=b8_req.y, a=b8_req.a, prior=b8_req.prior,
                          n_proc=P, n_iter=T, transport="block8", a_id="row0")
    lone = SolveRequest(y=lone.y, a=lone.a, prior=lone.prior, n_proc=P,
                        n_iter=T, a_id="row0")
    reset_all_counts()
    b8_res = svc2.solve([b8_req, b8_req])
    b8_launches = all_counts()
    reset_all_counts()
    (lone_res,) = svc2.solve([lone])
    lone_launches = all_counts()
    t_b8 = b8_res[0].bucket.t_max
    assert b8_launches["block_quant_fuse"] == t_b8 and \
        b8_launches["amp_local"] == t_b8, b8_launches
    assert lone_launches["amp_local"] == T and \
        svc2.stats()["singleton_dispatches"] == 1, lone_launches
    serve_launches = {key: launches[key] + b8_launches[key] + lone_launches[key]
                      for key in launches}

    # ---- checks -----------------------------------------------------------
    agree = []
    for req, res, s0 in zip(row_reqs, row_res, row_s0):
        agree.append(_serve_agree(req, res, _serve_single(req, False), s0))
    for req, res, s0 in zip(col_reqs, col_res, col_s0):
        agree.append(_serve_agree(req, res, _serve_single(req, True), s0))
    one_b8 = _serve_single(b8_req, False, BlockQuantTransport(8, 512))
    b8_agree = _serve_agree(b8_req, b8_res[0], one_b8, row_s0[0])
    assert b8_agree["mse_between"] <= SERVE_MSE, b8_agree
    np.testing.assert_allclose(b8_res[0].rates, 8.0 + 16.0 / 512)
    one_lone = _serve_single(lone, False)
    lone_dx = float(np.abs(lone_res.x - one_lone.x).max())
    assert lone_dx <= 1e-6, lone_dx
    for req, res in zip(row_reqs + col_reqs + [lone], results + [lone_res]):
        assert res.x.shape == (req.n,) and np.all(np.isfinite(res.x))
        assert res.sigma2_hat.shape == (req.n_iter,)
        assert res.se_drift is not None and np.isfinite(res.se_drift), res
        if req.policy == "lossless":
            assert res.total_bits == 0.0 and not res.tracked
        else:
            assert res.tracked and np.isfinite(res.total_bits)

    # early exit: the T=8 instances of the T_max=12 row bucket carry the
    # bits of the same batch solved with T_max=8
    prepared = [svc._prepare(r, assign_id=False) for r in row_reqs]
    a_b, y_b, params, has_bt = svc._het_operands(key_row, prepared)
    eng8 = AmpEngine(BernoulliGauss(), EngineConfig(
        n_proc=P, n_iter=8, collect_symbols=False, collect_xs=False),
        EcsqTransport())
    p8 = params._replace(sched=params.sched[:, :8],
                         t_active=params.t_active.clamp(max=8),
                         bt=params.bt._replace(targets=params.bt.targets[:, :8]))
    tr8 = eng8.solve_het(a_b, y_b, p8, has_bt=has_bt)
    short = [i for i, r in enumerate(row_reqs) if r.n_iter == 8]
    for i in short:
        assert np.array_equal(row_res[i].x, tr8.x[i, :row_reqs[i].n]), i
        assert np.array_equal(row_res[i].sigma2_hat, tr8.sigma2_hat[i]), i

    # no host sync inside the het loops (BT in both batches)
    sync = {}
    for key, reqs in ((key_row, prepared),
                      (key_col, [svc._prepare(r, assign_id=False)
                                 for r in col_reqs])):
        eng = svc._engines[key]
        a_d, y_d, hp, bt_on = svc._het_operands(key, reqs)
        y_d = y_d.to(DEV)
        core = eng._col_het_core if key.layout == "col" else eng._het_core
        run = lambda c=core, a_=a_d, y_=y_d, h=hp, b=bt_on: c(a_, y_, h, b)
        run()
        sync[key.layout] = sync_sites(run)
    bad = {name: sorted(set(v)) for name, v in sync.items() if v}
    assert not bad, f"host syncs inside the het solve loop: {bad}"

    timing = {"row": _het_timing(svc._engines[key_row], key_row, prepared,
                                 svc),
              "col": _het_timing(svc._engines[key_col], key_col,
                                 [svc._prepare(r, assign_id=False)
                                  for r in col_reqs], svc)}
    (_, warm_wall_ms) = timed(lambda: svc.solve(row_reqs + col_reqs))
    timing["service_solve_wall_ms_warm"] = warm_wall_ms
    timing["service_solves_per_s_warm"] = \
        (len(row_reqs) + len(col_reqs)) / (warm_wall_ms / 1e3)
    emit("serve", row_bucket=str(key_row), col_bucket=str(key_col),
         policy=dataclasses.asdict(SERVE_POLICY), host_setup_s=setup_s,
         prewarm=prewarm, programs_after_prewarm=svc.compile_count() - warmed,
         first_solve_wall_ms=wall_ms, agreement=agree,
         block8={"rates": [float(v) for v in b8_res[0].rates], **b8_agree},
         singleton_max_abs_dx=lone_dx,
         early_exit_exact=[row_reqs[i].n_iter for i in short],
         se_drift=[r.se_drift for r in results],
         launches={"buckets": launches, "block8": b8_launches,
                   "singleton": lone_launches},
         synchronizing_calls_in_het_loops={k_: len(v) for k_, v in sync.items()},
         timing=timing, limits={"rtol": SERVE_RTOL, "mse": SERVE_MSE})
    return {"launches": serve_launches, "timing": timing}


def _erasure_mask(model: str, p: int, seed: int = SEED) -> np.ndarray:
    return ErasureSpec(ERASURE_RATE, model, ERASURE_BURST, seed).sample_mask(
        T, p)


def _same_bits(a, b) -> bool:
    """Two traces or two results: the same bits in every per-iteration
    record and the estimate."""
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in (
        "x", "sigma2_hat", "deltas", "extra_var", "rates"))


def se_on_mask(prob, sq2, mask: np.ndarray, layout: str, mm) -> np.ndarray:
    """The SE of one erasure run, (T,), what its sigma2_hat estimates: the
    recursion of ``se_trajectory_erasure`` (row: the denoiser input
    amplified by the survivor rescale P / k) or of ``se_trajectory_col``
    (column, one inner iteration: a lost block's MSE reset to E[S0^2],
    only the survivors' quantization noise), with round t's realised
    survivors k_t of ``mask`` (T, P) in place of the configured rate's
    expectation. An all-zero mask gives their lossless-link values."""
    p = mask.shape[1]
    kappa = prob.kappa
    mmse = lambda v: float(mm(np.asarray([v]))[0])
    if layout == "row":
        out = [prob.sigma0_2]
        for t in range(mask.shape[0] - 1):
            amp = p / max(float(p - mask[t].sum()), 1.0)
            out.append(prob.sigma_e2 + mmse(amp * (out[-1] + p * sq2[t]))
                       / kappa)
        return np.asarray(out)
    sm = prob.prior.second_moment
    d, tau = sm, []
    for t in range(mask.shape[0]):
        lost = float(mask[t].mean())
        d_in = (1.0 - lost) * d + lost * sm
        tau.append(prob.sigma_e2 + (1.0 - lost) * p * sq2[t] + d_in / kappa)
        d = mmse(tau[-1])
    return np.asarray(tau)


def _traces_agree(want, got, s0) -> int:
    """assert_traces_agree's rule (tests/test_torch_engine.py): tight until
    the first iteration whose symbols differ, there one cell on at most
    1e-3 of the entries, statistical after it; returns that iteration."""
    n_iter = len(want.sigma2_hat)
    first = n_iter
    if want.symbols is not None:
        differs = [bool((want.symbols[t] != got.symbols[t]).any())
                   for t in range(n_iter)]
        if any(differs):
            first = differs.index(True)
            d = np.abs(want.symbols[first].astype(np.int64)
                       - got.symbols[first].astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, \
                (first, int(d.max()), float((d > 0).mean()))
    upto = min(first + 1, n_iter)
    np.testing.assert_allclose(got.sigma2_hat[:upto], want.sigma2_hat[:upto],
                               rtol=1e-3)
    np.testing.assert_allclose(got.deltas[:upto], want.deltas[:upto],
                               rtol=1e-4)
    np.testing.assert_allclose(got.rates[:upto], want.rates[:upto], rtol=1e-4)
    mse_w, mse_g = want.mse(s0), got.mse(s0)
    np.testing.assert_allclose(mse_g[:first], mse_w[:first], rtol=1e-3)
    if first == n_iter:
        np.testing.assert_allclose(got.x, want.x, atol=1e-4)
    else:
        np.testing.assert_allclose(got.sigma2_hat, want.sigma2_hat, rtol=0.10)
        assert abs(10 * np.log10(mse_g[-1] / mse_w[-1])) < 1.0
    return first


def _erasure_runs(engines: dict, twins: dict, a, y, s0, p: int, layout: str,
                  prob, mm, ll_mse: float) -> dict:
    """Each engine drop-free, with an all-zero mask and with each model's
    mask: the checks of the ``erasure`` phase, the launches of the masked
    solves (reset just before each) and their first-call wall time. Each
    masked solve is held against its CPU twin of ``twins`` (the plain
    versions) on the same mask."""
    out = {}
    lo, hi = ERASURE_ENVELOPE
    for name, eng in engines.items():
        base = eng.solve(y, a)
        zero = eng.solve(y, a, drop_sched=np.zeros((T, p), np.float32))
        row = {"zero_mask_bit_identical": _same_bits(base, zero),
               "mse_drop_free": float(base.mse(s0)[-1])}
        assert row["zero_mask_bit_identical"], (layout, name)
        for model in ERASURE_MODELS:
            mask = _erasure_mask(model, p)
            reset_all_counts()
            tr, wall = timed(lambda: eng.solve(y, a, drop_sched=mask))
            launches = {key: v for key, v in all_counts().items() if v}
            mse = float(tr.mse(s0)[-1])
            # per-processor quantizer noise: the bins' (ECSQ), else the
            # drop-free run's account (block transports; 0 when lossless)
            sq2 = base.extra_var / p
            if isinstance(eng.transport, EcsqTransport):
                sq2 = np.where(np.isfinite(tr.deltas), tr.deltas, 0.0) ** 2 / 12
            if layout == "row":
                at_rate = se_trajectory_erasure(prob, sq2, p, ERASURE_RATE,
                                                mmse_fn=mm)[:T]
            else:
                at_rate, _ = se_trajectory_col(prob, p, T, 1, sigma_q2=sq2,
                                               mmse_fn=mm,
                                               erasure_rate=ERASURE_RATE)
            ratio = tr.sigma2_hat / se_on_mask(prob, sq2, mask, layout, mm)
            cpu = twins[name].solve(y, a, drop_sched=mask)
            vs_cpu = {"max_abs_dx": float(np.abs(tr.x - cpu.x).max()),
                      "max_rel_dsigma2": float(np.abs(
                          tr.sigma2_hat / cpu.sigma2_hat - 1).max())}
            if name == "lossless":
                assert vs_cpu["max_abs_dx"] <= ERASURE_CPU_DX and \
                    vs_cpu["max_rel_dsigma2"] <= ERASURE_CPU_DS, \
                    (layout, name, model, vs_cpu)
            else:
                vs_cpu["first_parting_iteration"] = _traces_agree(cpu, tr, s0)
            rec = {"card_vs_cpu": vs_cpu,
                   "mse": mse, "mse_over_lossless": mse / ll_mse,
                   "sigma2_hat_over_se_on_mask": [float(v) for v in ratio],
                   "sigma2_hat_over_se_at_rate": [
                       float(v) for v in tr.sigma2_hat / at_rate],
                   "packets_lost": int(mask.sum()),
                   "fewest_survivors": int((1 - mask).sum(1).min()),
                   "launches": launches, "first_call_wall_ms": wall}
            row[model] = rec
            assert tr.x.shape == (N,) and np.all(np.isfinite(tr.x)), rec
            assert ll_mse < mse < ERASURE_MSE_MAX * ll_mse, (layout, name, rec)
            assert np.all((ratio >= lo) & (ratio <= hi)), (layout, name, rec)
            want = ({"amp_local": T} if layout == "row"
                    else {"col_residual": T, "col_inner": T})
            if isinstance(eng.transport, BlockQuantTransport):
                want["block_quant_fuse"] = T      # K4 once an iteration
            assert launches == want, (layout, name, launches, want)
        out[name] = row
    return out


def _erasure_requests(rng, specs, p, rds, tag, col: bool):
    """Served requests with their erasure fields (``ERASURE_SERVE`` /
    ``CLUSTER_COL`` entries) and ground truth: fixed bins from a DP
    allocation (3 bits an iteration; the column allocator for column
    requests), DP bins planned for the link by the service."""
    reqs, s0s = [], []
    for i, (n, m, t, eps, snr, policy, rate, model) in enumerate(specs):
        prior, prob, s0, a, y = _draw_problem(rng, n, m, eps, snr)
        deltas = None
        if policy == "fixed" and col:
            deltas = ColDPSchedule(dp_allocate_col(prob, p, t, 3.0 * t),
                                   prob, p).deltas
        elif policy == "fixed":
            if eps not in rds:
                rds[eps] = RDModel(prior)
            deltas = DPSchedule(dp_allocate(prob, p, t, 3.0 * t,
                                            rd=rds[eps]), rds[eps], p).deltas
        reqs.append(SolveRequest(
            y=y, a=a, prior=prior, snr_db=snr, n_proc=p, n_iter=t,
            policy=policy, deltas=deltas, layout="col" if col else "row",
            erasure_rate=rate, erasure_model=model,
            erasure_burst=ERASURE_BURST, erasure_seed=SEED + i,
            a_id=f"{tag}{i}"))
        s0s.append(s0)
    return reqs, s0s


def _erasure_menu(reqs, widths) -> list:
    """One prewarm spec a (bucket, program family) of ``reqs``."""
    seen, menu = set(), []
    for r in reqs:
        key = (r.n, r.m, r.n_proc, r.n_iter, r.layout, r.transport,
               r.policy == "bt")
        if key in seen:
            continue
        seen.add(key)
        menu.append(PrewarmSpec(n=r.n, m=r.m, n_proc=r.n_proc,
                                n_iter=r.n_iter,
                                policy="bt" if r.policy == "bt" else "lossless",
                                transport=r.transport,
                                prior=r.prior, snr_db=r.snr_db,
                                layout=r.layout,
                                batch_widths=(widths[r.layout],)))
    return menu


def run_erasure(ctx, col_ctx) -> dict:
    """The erasure phase at the paper's point: row solves (P=30: lossless,
    ECSQ with a fixed schedule, DP planned for the link, BT planned for
    it, int8 blocks) and column solves (P=25: lossless, int8 blocks, under
    the reset), each drop-free, with an all-zero mask and under Bernoulli
    and Gilbert masks, each masked solve against its CPU twin; no host
    sync in the masked loops; two served row buckets of 8 (ECSQ and int8
    blocks) with erasure and lossless requests mixed, each against its
    own single solve."""
    t_phase = time.perf_counter()
    prior, prob, mm = ctx["prior"], ctx["prob"], ctx["mm"]
    a, y, s0 = ctx["a"], ctx["y"], ctx["s0"]
    t0 = time.perf_counter()
    rd = RDModel(prior)
    er = dict(erasure_rate=ERASURE_RATE, recovery="retransmit")
    dp_e = DPSchedule(dp_allocate(prob, P, T, 2.0 * T, rd=rd, mmse_fn=mm,
                                  **er), rd, P)
    bt_e = BTRateControl(prob, P, T, 1.005, 6.0, "ecsq", mmse_fn=mm, **er)
    setup_s = time.perf_counter() - t0

    def row_set(dev):
        eng = lambda tp, ctrl=None: AmpEngine(
            prior, EngineConfig(n_proc=P, n_iter=T, device=dev), tp, ctrl)
        return {"lossless": eng(EcsqTransport(), FixedSchedule([np.inf] * T)),
                "fixed": eng(EcsqTransport(),
                             FixedSchedule(ctx["dp_sched"].deltas)),
                "dp": eng(EcsqTransport(), dp_e),
                "bt": eng(EcsqTransport(), bt_e),
                "block8": eng(BlockQuantTransport(8))}

    def col_set(dev):
        return {"lossless": col_engine(prior, ExactFusion(), device=dev),
                "block8": col_engine(prior, BlockQuantTransport(8),
                                     device=dev)}

    rows, cols = row_set("cuda"), col_set("cuda")
    ll_row = float(rows["lossless"].solve(y, a).mse(s0)[-1])
    ll_col = float(cols["lossless"].solve(y, a).mse(s0)[-1])
    t0 = time.perf_counter()
    row_runs = _erasure_runs(rows, row_set("cpu"), a, y, s0, P, "row", prob,
                             mm, ll_row)
    col_runs = _erasure_runs(cols, col_set("cpu"), a, y, s0, P_COL, "col",
                             prob, mm, ll_col)
    runs_s = time.perf_counter() - t0
    launches = {}
    for layout, runs in (("row", row_runs), ("col", col_runs)):
        for name, r in runs.items():
            for model in ERASURE_MODELS:
                for key, v in r[model]["launches"].items():
                    launches[key] = launches.get(key, 0) + v

    # no host sync inside the masked loops; each masked solve (Bernoulli)
    # beside its drop-free solve, operands and mask already on the card:
    # device time queued behind a busy device, and six single calls a side
    # on an idle card (host pace included) in turns, ABBA, with their
    # quartiles (host-paced times spread 20-80 % between calls)
    a_p, y_p = rows["lossless"]._split(y, a)
    a_cp, y_c = cols["lossless"]._split_col(y, a)
    sync, solve_ms = {}, {}

    def quartiles(v):
        q = statistics.quantiles(v, n=4)
        return {"median": statistics.median(v), "q1": q[0], "q3": q[2]}

    def pair(label, run_masked, run_free):
        run_masked()
        run_free()
        calls = {"masked": [], "drop_free": []}
        for i in range(6):
            order = [("masked", run_masked), ("drop_free", run_free)]
            for side, fn in (order if i % 2 == 0 else order[::-1]):
                calls[side].append(time_call_ms(fn, repeats=1, warmup=0))
        solve_ms[label] = {
            "device_ms": time_ms(run_masked, repeats=3, inner=2,
                                 warmup=0)["ms"],
            "device_ms_drop_free": time_ms(run_free, repeats=3, inner=2,
                                           warmup=0)["ms"],
            "call_ms": quartiles(calls["masked"]),
            "call_ms_drop_free": quartiles(calls["drop_free"])}
        return run_masked

    for name, eng in rows.items():
        sched = eng._f32(eng._sched_operand())
        drop = eng._f32(_erasure_mask("bernoulli", P))
        run = pair(f"row_{name}",
                   lambda e=eng, s_=sched, d=drop: e.dispatch_single(
                       a_p, y_p, M, N, s_, drop_sched=d),
                   lambda e=eng, s_=sched: e.dispatch_single(a_p, y_p, M, N,
                                                             s_))
        if name in ("lossless", "block8", "bt"):
            sync[f"row_{name}"] = sync_sites(run)
    for name, eng in cols.items():
        sched = eng._f32(eng._sched_operand())
        par = eng._col_prior_params(M)
        drop = eng._f32(_erasure_mask("bernoulli", P_COL))
        run = pair(f"col_{name}",
                   lambda e=eng, s_=sched, q=par, d=drop: e._col_solve_core(
                       a_cp, y_c, s_, q, M, N, d),
                   lambda e=eng, s_=sched, q=par: e._col_solve_core(
                       a_cp, y_c, s_, q, M, N))
        sync[f"col_{name}"] = sync_sites(run)
    del a_p, y_p, a_cp, y_c

    # served row buckets of 8, erasure and lossless requests mixed: the ECSQ
    # one, and the paper-point problems of it over int8 blocks (K4 with each
    # instance's keep row, (B, P), zero rows for the drop-free requests;
    # five requests and three pad slots), on a service whose N quantum
    # divides the scale block (buckets.py: pad-invariant noise accounting)
    rng = np.random.default_rng(SEED + 30)
    ecsq, s0s = _erasure_requests(rng, ERASURE_SERVE, P, {}, "er", False)
    paper = [i for i, r in enumerate(ecsq) if (r.n, r.m) == (N, M)]
    b8 = [dataclasses.replace(ecsq[i], policy="lossless", deltas=None,
                              transport="block8", a_id=f"{ecsq[i].a_id}b8")
          for i in paper]
    streams = {"ecsq": (SERVE_POLICY, ecsq, s0s),
               "block8": (dataclasses.replace(SERVE_POLICY, n_quantum=512),
                          b8, [s0s[i] for i in paper])}
    serve_wall, serve_launches, served, agree = {}, {}, {}, []
    warm_after = {}
    for tname, (pol, reqs, s0_list) in streams.items():
        svc = SolveService(policy=pol, operand_cache_bytes=SERVE_CACHE_BYTES)
        svc.prewarm(_erasure_menu(reqs, {"row": BATCH}))
        warmed = svc.compile_count()
        reset_all_counts()
        results, serve_wall[tname] = timed(lambda: svc.solve(reqs))
        counts = all_counts()
        warm_after[tname] = svc.compile_count() - warmed
        assert warm_after[tname] == 0, (tname, warm_after)
        (key,) = {r.bucket for r in results}
        assert key.layout == "row" and key.transport == tname, key
        # K1 once an iteration, K4 once an iteration of the block8 batch
        assert counts["amp_local"] == key.t_max, (tname, counts)
        assert counts["block_quant_fuse"] == (
            key.t_max if tname == "block8" else 0), (tname, counts)
        for k_, v in counts.items():
            serve_launches[k_] = serve_launches.get(k_, 0) + v
        tp = BlockQuantTransport(8, 512) if tname == "block8" else None
        for req, res, s0_ in zip(reqs, results, s0_list):
            req = svc._prepare(req, assign_id=False)    # a DP request's bins
            row = _serve_agree(req, res, _serve_single(req, False, tp), s0_)
            row.update(erasure_rate=req.erasure_rate,
                       erasure_model=req.erasure_model)
            if req.erasure_rate > 0.0 and res.tracked:
                # on-the-wire rates: the delivered rate times 1 / (1 - rate)
                assert np.all(res.rates[np.isfinite(res.rates)] > 0), \
                    res.rates
            agree.append(row)
        served[tname] = (svc, key, reqs)
    het_device_ms = {}
    for tname, (svc, key, reqs) in served.items():
        prepared = [svc._prepare(r, assign_id=False) for r in reqs]
        # the pad slots repeat real requests, as the service's dispatch does
        prepared = [prepared[i % len(prepared)] for i in range(BATCH)]
        eng = svc._engines[key]
        a_d, y_d, hp, bt_on = svc._het_operands(key, prepared)
        assert hp.drop is not None and \
            tuple(hp.drop.shape) == (BATCH, key.t_max, P)
        y_d = y_d.to(DEV)
        run = lambda: eng._het_core(a_d, y_d, hp, bt_on)
        run()
        sync[f"row_het_{tname}"] = sync_sites(run)
        het_device_ms[tname] = time_ms(run, repeats=3, inner=2,
                                       warmup=1)["ms"]
        del a_d, y_d, run
    bad = {name: sorted(set(v)) for name, v in sync.items() if v}
    assert not bad, f"host syncs inside the erasure loops: {bad}"

    wall_ms = {f"{layout}_{name}": {m: r[m]["first_call_wall_ms"]
                                    for m in ERASURE_MODELS}
               for layout, runs in (("row", row_runs), ("col", col_runs))
               for name, r in runs.items()}
    emit("erasure", rate=ERASURE_RATE, models=list(ERASURE_MODELS),
         burst=ERASURE_BURST, mask_seed=SEED, host_setup_s=setup_s,
         limits={"mse_over_lossless": [1.0, ERASURE_MSE_MAX],
                 "sigma2_hat_over_se_on_mask": ERASURE_ENVELOPE,
                 "card_vs_cpu": {"lossless_max_abs_dx": ERASURE_CPU_DX,
                                 "lossless_max_rel_dsigma2": ERASURE_CPU_DS,
                                 "quantized": "assert_traces_agree's rule"}},
         lossless_mse={"row": ll_row, "col": ll_col},
         row=row_runs, col=col_runs,
         served_buckets={t_: str(v[1]) for t_, v in served.items()},
         served_agreement=agree,
         served_wall_ms=serve_wall, served_launches=serve_launches,
         served_programs_after_prewarm=warm_after,
         synchronizing_calls_in_erasure_loops={n_: len(v)
                                               for n_, v in sync.items()},
         timing={"method": "first call: host clock, synchronised; "
                           "device_ms: queued behind a busy device "
                           "(time_ms); call_ms: single calls on an idle card "
                           "(time_call_ms), six a side in turns, median and "
                           "quartiles; Bernoulli mask on the card; each "
                           "beside the same engine's drop-free solve",
                 "wall_ms": wall_ms, "solves": solve_ms,
                 "het_row_bucket_device_ms": het_device_ms,
                 "masked_runs_with_cpu_twins_s": runs_s},
         seconds=time.perf_counter() - t_phase)
    launches = {k_: launches.get(k_, 0) + serve_launches.get(k_, 0)
                for k_ in set(launches) | set(serve_launches)}
    return {"launches": launches}


def _cluster_stream():
    """The cluster phase's stream: the served erasure row bucket of 8 and
    a column bucket of 4 at the wide problem, erasure requests in both."""
    rng = np.random.default_rng(SEED + 40)
    row, row_s0 = _erasure_requests(rng, ERASURE_SERVE, P, {}, "cr", False)
    col, col_s0 = _erasure_requests(rng, CLUSTER_COL, WIDE_P, {}, "cc", True)
    return row + col, row_s0 + col_s0


def run_cluster() -> dict:
    """The cluster plane on the card: a ``ClusterService`` over two
    ``LocalBackend``s (two ``SolveService``s on the one card) against one
    ``SolveService`` on the same stream, request for request the same
    bits; every host serves; no program first run after prewarm; a
    ``ChaosBackend`` kill of one host at its first flush loses nothing
    and replays the same bits; the same stream at full width through a
    ``TcpBackend`` to a ``BackendServer`` on loopback, the same bits; and
    ``launch/multihost.py --smoke``: a child process behind a
    ``BackendServer``, reached by ``TcpBackend``, at its toy load."""
    t_phase = time.perf_counter()
    reqs, _ = _cluster_stream()
    widths = {"row": BATCH, "col": len(CLUSTER_COL)}
    menu = _erasure_menu(reqs, widths)
    kw = dict(policy=SERVE_POLICY, operand_cache_bytes=SERVE_CACHE_BYTES)

    single = SolveService(**kw)
    single.prewarm(menu)
    want, single_ms = timed(lambda: single.solve(reqs))
    _, single_warm_ms = timed(lambda: single.solve(reqs))

    cluster = ClusterService(n_hosts=2, **kw)
    cluster.prewarm(menu)
    warm = {hid: b.compile_count() for hid, b in cluster.backends.items()}
    reset_all_counts()
    got, cluster_ms = timed(lambda: cluster.solve(reqs))
    launches = all_counts()
    st = cluster.stats()
    served = st["router"]["served"]
    after = {hid: b.compile_count() - warm[hid]
             for hid, b in cluster.backends.items()}
    dx = max(float(np.abs(g.x - w.x).max()) for g, w in zip(got, want))
    same = all(_same_bits(g, w) for g, w in zip(got, want))
    assert dx == 0.0 and same, dx
    assert all(v > 0 for v in served.values()), served
    assert all(v == 0 for v in after.values()), after
    _, warm_ms = timed(lambda: cluster.solve(reqs))
    cluster.close()
    del cluster

    # a host killed at its first flush (whichever of its calls that is):
    # its flights replay on the other
    first_flush = FaultPlan(faults=tuple(
        FaultSpec("kill", i, ops=("flush",)) for i in range(1, len(reqs) + 2)))
    chaos = ClusterService(
        backends=[LocalBackend("host0", SolveService(**kw)),
                  ChaosBackend(LocalBackend("host1", SolveService(**kw)),
                               first_flush)],
        policy=SERVE_POLICY,
        router_policy=RouterPolicy(min_replicas=1, suspect_after=1,
                                   dead_after=1, retry_limit=2,
                                   retry_backoff_s=0.0))
    got_c = chaos.solve(reqs)
    st_c = chaos.stats()
    dx_c = max(float(np.abs(g.x - w.x).max()) for g, w in zip(got_c, want))
    assert len(got_c) == len(reqs) and st_c["lost"] == 0, st_c
    assert st_c["failovers"] == 1 and \
        st_c["host_states"]["host1"] == "dead", st_c
    assert dx_c == 0.0 and all(_same_bits(g, w)
                               for g, w in zip(got_c, want)), dx_c
    chaos.close()
    del chaos, single

    # the same stream over TCP at full width, every request through the
    # codec and a loopback socket: a BackendServer (a serving thread of this
    # process, its own SolveService on the card) behind a TcpBackend, the
    # only host of a ClusterService; run twice, the submit round trips of
    # the second split by layout (ClusterService.solve submits in order)
    frame_mb = {r.layout: len(encode_request(r)) / 2 ** 20
                for r in (reqs[0], reqs[-1])}
    server = BackendServer(LocalBackend("host1", SolveService(**kw)),
                           idle_timeout_s=600.0)
    server.start()
    try:
        tcp = TcpBackend((server.host, server.port), "host1",
                         connect_timeout_s=10.0, recv_timeout_s=600.0)
        wire = ClusterService(backends=[tcp], policy=SERVE_POLICY)
        wire.prewarm(menu)
        warm_tcp = wire.compile_count()
        got_t, tcp_first_ms = timed(lambda: wire.solve(reqs))
        _, tcp_warm_ms = timed(lambda: wire.solve(reqs))
        tcp_after = wire.compile_count() - warm_tcp
        rtt_ops = wire.rtt_stats()["host1"]
        submits = list(tcp._rtt[b"S"])[-len(reqs):]
        wire.close(shutdown_remote=True)
    finally:
        server.stop()
        assert server.join(30.0), "the backend server's thread did not end"
    dx_t = max(float(np.abs(g.x - w.x).max()) for g, w in zip(got_t, want))
    assert dx_t == 0.0 and all(_same_bits(g, w)
                               for g, w in zip(got_t, want)), dx_t
    assert tcp_after == 0, tcp_after
    submit_ms = {}
    for layout in frame_mb:
        v = sorted(1e3 * t_ for t_, r in zip(submits, reqs)
                   if r.layout == layout)
        submit_ms[layout] = {"count": len(v), "median": statistics.median(v),
                             "min": v[0], "max": v[-1]}
    for layout, mb in frame_mb.items():
        print(f"cluster tcp full width: {layout} request frame {mb:.1f} MiB, "
              f"submit round trip median {submit_ms[layout]['median']:.1f} "
              f"ms (n={submit_ms[layout]['count']})", flush=True)

    # two processes on the one card: the frontend's LocalBackend and a
    # child's BackendServer over TCP (the kernels are built: it loads),
    # at the smoke load of multihost.py (N=128, M=64: frames of ~33 KB)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.multihost", "--smoke",
         "--timeout", "240"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    mh_lines = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("multihost")]
    assert proc.returncode == 0, (proc.returncode, mh_lines,
                                  proc.stderr[-3000:])
    rtt = [ln for ln in mh_lines if "frame rtt" in ln]
    result = [ln for ln in mh_lines if "results in" in ln]
    assert rtt and result and "max|dx| 0.0e+00" in result[0], mh_lines
    for ln in rtt:
        print(ln, flush=True)
    n_req = len(reqs)
    emit("cluster", hosts=2, requests=n_req,
         buckets=sorted({str(r.bucket) for r in got}),
         max_abs_dx_vs_single_host=dx, served=served,
         programs_after_prewarm=after, launches=launches,
         single_host_solve_ms=single_ms, cluster_first_solve_ms=cluster_ms,
         single_host_warm_solve_ms=single_warm_ms,
         cluster_warm_solve_ms=warm_ms,
         single_host_solves_per_s_warm=n_req / (single_warm_ms / 1e3),
         cluster_solves_per_s_warm=n_req / (warm_ms / 1e3),
         note="two SolveServices on one card: oversubscription, not scaling",
         chaos={"lost": st_c["lost"], "failovers": st_c["failovers"],
                "retries": st_c["retries"], "host_states": st_c["host_states"],
                "recovery": st_c["recovery"], "max_abs_dx_vs_single_host": dx_c},
         tcp_full_width={
             "hosts": 1, "requests": n_req, "max_abs_dx_vs_single_host": dx_t,
             "programs_after_prewarm": tcp_after,
             "request_frame_mib": frame_mb,
             "first_solve_ms": tcp_first_ms, "warm_solve_ms": tcp_warm_ms,
             "solves_per_s_warm": n_req / (tcp_warm_ms / 1e3),
             "submit_round_trip_ms_warm": submit_ms,
             "round_trip_ms_per_op": rtt_ops,
             "note": "a BackendServer thread of this process on loopback; "
                     "round trips from send to parsed reply, encoding "
                     "excluded; both runs in the per-op window"},
         multihost_smoke_load={"returncode": proc.returncode,
                               "lines": mh_lines,
                               "note": "N=128, M=64, P=4, T=8: frames of "
                                       "~33 KB, a liveness check; its round "
                                       "trips are that load's only"},
         seconds=time.perf_counter() - t_phase)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# multi-device solves (phase ``sharded``)
# ---------------------------------------------------------------------------

SHARD_D = 2                       # ranks sharing the one card, over gloo
SHARD_DELTAS = np.asarray([np.inf] + [0.05] * (T - 1), np.float32)
SHARD_MSE_RATIO = 1.25            # int8 wire: MSE under 1.25 x lossless
SHARD_DX = 1e-4                   # exact sharded == emulated, max |dx|
SHARD_ENVELOPE = (0.5, 2.0)       # sigma2_hat / SE on the realized noise
SHARD_DATA_MSE = 1e-10            # served "data" == local, mean (dx)^2
SHARD_PROC_MSE = 1e-10            # served "proc" lossless == local
SHARD_PROC_BT = 1.3               # served "proc" BT: MSE <= 1.3 x local
# a sharded solve's launches on each rank: K1 once an iteration, and on the
# compressed wires K4a twice (both phases), K4b-sum and K4b once
SHARD_LAUNCHES = {
    "int8": {"amp_local": T, "quantize_blocks": 2 * T, "dequantize_sum": T,
             "dequantize_blocks": T},
    "int4": {"amp_local": T, "quantize_blocks_packed": 2 * T,
             "dequantize_sum_packed": T, "dequantize_blocks_packed": T},
    "exact": {"amp_local": T}, "ecsq": {"amp_local": T}}


def _shard_problems(device):
    """The paper's row problem (the main path's draw, seed SEED) and the
    wide column one (the column phase's, SEED + 2), on ``device``."""
    prior = BernoulliGauss(eps=EPS)
    prob = CSProblem(n=N, m=M, prior=prior, snr_db=SNR_DB)
    prob_w = CSProblem(n=WIDE_N, m=WIDE_M, prior=prior, snr_db=SNR_DB)
    gen = torch.Generator(device=device).manual_seed(SEED)
    row = sample_problem(gen, N, M, prior, prob.sigma_e2, device=str(device))
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    col = sample_problem(gen, WIDE_N, WIDE_M, prior, prob_w.sigma_e2,
                         device=str(device))
    return prior, prob, row, col


def _shard_service_requests():
    """A lossless row bucket of 8 at the paper's size (two priors and SNRs,
    T of 10 and 8) and two proc requests (lossless, BT), drawn with
    numpy from seeds: rank 0 of the mesh and the parent draw the same."""
    rng = np.random.default_rng(SEED + 40)
    data = []
    for i in range(BATCH):
        eps, snr = (0.05, 20.0) if i % 2 == 0 else (0.10, 15.0)
        prior, prob, s0, a, y = _draw_problem(rng, N, M, eps, snr)
        data.append((SolveRequest(y=y, a=a, prior=prior, snr_db=snr,
                                  n_proc=P, n_iter=T if i % 4 else 8), s0))
    rng = np.random.default_rng(SEED + 41)
    prior, prob, s0, a, y = _draw_problem(rng, N, M, EPS, SNR_DB)
    proc = [(SolveRequest(y=y, a=a, prior=prior, snr_db=SNR_DB, n_proc=P,
                          n_iter=T, policy=pol), s0)
            for pol in ("lossless", "bt")]
    return data, proc


SHARD_DATA_POLICY = BucketPolicy(max_batch=BATCH, n_quantum=2048,
                                 mp_quantum=112, t_quantum=6,
                                 shard_elems=1 << 40)
SHARD_PROC_POLICY = dataclasses.replace(SHARD_DATA_POLICY, shard_elems=1)


def _timed_solve(fn):
    """``fn()`` with its wall time (host clock, the card synchronised at
    both ends) and the CUDA-event time of the rank's stream over it (idle
    gaps included: the loop is host-paced)."""
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, {"wall_ms": 1e3 * (time.perf_counter() - t0),
                 "events_ms": e0.elapsed_time(e1)}


def _shard_engine(prior, transport, p=P, controller=None, col=False,
                  device=DEV):
    cfg = EngineConfig(n_proc=p, n_iter=T, collect_symbols=False,
                       device=str(device),
                       **({"layout": ColumnPartition(1)} if col else {}))
    return AmpEngine(prior, cfg, transport, controller)


def sharded_rank(mesh) -> dict:
    """One rank of the phase's world of SHARD_D gloo ranks sharing the card
    (every rank's tensors on cuda:0): the sharded engine solves, then the
    solve service on the mesh (rank 0 serves, the others run the worker
    loop). Results as numpy."""
    from repro_torch.serving.service import serve_mesh_worker
    dev, d = mesh.device, mesh.size
    prior, prob, (s0, a, y), (s0w, aw, yw) = _shard_problems(dev)
    checksum = float(a.double().sum())
    out, times = {}, {}
    sched = FixedSchedule(SHARD_DELTAS)
    drop = np.zeros((T, d), np.float32)
    drop[3, 0] = 1.0                          # rank 0 out at iteration 3
    runs = {
        "exact": lambda: _shard_engine(prior, PsumFusion(), device=dev)
        .solve_sharded(y, a, mesh),
        "ecsq": lambda: _shard_engine(prior, PsumFusion(
            local=EcsqTransport()), controller=sched, device=dev)
        .solve_sharded(y, a, mesh),
        "ecsq_drop": lambda: _shard_engine(prior, PsumFusion(
            local=EcsqTransport()), controller=sched, device=dev)
        .solve_sharded(y, a, mesh, drop_sched=drop),
        "int8": lambda: _shard_engine(prior, CompressedPsumTransport(
            bits=8), device=dev).solve_sharded(y, a, mesh),
        "int4": lambda: _shard_engine(prior, CompressedPsumTransport(
            bits=4), device=dev).solve_sharded(y, a, mesh),
        "wide_col_exact": lambda: _shard_engine(
            prior, PsumFusion(), p=WIDE_P, col=True, device=dev)
        .solve_sharded(yw, aw, mesh),
    }
    stats, launches = {}, {}
    for name, fn in runs.items():
        fn()                                  # warm: the first call builds
        mesh.stats.reset()
        reset_all_counts()
        tr, times[name] = _timed_solve(fn)
        launches[name] = {key: v for key, v in all_counts().items() if v}
        stats[name] = mesh.stats.snapshot()
        out[name] = {"x": tr.x, "sigma2_hat": tr.sigma2_hat,
                     "extra_var": tr.extra_var}
    del a, y, aw, yw
    res = {"solves": out, "times": times, "stats": stats,
           "launches": launches, "a_checksum": checksum}
    if mesh.rank != 0:
        res["worker"] = serve_mesh_worker(mesh, 2 << 30)
        return res
    data, proc = _shard_service_requests()
    svc_d = SolveService(policy=SHARD_DATA_POLICY, mesh=mesh,
                         operand_cache_bytes=2 << 30)
    svc_p = SolveService(policy=SHARD_PROC_POLICY, mesh=mesh,
                         operand_cache_bytes=2 << 30)
    try:
        got_d, times["serve_data_bucket8"] = _timed_solve(
            lambda: svc_d.solve([r for r, _ in data]))
        got_p, times["serve_proc_pair"] = _timed_solve(
            lambda: svc_p.solve([r for r, _ in proc]))
        # a repeat: every rank's A from its operand cache, only y crosses
        _, times["serve_data_bucket8_repeat"] = _timed_solve(
            lambda: svc_d.solve([r for r, _ in data]))
    finally:
        svc_p.close()
    res["service"] = {
        "data": [{"x": r.x, "sigma2_hat": r.sigma2_hat,
                  "placement": r.bucket.placement} for r in got_d],
        "proc": [{"x": r.x, "sigma2_hat": r.sigma2_hat,
                  "placement": r.bucket.placement,
                  "total_bits": r.total_bits} for r in got_p],
        "stats": mesh.stats.snapshot(),
        "cache": svc_d.stats()["operand_cache"]}
    return res


def _nccl_world_of_one(store_dir: str) -> dict:
    """Phase (a): an NCCL world of one rank on the card, in this process:
    the row solve at the paper's point with PsumFusion against the
    emulated solve, the int8 and int4 compressed wires, their launches, no
    host sync in the loops."""
    import torch.distributed as dist
    init_cluster(num_processes=1, process_id=0, backend="nccl",
                 store_path=os.path.join(store_dir, "nccl1"), device=str(DEV))
    try:
        mesh = make_serve_mesh(device=str(DEV))
        prior, prob, (s0, a, y), _ = _shard_problems(DEV)
        s0 = s0.cpu().numpy()
        em = _shard_engine(prior, ExactFusion()).solve(y, a)
        engines = {"exact": _shard_engine(prior, PsumFusion()),
                   "int8": _shard_engine(prior, CompressedPsumTransport(bits=8)),
                   "int4": _shard_engine(prior, CompressedPsumTransport(bits=4)),
                   "ecsq": _shard_engine(prior, PsumFusion(
                       local=EcsqTransport()),
                       controller=FixedSchedule(SHARD_DELTAS))}
        runs, times, launches, stats = {}, {}, {}, {}
        for name, eng in engines.items():
            eng.solve_sharded(y, a, mesh)      # warm
            reset_all_counts()
            mesh.stats.reset()
            runs[name], times[name] = _timed_solve(
                lambda eng=eng: eng.solve_sharded(y, a, mesh))
            launches[name] = {key: v for key, v in all_counts().items() if v}
            stats[name] = mesh.stats.snapshot()
        # the driven run whose launches the kernels line reports: the
        # int8 and int4 wires, counts set to 0 just before
        reset_all_counts()
        for name in ("int8", "int4"):
            engines[name].solve_sharded(y, a, mesh)
        driven = all_counts()
        # the loops alone, operands on the card, under the sync debug mode
        sites = {}
        for name, eng in engines.items():
            a_p, y_p = split_problem(a, y, P)
            sched = eng._f32(eng._sched_operand())
            drops = eng._rank_drop_sched(None, mesh)
            loop = lambda eng=eng, a_p=a_p, y_p=y_p, sched=sched, \
                drops=drops: eng._solve_core(a_p, y_p, sched, M, N, drops,
                                             mesh)
            loop()
            sites[name] = sync_sites(loop)
        # ---- checks ------------------------------------------------------
        mse = lambda x: float(np.mean((x - s0) ** 2))
        dx = float(np.abs(runs["exact"].x - em.x).max())
        assert dx <= SHARD_DX, ("exact sharded != emulated", dx)
        ratio = {k: mse(runs[k].x) / mse(em.x) for k in ("int8", "int4")}
        assert ratio["int8"] < SHARD_MSE_RATIO, ratio
        envelope = {}
        for name in ("int8", "int4"):
            tr = runs[name]
            assert np.all(np.isfinite(tr.x)) and np.all(tr.extra_var > 0), name
            se = se_trajectory_quantized(prob, tr.extra_var / P, P)
            envelope[name] = [float(v) for v in tr.sigma2_hat / se[:T]]
            lo, hi = SHARD_ENVELOPE
            assert all(lo < v < hi for v in envelope[name]), (name, envelope)
        assert np.all(runs["int4"].extra_var > runs["int8"].extra_var)
        for name, w in SHARD_LAUNCHES.items():
            assert launches[name] == w, (name, launches[name])
        for name, st in sites.items():
            assert not st, (name, st)
        for name in ("int8", "int4"):
            assert set(stats[name]["bytes"]["all_to_all"]) == {"uint8"}
            assert set(stats[name]["bytes"]["all_gather"]) == {"uint8"}
        return {"mesh": {"backend": mesh.backend, "size": mesh.size,
                         "device": str(mesh.device)},
                "max_abs_dx_exact_vs_emulated": dx,
                "mse_over_lossless": ratio,
                "sigma2_hat_over_se_realized_noise": envelope,
                "launches_per_solve": launches, "collectives": stats,
                "host_sync_sites": sites, "times": times,
                "emulated_lossless_mse": mse(em.x),
                "driven_launches": driven}
    finally:
        dist.destroy_process_group()


def run_sharded() -> dict:
    """Phase ``sharded``: (a) an NCCL world of one on the card, in this
    process; (b) a world of SHARD_D spawned gloo ranks sharing the card
    (NCCL refuses two ranks on one GPU), every rank's compute on the card,
    its collectives through host memory (gloo's own copies; send/recv
    staged by ``core/collectives.py``).
    The kernels are built before any rank is spawned (the children only
    load them)."""
    import tempfile
    t_phase = time.perf_counter()
    store_dir = tempfile.mkdtemp(prefix="amp_mesh_")
    world, p = SHARD_D, P
    a_res = _nccl_world_of_one(store_dir)
    driven = a_res.pop("driven_launches")
    # (b): the parent's own emulated and local answers first
    prior, prob, (s0, a, y), (s0w, aw, yw) = _shard_problems(DEV)
    checksum = float(a.double().sum())
    s0, s0w = s0.cpu().numpy(), s0w.cpu().numpy()
    em_x = _shard_engine(prior, ExactFusion(), p=p).solve(y, a).x
    em_ecsq = _shard_engine(prior, EcsqTransport(), p=p,
                            controller=FixedSchedule(SHARD_DELTAS)).solve(y, a)
    em_wide = _shard_engine(prior, ExactFusion(), p=WIDE_P,
                            col=True).solve(yw, aw)
    del a, y, aw, yw
    data, proc = _shard_service_requests()
    local_d = SolveService(policy=SHARD_DATA_POLICY).solve(
        [r for r, _ in data])
    local_p = SolveService(policy=SHARD_PROC_POLICY).solve(
        [r for r, _ in proc])
    ranks = spawn_world(sharded_rank, world, backend="gloo", device=str(DEV),
                        store_path=os.path.join(store_dir, f"w{world}"),
                        timeout_s=400)
    r0 = ranks[0]
    sv = r0["solves"]
    # ---- checks ------------------------------------------------------------
    for r in ranks:
        assert r["a_checksum"] == checksum, "a rank drew other data"
    for r in ranks[1:]:
        for name, tr in r["solves"].items():
            assert np.array_equal(tr["x"], sv[name]["x"]), name
    # every rank launches the wire's kernels on its own chunks, once a
    # round each: K4a twice, K4b-sum and K4b once an iteration, K1 once
    for rank, r in enumerate(ranks):
        for name, w in SHARD_LAUNCHES.items():
            assert r["launches"][name] == w, (rank, name, r["launches"][name])
        assert r["launches"]["ecsq_drop"] == SHARD_LAUNCHES["ecsq"], rank
    mse = lambda x, s: float(np.mean((x - s) ** 2))
    dx = float(np.abs(sv["exact"]["x"] - em_x).max())
    assert dx <= SHARD_DX, ("exact sharded != emulated", dx)
    dxw = float(np.abs(sv["wide_col_exact"]["x"] - em_wide.x).max())
    assert dxw <= SHARD_DX, ("wide column sharded != emulated", dxw)
    np.testing.assert_allclose(sv["ecsq"]["sigma2_hat"], em_ecsq.sigma2_hat,
                               rtol=0.02)
    np.testing.assert_allclose(sv["ecsq"]["extra_var"], em_ecsq.extra_var,
                               rtol=1e-6)
    m_sh, m_em = mse(sv["ecsq"]["x"], s0), mse(em_ecsq.x, s0)
    assert abs(m_sh - m_em) <= 0.05 * m_em, (m_sh, m_em)
    np.testing.assert_allclose(sv["ecsq_drop"]["extra_var"][3],
                               sv["ecsq"]["extra_var"][3] * world
                               / (world - 1), rtol=1e-5)
    lossless = mse(em_x, s0)
    ratio = {b: mse(sv[b]["x"], s0) / lossless for b in ("int8", "int4")}
    assert ratio["int8"] < SHARD_MSE_RATIO, ratio
    wire = {}
    for b in ("int8", "int4"):
        st = r0["stats"][b]
        assert set(st["bytes"]["all_to_all"]) == {"uint8"}, st
        assert set(st["bytes"]["all_gather"]) == {"uint8"}, st
        handed = {op: sum(v.values()) for op, v in st["bytes"].items()}
        per_iter = (handed["all_to_all"] * (world - 1) / world
                    + handed["all_gather"] * (world - 1)) / T
        f32_ring = 2 * (world - 1) / world * 4 * N
        wire[b] = {"bytes_per_iteration_per_rank": per_iter,
                   "float32_ring_allreduce_bytes": f32_ring,
                   "ratio": f32_ring / per_iter, "staged": st["staged"]}
    svc = r0["service"]
    data_dx, data_bits = [], []
    for got, res in zip(svc["data"], local_d):
        assert got["placement"] == "data", got["placement"]
        data_dx.append(float(np.mean((got["x"] - res.x) ** 2)))
        data_bits.append(bool(np.array_equal(got["x"], res.x)))
    assert max(data_dx) <= SHARD_DATA_MSE, data_dx
    proc_cmp = {}
    for (req, s0p), got, res in zip(proc, svc["proc"], local_p):
        assert got["placement"] == "proc" and res.bucket.placement == "local"
        if req.policy == "lossless":
            d = float(np.mean((got["x"] - res.x) ** 2))
            assert d <= SHARD_PROC_MSE, d
            np.testing.assert_allclose(got["sigma2_hat"], res.sigma2_hat,
                                       rtol=1e-3)
            proc_cmp["lossless_mean_sq_dx"] = d
        else:
            mp_, ml = mse(got["x"], s0p), mse(res.x, s0p)
            assert mp_ <= SHARD_PROC_BT * ml + 1e-8, (mp_, ml)
            assert np.isfinite(got["total_bits"])
            proc_cmp["bt_mse_over_local"] = mp_ / ml
    workers = [r["worker"] for r in ranks[1:]]
    for w in workers:
        assert w["commands"] >= 3 and w["operand_cache"]["hits"] > 0, w
    emit("sharded",
         nccl_world_of_one=a_res,
         world={"ranks": world, "backend": "gloo", "P": p,
                "devices": "cuda:0 shared",
                "max_abs_dx_exact_vs_emulated": dx,
                "wide_col_max_abs_dx_exact_vs_emulated": dxw,
                "ecsq_mse_sharded_emulated": [m_sh, m_em],
                "mse_over_lossless": ratio, "wire": wire,
                "times_by_rank": [r["times"] for r in ranks],
                "launches_by_rank": [r["launches"] for r in ranks],
                "service_data_mean_sq_dx": data_dx,
                "service_data_bit_identical": data_bits,
                "service_proc": proc_cmp,
                "service_collectives": svc["stats"],
                "service_operand_cache_rank0": svc["cache"],
                "workers": workers},
         limits={"exact_max_abs_dx": SHARD_DX,
                 "int8_mse_over_lossless": SHARD_MSE_RATIO,
                 "sigma2_over_se_realized_noise": SHARD_ENVELOPE,
                 "ecsq": "sigma2 rtol 0.02, extra rtol 1e-6, MSE 5 %",
                 "data_mean_sq_dx": SHARD_DATA_MSE,
                 "proc_lossless_mean_sq_dx": SHARD_PROC_MSE,
                 "proc_bt_mse_over_local": SHARD_PROC_BT},
         seconds=time.perf_counter() - t_phase)
    return {"launches": driven}


# ---------------------------------------------------------------------------
# the examples' twins (phase examples): repro_torch.examples on the card
# ---------------------------------------------------------------------------

# Each twin's ``run`` at its defaults (the reference example's sizes), but:
# train_lm at --scale 100m for EX_TRAIN_STEPS steps with a checkpoint every
# EX_TRAIN_CKPT_EVERY (the CLI's 150 steps and 50); mp_amp_cluster's part 2
# on EX_RANKS gloo ranks sharing the card (the reference's 8 emulated
# devices), its problem drawn here from part 2's seed on the card and handed
# to it, so that a centralized solve of the same problem stands beside it.
# wire_demo runs at its defaults and with --smoke. The gates are the ones
# this script holds at the paper's point: lossless == centralized within
# EX_DX, BT (and DP) within EX_SDR_DB of lossless, int8 MSE under
# EX_INT8_RATIO x exact; wire_demo's rANS never under the empirical
# entropy, and the smoke run's inequalities on every coded iteration;
# train_lm's loss finite and lower at the last step than at the first.
# Each twin's launches by kernel are read just after it and held to the
# counts worked out from the code (``_service_launches`` for the served
# ones); each kernel it reached is then held against its plain version on
# the inputs it was given (captured at its first calls of each shape: in
# this process for the twins, in each rank for part 2), and
# compressed_psum's forms at part 2's chunks (EX_WIRE_CASES). The twins run
# one after another in this process, part 2's ranks after them, so that no
# twin's wall time is read beside the ranks' start
EX_TRAIN_SCALE, EX_TRAIN_STEPS, EX_TRAIN_CKPT_EVERY = "100m", 8, 4
EX_RANKS = 8
EX_DX, EX_SDR_DB, EX_INT8_RATIO = 1e-4, 0.5, 1.3
# part 2's compressed_psum over 8 ranks: N = 4000 padded to a multiple of
# 8 x 2 x 512, chunks of 1024 a rank; K4a on (8, 1024) and the reduced
# (1, 1024), K4b-sum on the received (8, 1024), K4b on the gathered (8, 1024)
EX_WIRE_CASES = [("cluster_D8", 8, 1024), ("cluster_D8_reduced", 1, 1024)]
EX_KERNELS = ("amp_local", "col_residual", "col_inner", "quantize_blocks",
              "dequantize_blocks", "dequantize_sum", "quantize_blocks_packed",
              "dequantize_blocks_packed", "dequantize_sum_packed")


def _service_launches(served) -> collections.Counter:
    """The launches a service's batch must make, from ``served``: (bucket,
    policy, T) of each request (no erasure, no measured wire). A row
    bucket launches K1 once an iteration of its T_max (a lone lossless or
    fixed request takes the singleton path: once an iteration of its own
    T); a column bucket K2 and K3 (one inner iteration) once a round of its
    T_max."""
    want = collections.Counter()
    buckets = collections.defaultdict(list)
    for bucket, policy, t in served:
        buckets[bucket].append((policy, t))
    for key, members in buckets.items():
        if key.layout == "row":
            lone = len(members) == 1 and members[0][0] != "bt"
            want["amp_local"] += members[0][1] if lone else key.t_max
        else:
            want["col_residual"] += key.t_max
            want["col_inner"] += key.t_max
    return want


def _ex_counted(fn):
    """``fn()`` with every count set to 0 just before it; its result, its
    wall seconds and its launches (the kernels it launched) read just
    after."""
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {
        key: v for key, v in all_counts().items() if v}


def run_examples(device: str = "cuda") -> dict:
    """Phase ``examples``: the six twins of ``examples/*.py`` on ``device``
    (the card; the block comment above). Every check is read before the
    phase's line
    is printed, and the phase fails after it if any failed. Returns the
    twins' launches by kernel and the largest error of each kernel against
    its plain version at their shapes."""
    import shutil
    import tempfile
    from repro_torch.examples import (mp_amp_cluster, observe, quickstart,
                                      serve_mixed, train_lm, wire_demo)
    t_phase = time.perf_counter()
    failed, twins = [], {}

    def check(ok, what, *detail):
        if not ok:
            failed.append([what, *detail])

    def launches_agree(name, got, want):
        want = {key: v for key, v in want.items() if v}
        check(got == want, f"{name} launches", got, want)

    with captured_inputs() as seen:
        # quickstart: centralized, lossless and BT, K1 once an iteration
        r, wall, got = _ex_counted(lambda: quickstart.run(device))
        t = r["n_iter"]
        launches_agree("quickstart", got, {"amp_local": 3 * t})
        check(r["max_dx_lossless"] <= EX_DX, "quickstart lossless",
              r["max_dx_lossless"])
        check(r["sdr_lossless"] - r["sdr_bt"] < EX_SDR_DB, "quickstart BT",
              r["sdr_lossless"], r["sdr_bt"])
        check(all(np.isfinite(v).all() for v in r["x"].values()),
              "quickstart finite")
        twins["quickstart"] = {
            "wall_s": wall, "launches": got,
            **{key: r[key] for key in (
                "sdr_centralized", "sdr_lossless", "max_dx_lossless",
                "sdr_bt", "bits_bt", "saved_pct", "rates_bt")}}

        # serve_mixed: five requests, four buckets (two row, two column)
        r, wall, got = _ex_counted(lambda: serve_mixed.run(device))
        launches_agree("serve_mixed", got, _service_launches(
            (row["bucket"], row["policy"], row["spec"][5])
            for row in r["requests"]))
        check(r["n_buckets"] == 4, "serve_mixed bucket count",
              r["n_buckets"])
        check(all(np.isfinite(row["x"]).all() and np.isfinite(row["sdr"])
                  for row in r["requests"]), "serve_mixed finite")
        twins["serve_mixed"] = {
            "wall_s": wall, "launches": got, "n_buckets": r["n_buckets"],
            "requests": [{"policy": row["policy"], "sdr": row["sdr"],
                          "bits": row["bits"],
                          "bucket": row["bucket_label"]}
                         for row in r["requests"]]}

        # observe: three lossless requests, the middle one's SNR a lie
        r, wall, got = _ex_counted(lambda: observe.run(device))
        launches_agree("observe", got, _service_launches(
            (row["bucket"], "lossless", row["spec"][6])
            for row in r["requests"]))
        alerts = [row["alert"] for row in r["requests"]]
        check(alerts == [False, True, False], "observe drift alert",
              [row["drift"] for row in r["requests"]])
        check(all(row["tree"][0] == "admit"
                  and row["tree"][-1] == "complete"
                  for row in r["requests"]), "observe span trees",
              [row["tree"] for row in r["requests"]])
        twins["observe"] = {
            "wall_s": wall, "launches": got,
            "drift": [row["drift"] for row in r["requests"]],
            "alert": [row["alert"] for row in r["requests"]],
            "trees": [row["tree"] for row in r["requests"]],
            "spans_ms": [row["spans_ms"] for row in r["requests"]],
            "latency_p95_s": r["latency_p95_s"],
            "prometheus_lines": len(r["prometheus"])}

        # wire_demo: the BT solve at its defaults, and --smoke
        for tag, smoke in (("wire_demo", False),
                           ("wire_demo_smoke", True)):
            r, wall, got = _ex_counted(
                lambda: wire_demo.run(device, smoke))
            launches_agree(tag, got, {"amp_local": r["n_iter"]})
            coded = [row for row in r["rows"] if "rans" in row]
            check(r["roundtrip_checked"] and r["total_rans"] > 0
                  and all(row["rans"] >= row["h_emp"] - 1e-6
                          for row in coded), f"{tag} rANS", coded)
            # the reference's smoke inequality on the coder's overhead
            # (its --smoke problem only: at N = 2000 its few bytes a
            # processor need not fit under 0.1 + 512 / N bits)
            check(not smoke or all(
                row["rans"] <= row["h_emp"] + 0.1 + 64.0 * 8 / r["n"]
                for row in coded), f"{tag} smoke inequalities", coded)
            twins[tag] = {
                "wall_s": wall, "launches": got,
                "final_mse": r["final_mse"],
                "rows": coded, "total_h_q": r["total_h_q"],
                "total_emp": r["total_emp"], "total_rans": r["total_rans"],
                "total_int8": r["total_int8"]}

        # mp_amp_cluster part 1: the paper's point, centralized, BT and DP
        r, wall, got = _ex_counted(lambda: mp_amp_cluster.part1(device))
        launches_agree("mp_amp_cluster part 1", got,
                       {"amp_local": 3 * r["n_iter"]})
        for key in ("bt", "dp"):
            check(r["sdr_centralized"] - r[f"sdr_{key}"] < EX_SDR_DB,
                  f"part 1 {key}", r["sdr_centralized"], r[f"sdr_{key}"])
        twins["mp_amp_cluster_part1"] = {
            "wall_s": wall, "launches": got,
            **{key: r[key] for key in (
                "sdr_centralized", "sdr_bt", "bits_bt", "sdr_dp",
                "bits_dp", "paper_bits")},
            "note": "the paper's bits are printed, not gated (ROADMAP.md "
                    "Queue 3: the tier-2 golden is stale)"}

    # train_lm: --scale 100m, EX_TRAIN_STEPS steps, a checkpoint every
    # EX_TRAIN_CKPT_EVERY; no kernel of the port's: a dense decoder's train
    # step
    ckpt = tempfile.mkdtemp(prefix="amp_train_lm_")
    try:
        r, wall, got = _ex_counted(lambda: train_lm.run(
            device, steps=EX_TRAIN_STEPS, scale=EX_TRAIN_SCALE, ckpt=ckpt,
            ckpt_every=EX_TRAIN_CKPT_EVERY))
        saved = sorted(os.listdir(ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches_agree("train_lm", got, {})
    check(len(r["losses"]) == EX_TRAIN_STEPS
          and all(np.isfinite(r["losses"]))
          and r["losses"][-1] < r["losses"][0], "train_lm loss falls",
          r["losses"])
    check(len(saved) >= 2, "train_lm checkpoints", saved)
    twins["train_lm"] = {
        "wall_s": wall, "launches": got, "scale": EX_TRAIN_SCALE,
        "steps": EX_TRAIN_STEPS, "n_params": r["n_params"],
        "losses": r["losses"], "first10": r["first10"],
        "last10": r["last10"], "improvement": r["improvement"],
        "checkpoints": saved}

    # mp_amp_cluster part 2: EX_RANKS gloo ranks sharing the card, each
    # counting its launches from 0 at its start and holding K1 against its
    # plain version at its row shard's shape (after its solves)
    prior2 = BernoulliGauss(eps=mp_amp_cluster.EPS2)
    prob2 = CSProblem(n=mp_amp_cluster.N2, m=mp_amp_cluster.M2, prior=prior2)
    s0_2, a_2, y_2 = sample_problem(1, prob2.n, prob2.m, prior2,
                                    prob2.sigma_e2, device=device)
    t0 = time.perf_counter()
    r2 = mp_amp_cluster.part2(device, EX_RANKS, problem=(s0_2, a_2, y_2),
                              check_kernels=True)
    wall = time.perf_counter() - t0
    t2 = r2["n_iter"]
    rank_want = {"amp_local": 4 * t2, "quantize_blocks": 2 * 2 * t2,
                 "dequantize_sum": 2 * t2, "dequantize_blocks": 2 * t2,
                 "quantize_blocks_packed": 2 * t2,
                 "dequantize_sum_packed": t2,
                 "dequantize_blocks_packed": t2}
    part2_launches = collections.Counter()
    for i, rank in enumerate(r2["launches"]):
        rank = {key: v for key, v in rank.items() if v}
        launches_agree(f"part 2 rank {i}", rank, rank_want)
        part2_launches.update(rank)
    cen2 = amp_solve(y_2, a_2, prior2, t2, s0=s0_2.cpu().numpy(),
                     device=device)
    rows = {row["label"].strip(): row for row in r2["rows"]}
    dx2 = float(np.abs(rows["exact fusion"]["x"] - cen2.x).max())
    check(dx2 <= EX_DX, "part 2 exact == centralized", dx2)
    ratio = rows["int8 compressed psum"]["mse"] / rows["exact fusion"]["mse"]
    check(ratio < EX_INT8_RATIO, "part 2 int8 MSE", ratio)
    check(all(row["ranks_agree"] for row in r2["rows"]), "part 2 ranks agree")
    twins["mp_amp_cluster_part2"] = {
        "wall_s": wall, "ranks": r2["ranks"], "rank_launches": rank_want,
        "max_abs_dx_exact_vs_centralized": dx2, "int8_mse_over_exact": ratio,
        "start_seconds": r2["start_seconds"],
        "rows": [{key: row[key] for key in ("label", "sdr", "wire",
                                             "noise_var", "seconds")}
                 for row in r2["rows"]]}
    del a_2, y_2, cen2

    _free()

    # every kernel the twins reached, against its plain version on the
    # inputs it was given; compressed_psum's forms at part 2's chunks
    t_checks = time.perf_counter()
    kernel_rows = check_captured(seen)
    del seen
    for row in kernel_rows:
        row["where"] = "twins"
    # part 2's K1 at a rank's row shard, checked in each rank
    for i, rank in enumerate(r2["kernel_checks"]):
        check(any(row["kernel"] == "amp_local" for row in rank),
              f"part 2 rank {i} K1 checked", rank)
        kernel_rows += [{**row, "where": f"part 2 rank {i}"} for row in rank]
    for row in kernel_rows:
        check(all(v <= KERNEL_RTOL for key_, v in row.items()
                  if key_.endswith("rel_err")), "kernel against plain", row)
    wire = check_wire_kernels(EX_WIRE_CASES, "kernel_check_wire_examples")
    max_err = collections.defaultdict(float)
    for row in kernel_rows:
        max_err[row["kernel"]] = max(
            max_err[row["kernel"]],
            *(v for key_, v in row.items() if key_.endswith("max_abs_err")))
    wire_err = max(row["max_abs_err"] for row in wire.values())
    for name in EX_KERNELS[3:]:
        max_err[name] = wire_err
    launches = collections.Counter(part2_launches)
    for twin in twins.values():
        launches.update(twin.get("launches", {}))
    emit("examples", card=nvidia_smi_line(),
         note="gloo ranks sharing one card in part 2: oversubscription, "
              "not scaling",
         reduced={"train_lm": f"--steps 150 -> {EX_TRAIN_STEPS}, "
                              f"checkpoints every {EX_TRAIN_CKPT_EVERY}"},
         failed=failed, twins=twins, wall_s={
             key: v["wall_s"] for key, v in twins.items()},
         launches=dict(launches),
         kernels_at_twin_shapes=kernel_rows,
         limits={"lossless_max_abs_dx": EX_DX, "sdr_db_below": EX_SDR_DB,
                 "int8_mse_over_exact": EX_INT8_RATIO,
                 "kernel_rel_err": KERNEL_RTOL, "k4": "bit-identical"},
         seconds_kernel_checks=time.perf_counter() - t_checks,
         seconds=time.perf_counter() - t_phase)
    assert not failed, failed
    return {"launches": dict(launches), "max_abs_err": dict(max_err)}


def add_examples_launches(kernels: list, ex_ctx) -> None:
    """Each K1, K2, K3 and K4-wire row of the kernels line also carries its
    launches on the examples phase's paths (every twin, part 2's ranks
    summed) and its largest error against its plain version at the twins'
    shapes."""
    for row in kernels:
        if row["name"] in EX_KERNELS:
            row["examples_launches"] = ex_ctx["launches"].get(row["name"], 0)
            row["examples_max_abs_err"] = ex_ctx["max_abs_err"].get(
                row["name"])


# ---------------------------------------------------------------------------
# LM training (phase train)
# ---------------------------------------------------------------------------

# (a) gemma3-1b at its published width and depth, train_4k's sequence of
# 4096, the global batch cut from 256 to 8 in 4 microbatches of 2 x 4096
# tokens; 2 steps with int8 pod fusion and 2 exact (cut from 4 for
# tp_zoo's time), from one init (SEED) on the same data, on an NCCL world of
# one (pod=1, data=1, model=1)
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB = "gemma3-1b", 4096, 8, 4
TRAIN_STEPS = 2
TRAIN_REDUCED = {"global_batch": "256 -> 8 (microbatches 4 of 2 rows)",
                 "mesh": "(pod, data, model) = (1, 1, 1)",
                 "steps": TRAIN_STEPS}
TRAIN_INT8_GAP = 0.05     # |int8 - exact| loss at the last step
# compressed_psum on each of gemma3-1b's 13 gradient leaves a step: K4a in
# both phases, K4b-sum in phase 1, K4b in phase 2
TRAIN_LEAVES = 13
TRAIN_K4 = {"quantize_blocks": 2 * TRAIN_LEAVES,
            "dequantize_sum": TRAIN_LEAVES,
            "dequantize_blocks": TRAIN_LEAVES}
# (b) K4 at the gradients' sizes: compressed_psum's chunk over a world of
# one is the whole leaf, padded to a multiple of 1024: gemma3-1b's
# embed/table (262144 x 1152) and the three leaves of 26 x 1152 x 6912
# (layers/w_gate, w_up, w_down)
TRAIN_K4_SHAPES = [("embed_table", 262144 * 1152),
                   ("layers_mlp", 26 * 1152 * 6912)]
# (c) two gloo ranks sharing the card, (pod=2, data=1, model=1): the
# reference's red test_compressed_gradient_training_converges, its config
# (granite-3-8b smoke, seq 32, batch 8, lr 2e-3, 12 steps) and bounds
CONV_ARCH, CONV_SEQ, CONV_BATCH, CONV_STEPS, CONV_LR = (
    "granite-3-8b", 32, 8, 12, 2e-3)
CONV_DROP, CONV_GAP = 0.3, 0.5
# (d) the Trainer on the card: granite-3-8b smoke, preempted at step 8 and
# resumed from its step-5 checkpoint (the reference's tests/test_trainer.py)
TRAINER_STEPS, TRAINER_FAIL = 12, 8


def _train_runs(mesh, cfg, shape, tcfgs: dict, steps: int, seed: int,
                guard: str | None = None) -> dict:
    """``steps`` steps of each config of ``tcfgs`` from the same init and
    data: losses, CUDA-event step times, each step's launches, the peak
    device memory; ``guard`` names the config whose first step runs under
    the sync debug mode "warn" (every site recorded) and its later steps
    under "error"."""
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch,
                           seed=seed)
    batches = [data.global_arrays(i, mesh) for i in range(steps)]
    out = {}
    for name, tcfg in tcfgs.items():
        step = build_train_step(cfg, mesh, shape, tcfg)
        params = step.init_params(seed)
        opt = step.init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = {"loss": [], "grad_norm": [], "quant_noise": [], "ms": [],
               "launches": [], "sync_sites": []}
        for i, (tok, lab) in enumerate(batches):
            reset_all_counts()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            if name == guard and i == 0:
                box = {"args": (params, opt, tok, lab)}

                def one():
                    box["out"] = step(*box.pop("args"), donate=True)
                    return box["out"][2]["loss"], None
                e0.record()
                run["sync_sites"] = sync_sites(one)
                e1.record()
                # nothing may keep a step's state alive past its successor
                params, opt, m = box.pop("out")
                del one, box
            elif name == guard:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    e0.record()
                    params, opt, m = step(params, opt, tok, lab,
                                          donate=True)
                    e1.record()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                e0.record()
                params, opt, m = step(params, opt, tok, lab, donate=True)
                e1.record()
            e1.synchronize()
            run["ms"].append(e0.elapsed_time(e1))
            run["launches"].append({k: v for k, v in all_counts().items()
                                    if v})
            for key in ("loss", "grad_norm", "quant_noise"):
                run[key].append(float(m[key]))
        run["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[name] = run
        del step, params, opt, m
        _free()
    return out


def _train_world_of_one(store_dir: str) -> dict:
    """Phase (a): gemma3-1b on an NCCL world of one, in this process."""
    import torch.distributed as dist
    init_cluster(num_processes=1, process_id=0, backend="nccl",
                 store_path=os.path.join(store_dir, "nccl_train"),
                 device=str(DEV))
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                         device=str(DEV))
        cfg = get_config(TRAIN_ARCH)
        shape = ShapeSpec("train_4k_cut", TRAIN_SEQ, TRAIN_BATCH, "train")
        with k4_calls_by_shape() as by_shape:
            runs = _train_runs(mesh, cfg, shape, {
                "int8": TrainStepConfig(microbatches=TRAIN_MB,
                                        compression_bits=8),
                "exact": TrainStepConfig(microbatches=TRAIN_MB)},
                TRAIN_STEPS, SEED, guard="int8")
    finally:
        dist.destroy_process_group()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for name, run in runs.items():
        assert all(np.isfinite(run["loss"])), (name, run["loss"])
        steady = statistics.median(run["ms"][1:])
        run["steady_step_ms"] = steady
        run["tokens_per_s"] = tokens / (steady / 1e3)
        want = TRAIN_K4 if name == "int8" else {}
        for i, got in enumerate(run["launches"]):
            k4 = {k: got.get(k, 0) for k in TRAIN_K4}
            assert {k: v for k, v in k4.items() if v} == want, (name, i, got)
    sites = runs["int8"]["sync_sites"]
    assert not sites, ("host syncs inside the train step", sites)
    gap = abs(runs["int8"]["loss"][-1] - runs["exact"]["loss"][-1])
    assert gap < TRAIN_INT8_GAP, (runs["int8"]["loss"], runs["exact"]["loss"])
    # the fused gradients are the compressed ones: from step 2 on, the int8
    # run's loss is not the exact run's
    assert all(a != b for a, b in zip(runs["int8"]["loss"][1:],
                                      runs["exact"]["loss"][1:])), \
        (runs["int8"]["loss"], runs["exact"]["loss"])
    assert all(v > 0 for v in runs["int8"]["quant_noise"])
    launches = {k: sum(r.get(k, 0) for r in runs["int8"]["launches"])
                for k in TRAIN_K4}
    for k in TRAIN_K4:
        assert sum(v for (form, _), v in by_shape.items() if form == k) \
            == launches[k], (k, dict(by_shape), launches)
    return {"runs": runs, "int8_exact_gap_last_step": gap,
            "k4_launches_per_step": {k: v for k, v in
                                     runs["int8"]["launches"][0].items()
                                     if k in TRAIN_K4},
            "k4_launches": launches,
            "k4_launches_by_shape": {f"{form} {key}": v for (form, key), v
                                     in sorted(by_shape.items())}}


def k4_shape_key(r: int, n: int) -> str:
    return f"R{r} N{n}"


@contextlib.contextmanager
def k4_calls_by_shape():
    """Counts the calls of K4a, K4b and K4b's sum by (form, ``k4_shape_key``)
    while the block runs: the dispatch's bindings of the wrappers are
    wrapped; nothing is read from the card."""
    tally = collections.Counter()
    wrappers = {"quantize_cuda": qops.quantize_cuda,
                "dequantize_cuda": qops.dequantize_cuda,
                "dequantize_sum_cuda": qops.dequantize_sum_cuda}

    def quantize(x, qmax, block, packed=False):
        form = "quantize_blocks" + ("_packed" if packed else "")
        tally[form, k4_shape_key(*x.shape)] += 1
        return wrappers["quantize_cuda"](x, qmax, block, packed)

    def dequantize(q, scale, block, packed=False, n=None):
        width = (2 * q.shape[1] if packed else q.shape[1]) if n is None else n
        form = "dequantize_blocks" + ("_packed" if packed else "")
        tally[form, k4_shape_key(q.shape[0], width)] += 1
        return wrappers["dequantize_cuda"](q, scale, block, packed, n)

    def dequantize_sum(q, scale, block, packed=False, c=None):
        width = (2 * q.shape[1] if packed else q.shape[1]) if c is None else c
        form = "dequantize_sum" + ("_packed" if packed else "")
        tally[form, k4_shape_key(q.shape[0], width)] += 1
        return wrappers["dequantize_sum_cuda"](q, scale, block, packed, c)

    qops.quantize_cuda, qops.dequantize_cuda, qops.dequantize_sum_cuda = (
        quantize, dequantize, dequantize_sum)
    try:
        yield tally
    finally:
        for name, fn in wrappers.items():
            setattr(qops, name, fn)


def grad_inputs(n: int, seed: int) -> torch.Tensor:
    """A gradient-like row (1, n): normal values scaled per 4096 elements
    by 10^u, u uniform in [-4, 0], so the scale blocks span four decades."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(1, n, generator=g, device=DEV)
    seg = -(-n // 4096)
    scale = 10.0 ** (-4.0 * torch.rand(seg, generator=g, device=DEV))
    x.mul_(scale.repeat_interleave(4096)[None, :n])
    return x


def check_train_k4() -> dict:
    """K4a, K4b-sum and K4b, int8 and packed int4, at the gradient chunks
    ``TRAIN_K4_SHAPES``: bit for bit with their plain versions (symbols,
    scale bits, values), and timed against their byte bounds. Only the
    int8 forms run at these shapes on a path (gemma3-1b's int8 steps), so
    only they become kernels-line rows (``train_kernel_rows``)."""
    rows, times = [], {}
    for name, n in TRAIN_K4_SHAPES:
        x = grad_inputs(n, SEED + 7)
        q8, s8 = kq.quantize_cuda(x, 127, 512)
        d8 = kq.dequantize_cuda(q8, s8, 512)
        sum8 = kq.dequantize_sum_cuda(q8, s8, 512)
        pk, sk = kq.quantize_cuda(x, 7, 512, packed=True)
        dk = kq.dequantize_cuda(pk, sk, 512, packed=True, n=n)
        sum4 = kq.dequantize_sum_cuda(pk, sk, 512, packed=True, c=n)
        torch.cuda.synchronize()
        q8r, s8r = qops.quantize_plain(x, 127, 512)
        pr, sr = qops.quantize_plain(x, 7, 512, packed=True)
        row = {"shape": name, "R": 1, "N": n,
               "int8_q_identical": bool(torch.equal(q8, q8r)),
               "int8_scale_bits_identical": bool(torch.equal(
                   s8.view(torch.int16), s8r.view(torch.int16))),
               "packed_identical": bool(torch.equal(pk, pr)),
               "packed_scale_bits_identical": bool(torch.equal(
                   sk.view(torch.int16), sr.view(torch.int16)))}
        del x
        errs = {}
        for key, got, want in (
                ("int8_dequantized", d8, qops.dequantize_plain(q8r, s8r, 512)),
                ("sum_int8", sum8, qops.dequantize_sum_plain(q8r, s8r, 512)),
                ("unpacked_dequantized", dk,
                 qops.dequantize_plain(pr, sr, 512, packed=True, n=n)),
                ("sum_packed", sum4,
                 qops.dequantize_sum_plain(pr, sr, 512, packed=True, c=n))):
            row[f"{key}_identical"] = bool(torch.equal(got, want))
            errs[key] = float((got - want).abs().max())
            del want
        row["max_abs_err"] = max(errs.values())
        rows.append(row)
        assert all(v for key, v in row.items() if key.endswith("identical")), \
            row
        del d8, sum8, dk, sum4, q8r, s8r, pr, sr
        _free()
        x = grad_inputs(n, SEED + 7)
        calls = {
            "quantize_blocks": {
                "ms": lambda: kq.quantize_cuda(x, 127, 512),
                "plain_ms": lambda: qops.quantize_plain(x, 127, 512)},
            "dequantize_blocks": {
                "ms": lambda: kq.dequantize_cuda(q8, s8, 512),
                "plain_ms": lambda: qops.dequantize_plain(q8, s8, 512)},
            "dequantize_sum": {
                "ms": lambda: kq.dequantize_sum_cuda(q8, s8, 512),
                "plain_ms": lambda: qops.dequantize_sum_plain(q8, s8, 512)},
            "quantize_blocks_packed": {
                "ms": lambda: kq.quantize_cuda(x, 7, 512, packed=True),
                "plain_ms": lambda: qops.quantize_plain(x, 7, 512,
                                                        packed=True)},
            "dequantize_blocks_packed": {
                "ms": lambda: kq.dequantize_cuda(pk, sk, 512, packed=True,
                                                 n=n),
                "plain_ms": lambda: qops.dequantize_plain(pk, sk, 512,
                                                          packed=True, n=n)},
            "dequantize_sum_packed": {
                "ms": lambda: kq.dequantize_sum_cuda(pk, sk, 512,
                                                     packed=True, c=n),
                "plain_ms": lambda: qops.dequantize_sum_plain(
                    pk, sk, 512, packed=True, c=n)},
        }
        times[name] = _time_calls(calls, {**quant_bounds(1, n, 512),
                                          **wire_bounds(1, n, 512)})
        del x, q8, s8, pk, sk, calls
        _free()
    emit("kernel_check_train_k4", limit="bit-identical", cases=rows)
    return {"errs": {r["shape"]: r for r in rows}, "times": times}


def train_rank(mesh) -> dict:
    """One rank of (c)'s world of two gloo ranks sharing the card: the
    reference red's runs (exact, int8; and int4) on (pod=2, data=1,
    model=1), each rank's losses, the pod axis's collectives and the
    launches of each run."""
    grid = make_mesh((2, 1, 1), ("pod", "data", "model"),
                     device=str(mesh.device))
    cfg = get_config(CONV_ARCH).smoke_config()
    shape = ShapeSpec("conv", CONV_SEQ, CONV_BATCH, "train")
    data = SyntheticLMData(cfg.vocab, CONV_SEQ, CONV_BATCH, seed=1)
    out = {}
    for name, bits in (("exact", None), ("int8", 8), ("int4", 4)):
        step = build_train_step(cfg, grid, shape, TrainStepConfig(
            compression_bits=bits, adamw=AdamWConfig(lr=CONV_LR)))
        params = step.init_params(0)
        opt = step.init_opt_state(params)
        grid.axis("pod").stats.reset()
        reset_all_counts()
        losses = []
        for i in range(CONV_STEPS):
            tok, lab = data.global_arrays(i, grid)
            params, opt, m = step(params, opt, tok, lab, donate=True)
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses,
                     "pod": grid.axis("pod").stats.snapshot(),
                     "launches": {k: v for k, v in all_counts().items()
                                  if v}}
    return out


def _trainer_on_card(tmp: str) -> dict:
    """Phase (d): the Trainer on the card, an uninterrupted run against one
    preempted at step 8 and resumed from its step-5 checkpoint."""
    cfg = get_config(CONV_ARCH).smoke_config()
    shape = ShapeSpec("tiny", 32, 4, "train")
    mesh = make_host_mesh(model=1, device=str(DEV))

    def trainer(path, **kw):
        return Trainer(cfg, shape, mesh, TrainerConfig(
            total_steps=TRAINER_STEPS, ckpt_every=5, log_every=0,
            ckpt_dir=os.path.join(tmp, path),
            step_cfg=TrainStepConfig(microbatches=2), **kw))

    _, _, full = trainer("full").run(resume=False)
    try:
        trainer("resumed", fail_at_step=TRAINER_FAIL).run(resume=False)
        raise AssertionError("the preempted run was not preempted")
    except RuntimeError as e:
        assert "simulated preemption" in str(e), e
    _, _, resumed = trainer("resumed").run(resume=True)
    assert resumed[0]["step"] == 5, resumed[0]
    by_step = {h["step"]: h for h in full}
    same = [h["loss"] == by_step[h["step"]]["loss"]
            and h["grad_norm"] == by_step[h["step"]]["grad_norm"]
            for h in resumed]
    assert all(same), (full, resumed)
    first = np.mean([h["loss"] for h in full[:3]])
    last = np.mean([h["loss"] for h in full[-3:]])
    assert last < first, (first, last)
    return {"full_losses": [h["loss"] for h in full],
            "resumed_losses": [h["loss"] for h in resumed],
            "resumed_from_step": resumed[0]["step"],
            "bit_identical": all(same)}


def run_train() -> dict:
    """Phase ``train``: (a) gemma3-1b at full width and depth, int8 and
    exact; (b) K4 at the gradients' sizes; (c) the reference red's runs on
    two gloo ranks sharing the card; (d) the Trainer preempted and resumed.
    The kernels are built before the spawn."""
    import tempfile
    t_phase = time.perf_counter()
    store_dir = tempfile.mkdtemp(prefix="amp_train_")
    a = _train_world_of_one(store_dir)
    b = check_train_k4()
    ranks = spawn_world(train_rank, 2, backend="gloo", device=str(DEV),
                        store_path=os.path.join(store_dir, "conv2"),
                        timeout_s=400)
    for r in ranks[1:]:
        for name in r:
            assert r[name]["losses"] == ranks[0][name]["losses"], name
    conv = ranks[0]
    for name in ("exact", "int8"):
        l = conv[name]["losses"]
        assert l[-1] < l[0] - CONV_DROP, (name, l)
    gap = abs(conv["int8"]["losses"][-1] - conv["exact"]["losses"][-1])
    assert gap < CONV_GAP, (conv["exact"]["losses"], conv["int8"]["losses"])
    for name in ("int8", "int4"):
        pod = conv[name]["pod"]["bytes"]
        assert set(pod["all_to_all"]) == {"uint8"}, pod
        assert set(pod["all_gather"]) == {"uint8"}, pod
    assert "all_to_all" not in conv["exact"]["pod"]["bytes"]
    d = _trainer_on_card(store_dir)
    emit("train", card=nvidia_smi_line(), arch=TRAIN_ARCH,
         seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
         microbatches=TRAIN_MB, reduced=TRAIN_REDUCED,
         world_of_one=a,
         k4_at_gradient_sizes=b["times"],
         two_gloo_ranks={"arch": CONV_ARCH + " smoke", "seq": CONV_SEQ,
                         "batch": CONV_BATCH, "lr": CONV_LR,
                         "losses": {n: conv[n]["losses"] for n in conv},
                         "pod_collectives": {n: conv[n]["pod"]
                                             for n in conv},
                         "launches": {n: conv[n]["launches"] for n in conv},
                         "int8_exact_gap_last_step": gap},
         trainer=d,
         limits={"int8_exact_gap_last_step": TRAIN_INT8_GAP,
                 "k4_launches_per_int8_step": TRAIN_K4,
                 "two_ranks_drop": CONV_DROP, "two_ranks_gap": CONV_GAP,
                 "k4": "bit-identical", "trainer": "bit-identical"},
         seconds=time.perf_counter() - t_phase)
    return {"k4": b, "launches_by_shape": a["k4_launches_by_shape"]}


def train_kernel_rows(train_ctx) -> list:
    """The kernels line's rows of K4 at the gradients' sizes: each int8
    form timed at each TRAIN_K4_SHAPES chunk, with the launches at that
    shape in gemma3-1b's 4 int8 steps (counts set to 0 just before the
    run). The packed forms, which no path runs at these shapes, stay in the
    ``train`` line's ``k4_at_gradient_sizes``."""
    rows, sizes = [], dict(TRAIN_K4_SHAPES)
    for shape, times in train_ctx["k4"]["times"].items():
        err = train_ctx["k4"]["errs"][shape]["max_abs_err"]
        for name, tm in times.items():
            if name.endswith("_packed"):
                continue
            launches = train_ctx["launches_by_shape"].get(
                f"{name} {k4_shape_key(1, sizes[shape])}", 0)
            assert launches > 0, (name, shape)
            rows.append({
                "name": f"{name}/train_{shape}", "route": "cuda",
                "source": SOURCES[name], "replaces": REPLACES[name],
                "launches": launches, "max_abs_err": err, "ms": tm["ms"],
                "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                "bound_by": tm["bound_by"], "library_ms": tm["library_ms"]})
    return rows


# ---------------------------------------------------------------------------
# LM training of the other families (phase train_zoo)
# ---------------------------------------------------------------------------

# (a) K6's backward (kernels/wkv6/wkv6.py::wkv6_bwd_cuda) against autograd
# of its plain forward (wkv_chunked) on the card: name, B, T, H, Dh, dtype
# of r/k/v, state0 given, dS_T given, NV (value slices, a cluster's blocks:
# None for the plan's). The first is rwkv6-3b's training shape (a
# microbatch of 2 x 4096, 40 heads of 64; no state, and the final state
# takes no part in the loss), the one the path gives the kernel. The last
# nine force each NV the kernel takes at Dh 64, 32 and 16 (every one runs:
# the build records the card's clusters of each), on ragged lengths with
# a state and a dS_T.
WKV_BWD_CASES = [
    ("rwkv6_3b_train", 2, 4096, 40, 64, torch.bfloat16, False, False, None),
    ("ragged_T1000_dS", 2, 1000, 8, 64, torch.bfloat16, False, True, None),
    ("state0_T70_f32_dS", 2, 70, 3, 64, torch.float32, True, True, None),
    ("no_state0_T45_f32", 1, 45, 2, 64, torch.float32, False, False, None),
    ("dh32_T100_state0", 2, 100, 4, 32, torch.bfloat16, True, False, None),
    ("smoke_dh16_T45_dS", 2, 45, 4, 16, torch.bfloat16, True, True, None),
    ("dh64_nv1_T333_s0_dS", 2, 333, 5, 64, torch.bfloat16, True, True, 1),
    ("dh64_nv2_T333_s0_dS", 2, 333, 5, 64, torch.bfloat16, True, True, 2),
    ("dh64_nv4_T1000_f32_dS", 1, 1000, 6, 64, torch.float32, False, True, 4),
    ("dh64_nv8_T517_s0", 2, 517, 3, 64, torch.bfloat16, True, False, 8),
    ("dh32_nv1_T517_s0_dS", 1, 517, 6, 32, torch.bfloat16, True, True, 1),
    ("dh32_nv2_T517_s0_dS", 1, 517, 6, 32, torch.bfloat16, True, True, 2),
    ("dh32_nv4_T45_f32_s0_dS", 2, 45, 4, 32, torch.float32, True, True, 4),
    ("dh16_nv1_T260_f32_s0_dS", 2, 260, 4, 16, torch.float32, True, True, 1),
    ("dh16_nv2_T260_s0_dS", 2, 260, 4, 16, torch.bfloat16, True, True, 2),
]
WKV_BWD_PATH = "rwkv6_3b_train"
# Each gradient within WKV_BWD_RTOL of its largest magnitude, and a bf16
# one (dr, dk, dv of bf16 inputs: the kernel rounds its float32 sums once)
# within one bf16 rounding (2^-8 of the element) beyond that. Both sides sum
# in float32 with factors up to e^{+-64} (log-decay clamped at -2 over 32
# steps), in other orders, and carry the adjoint and dlogw's running sum
# over T / 32 chunks: on the CPU the chunked form's gradient parts from the
# float64 step-by-step adjoint by 7e-7 of its scale at T <= 100
# (tests/test_torch_wkv6_grad.py); 1e-4 leaves room for 4096 steps.
WKV_BWD_RTOL = 1e-4
# (b) rwkv6-3b at its published width and depth (32 layers, d 2560, 40 heads
# of 64, d_ff 8960, vocab 65536), train_4k's sequence of 4096, the global
# batch cut from 256 to 8 in 4 microbatches of 2 x 4096; TZ_STEPS steps
# exact and TZ_STEPS with int8 pod fusion from one init (SEED) on the same
# data, on an NCCL world of one (pod=1, data=1, model=1), the donated
# (in-place) step. At this width AdamW's first step raises the loss, in the
# reference as in the port (a CPU run of both from the same parameters, 2
# layers of rwkv6-3b's width, vocab 8192, 2 x 256 tokens: 9.51 -> 21.12 ->
# 9.71 -> 9.42 and 9.51 -> 21.10 -> 9.88 -> 9.14; on the card 11.57 ->
# 24.05 -> 17.74 in three steps, at lr 3e-4 and at 3e-5 alike), so three
# steps cannot show the fall: five run (cut from six; the parent's curve is
# under its first loss from step 5), and the last loss must be under the
# first.
TZ_ARCH, TZ_SEQ, TZ_BATCH, TZ_MB, TZ_STEPS = "rwkv6-3b", 4096, 8, 4, 5
TZ_REDUCED = {"global_batch": "256 -> 8 (microbatches 4 of 2 rows)",
              "mesh": "(pod, data, model) = (1, 1, 1)", "steps": TZ_STEPS}
# |int8 - exact| loss at every step, as a share of the exact loss: while
# the loss falls back from the first step's jump, 6 nats a step, the two
# runs part by up to 0.087 at a loss of 11.71 (0.74 %; 0.14 % at step 3,
# under 0.07 % at the others; an NVIDIA H100 80GB HBM3 at 700 W)
TZ_INT8_REL = 0.01
TZ_PEAK_GB = 80.0
# the exact run's losses on the parent tree (its K6 backward a block per
# (b, h) on CUDA cores; this phase on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md PR 27): its forward is this one's, so step 1's loss is the same
# number, bit for bit; the later steps take their gradients from the other
# backward kernel and are held within TZ_INT8_REL of the parent's
TZ_PARENT_LOSS = (11.571534156799316, 24.047481536865234, 17.74335289001465,
                  11.710390090942383, 7.899016380310059, 7.8309760093688965)
# ... and, since at random init the curve after step 1 follows the
# backward's rounding (PERF.md PR 27: on rwkv6-3b's step-1 gradient,
# float32-exact backwards part from a float64 one by up to 33 % of a leaf,
# the kernels by up to 44 %), K6's backward at the exact run's
# own inputs: those of the first and the last of step 1's TZ_BWD_CALLS
# calls (the top layer of the first microbatch, the bottom layer of the
# last) against float64 autograd of wkv_chunked, within WKV_BWD_RTOL of
# scale (dr, dk, dv beyond one bf16 rounding) and, for the decay leaves'
# part (sum over the tokens of dlogw * logw), of its norm (readings <=
# 7.6e-6). A backward that rounds dlogw / du to bf16, computed beside,
# reads above the limit (>= 9.4e-4; an NVIDIA H100 80GB HBM3 at 700 W).
TZ_BWD_CALLS = 128
# (c) the smoke configs of every family but the dense one (rwkv6's runs
# K6 and its backward through WKV6Function on the card, wkv_chunked and
# wkv6_bwd_ref on the CPU): one step's loss and gradients in float32 on the
# card against the CPU, then TZ_SMALL_STEPS int8 steps on the card. The
# limits come from the float32 readings (an NVIDIA H100 80GB HBM3 at
# 700 W, the same in two runs): loss <= 7.8e-8 relative, each leaf's max
# gap <= 4.4e-4 of its largest magnitude, norm gap <= 9.0e-5 of its norm;
# the same comparison in bf16, recorded beside, reads loss 7.6e-8..1.1e-6,
# max gap 9.4e-4..8.0e-3 and norm gap 2.8e-4..5.2e-3, so the norm limit
# sits under every family's bf16 reading
TZ_SMALL = ("rwkv6-3b", "qwen3-moe-30b-a3b", "mixtral-8x7b",
            "recurrentgemma-2b", "qwen2-vl-7b", "whisper-small")
TZ_SMALL_SEQ, TZ_SMALL_BATCH, TZ_SMALL_STEPS, TZ_SMALL_LR = 64, 4, 8, 2e-3
TZ_LOSS_RTOL, TZ_GRAD_MAX, TZ_GRAD_NORM = 1e-6, 4e-3, 2e-4
# ... and TZ_HEAD_ARCH's float32 comparison again by block, with the model's
# LM head and with the head fed the float32 hidden state
# (``_float32_head``): the largest leaf gap, 4.4e-4 of scale, is the head's
# bf16 cast rounding the backward's gradient (on both devices, as in the
# reference), not an op the card computes at reduced precision, so without
# that cast every leaf agrees within TZ_HEAD_GRAD_MAX of its scale
# (readings <= 1.1e-6, PERF.md PR 27)
TZ_HEAD_ARCH, TZ_HEAD_GRAD_MAX = "recurrentgemma-2b", 1e-5


def wkv6_bwd_bound(b, t, h, dh, dtype, state, has_ds, dv=None) -> dict:
    """K6 backward's least time: r, k, v, logw, dy, u (and state0, dS_T)
    read once, dr, dk, dv, dlogw, du (and dstate0) written once; its
    operations over the T real steps: the products of a chunk of c steps
    and head (the state recomputed, A = r'k'^T and Bm = dy v^T, dy S0^T,
    v G^T, kk G, the three products over the triangle, the adjoint update)
    at the dense TF32 tensor-core rate, the rest (rebasing, the u terms,
    dlogw's running sum, decays) at the float32 CUDA-core rate. ``dv``:
    the value columns (the value-column form; Dh unless given)."""
    dv = dh if dv is None else dv
    e = 2 if dtype == torch.bfloat16 else 4
    n, nv = b * t * h * dh, b * t * h * dv
    st = b * h * dh * dv * 4
    nbytes = (2 * n * e + nv * e + 4 * n + 4 * nv + 4 * h * dh
              + (st if state else 0) + (st if has_ds else 0)
              + 2 * n * e + nv * e + 4 * n + 4 * h * dh
              + (st if state else 0))

    def products(c):
        return (2 * dh * dv * c                      # the state, pass 1
                + c * (c - 1) * dh + 2 * c * c * dv  # A (triangle), Bm
                + 3 * 2 * c * dh * dv                # dy S0^T, v G^T, kk G
                + c * (c - 1) * (2 * dh + dv)        # Bm k', Bm^T r', A^T dy
                + 2 * dh * dv * c)                   # the adjoint

    def rest_ops(c):
        return 16 * c * dh + 4 * dh * dv
    full, rest = divmod(t, CHUNK)
    prod = b * h * (full * products(CHUNK) + (products(rest) if rest else 0))
    other = b * h * (full * rest_ops(CHUNK) + (rest_ops(rest) if rest else 0))
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = prod / TF32_FLOP_PER_S + other / FP32_FLOP_PER_S
    return {"bound_ms": 1e3 * max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "bytes": nbytes, "flops": float(prod + other),
            "tensor_core_flops": float(prod), "cuda_core_flops": float(other)}


def wkv_bwd_inputs(case):
    """The inputs of a WKV_BWD_CASES case (``wkv_inputs``' r, k, v, logw,
    u, state0 and a cotangent dy, dS_T or None)."""
    name, b, t, h, dh, dtype, state, has_ds, _ = case
    r, k_, v, logw, u, s0 = wkv_inputs(b, t, h, dh, dtype, state, SEED)
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    dy = torch.randn(b, t, h, dh, generator=g, device=DEV)
    ds = torch.randn(b, h, dh, dh, generator=g, device=DEV) if has_ds else None
    return r, k_, v, logw, u, s0, dy, ds


def wkv_bwd_plain(r, k_, v, logw, u, s0, dy, ds):
    """Autograd of the plain forward (``wkv_chunked``) on float32 copies of
    the inputs: the gradients (dr, dk, dv, dlogw, du[, dstate0]) and a
    function that runs that backward again (the graph kept: its time)."""
    ins = [x.detach().float().clone().requires_grad_(True)
           for x in (r, k_, v, logw, u)]
    if s0 is not None:
        ins.append(s0.detach().clone().requires_grad_(True))
    y, s = wkv_chunked(*ins[:5], ins[5] if s0 is not None else None)
    loss = (y * dy).sum() + (0 if ds is None else (s * ds).sum())
    grads = torch.autograd.grad(loss, ins, retain_graph=True)
    return grads, lambda: torch.autograd.grad(loss, ins, retain_graph=True)


def wkv6_bwd_plan(b, h, dh, dtype, nv) -> dict:
    """The backward's plan for a case, as the wrapper makes it: NV value
    slices (a cluster of NV blocks a (b, h); ``nv`` forces one), and the
    clusters of NV blocks the card runs at once."""
    clusters = lambda n: kw.max_active_clusters(DEV, dtype, dh, n)
    if nv is None:
        nv = kw.bwd_plan(b, h, dh, clusters)
    return {"NV": nv, "VB": dh // nv, "active_clusters": clusters(nv),
            "one_wave": b * h <= clusters(nv)}


def wkv6_bwd_nan(args, state, nv) -> dict:
    """K6's backward with one NaN in dy, the 0x7fffffff that CUDA's
    arithmetic makes (at batch 0, the middle step, head 0, value column 0),
    beside its plain version on the same inputs: which results are
    non-finite, per (b, h) (per head for du), and which steps of dr at
    (0, 0) (dr_t depends on dy_t alone). The kernel's must be the plain
    version's: the NaN reaches the results it reaches there (an operand's
    rounding does not drop it) and no other (b, h) (nor through the
    cluster's exchange)."""
    r, k_, v, logw, u, s0, dy, ds = args
    dy = dy.clone()
    dy.view(torch.int32)[0, dy.shape[1] // 2, 0, 0] = 0x7fffffff
    args = (r, k_, v, logw, u, s0, dy, ds)
    got = kw.wkv6_bwd_cuda(*args, need_state0_grad=state, nv=nv)
    want, _ = wkv_bwd_plain(*args)
    out = {}
    for key, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        dims = (1, 3) if key != "du" else (1,)
        bad = lambda x: (~torch.isfinite(x.float())).any(dims).cpu().tolist()
        out[key] = bad(g)
        assert out[key] == bad(w), (key, out[key], bad(w))
    rows = lambda x: (~torch.isfinite(x[0, :, 0].float())).any(-1).nonzero()
    out["dr_steps_at_0_0"] = rows(got[0]).flatten().tolist()
    assert out["dr_steps_at_0_0"] == rows(want[0]).flatten().tolist() \
        == [dy.shape[1] // 2], out
    return out


def _wkv_bwd_errs(row: dict, got, want, dtype) -> bool:
    """Each gradient's largest error, and its excess over one bf16 rounding
    (dr, dk, dv of bf16 inputs) as a share of its scale, into ``row``;
    whether every share is within WKV_BWD_RTOL."""
    ok = True
    for key, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "dstate0"), got,
                         want):
        g = g.float()
        scale = float(w.abs().max())
        bf16_out = key in ("dr", "dk", "dv") and dtype == torch.bfloat16
        ulp = 2.0 ** -8 * w.abs() if bf16_out else 0.0
        excess = ((g - w).abs() - ulp).clamp(min=0.0)
        row[f"{key}_max_abs_err"] = float((g - w).abs().max())
        row[f"{key}_err_of_scale"] = float(excess.max()) / scale
        ok &= row[f"{key}_err_of_scale"] <= WKV_BWD_RTOL
    row["max_abs_err"] = max(v for key, v in row.items()
                             if key.endswith("_max_abs_err"))
    return ok


def check_wkv6_bwd() -> dict:
    """K6's backward against autograd of ``wkv_chunked`` at every
    WKV_BWD_CASES case (WKV_BWD_RTOL), bit-identical over two runs, each
    with its plan, and with a NaN in dy (``wkv6_bwd_nan``); K6's forward at
    the path's shape against ``wkv_chunked`` (WKV_TOL); the two timed at
    the path's shape beside their plain versions and bounds."""
    rows, times = [], {}
    for case in WKV_BWD_CASES:
        name, b, t, h, dh, dtype, state, has_ds, nv = case
        args = wkv_bwd_inputs(case)
        plan = wkv6_bwd_plan(b, h, dh, dtype, nv)
        assert plan["active_clusters"] >= 1, (name, plan)
        got = kw.wkv6_bwd_cuda(*args, need_state0_grad=state, nv=nv)
        again = kw.wkv6_bwd_cuda(*args, need_state0_grad=state, nv=nv)
        torch.cuda.synchronize()
        want, plain = wkv_bwd_plain(*args)
        row = {"case": name, "B": b, "T": t, "H": h, "Dh": dh,
               "dtype": str(dtype).split(".")[-1], "state0": state,
               "dS_T": has_ds, "plan": plan, "nv_forced": nv is not None,
               "bit_identical": all(torch.equal(x, y) for x, y in
                                    zip(got, again) if x is not None)}
        ok = _wkv_bwd_errs(row, got, want, dtype)
        if name == WKV_BWD_PATH:
            r, k_, v, logw, u, s0, dy, ds = args
            y, _ = kw.wkv6_cuda(r, k_, v, logw, u, s0)
            y_r, _ = wkv_chunked(r, k_, v, logw, u, s0)
            row["forward_y_max_abs_err"] = float((y - y_r).abs().max())
            assert torch.allclose(y, y_r, rtol=WKV_TOL, atol=WKV_TOL), row
            u32 = u.float().contiguous()
            times["wkv6_bwd"] = _time_calls(
                {"wkv6_bwd": {
                    "ms": lambda: kw.wkv6_bwd_cuda(r, k_, v, logw, u32, s0,
                                                   dy, ds),
                    "plain_ms": plain}},
                {"wkv6_bwd": wkv6_bwd_bound(b, t, h, dh, dtype, state,
                                            has_ds)})["wkv6_bwd"]
            times["wkv6_bwd"]["plain_is"] = \
                "the backward of autograd over wkv_chunked (graph kept)"
            times["wkv6"] = _time_calls(
                {"wkv6": {"ms": lambda: kw.wkv6_cuda(r, k_, v, logw, u, s0),
                          "plain_ms": lambda: wkv_chunked(r, k_, v, logw, u,
                                                          s0)}},
                {"wkv6": wkv6_bound(b, t, h, dh, dtype, state)})["wkv6"]
            times["wkv6"]["y_max_abs_err"] = row["forward_y_max_abs_err"]
            times["wkv6_bwd"]["plan"] = plan
            del y, y_r
        else:
            row["nan_in_dy"] = wkv6_bwd_nan(args, state, nv)
        rows.append(row)
        assert ok and row["bit_identical"], row
        del args, got, again, want, plain
        _free()
    emit("kernel_check_wkv6_bwd", rtol_of_scale=WKV_BWD_RTOL,
         bf16_outputs="one bf16 rounding beyond the rtol", cases=rows)
    return {"rows": {r["case"]: r for r in rows}, "times": times}


def _rwkv_train_runs(mesh) -> tuple:
    """Phase (b): rwkv6-3b, TZ_STEPS exact and TZ_STEPS int8 donated steps
    from one init
    on the same data; per step its loss, CUDA-event time and launches, the
    first step's sync sites (sync debug mode "warn"), the later steps
    under "error"; the peak device memory of each run. Beside the runs, K6's
    backward at two of the exact step 1's calls' inputs against float64
    (``_wkv6_bwd_vs_float64``)."""
    cfg = get_config(TZ_ARCH)
    shape = ShapeSpec("train_4k_cut", TZ_SEQ, TZ_BATCH, "train")
    data = SyntheticLMData(cfg.vocab, TZ_SEQ, TZ_BATCH, seed=SEED)
    batches = [data.global_arrays(i, mesh) for i in range(TZ_STEPS)]
    runs, captured = {}, []
    kernel = k6_ops.wkv6_bwd_cuda

    def capture(*args, **kw_):
        if len(captured) == 0 or capture.calls == TZ_BWD_CALLS - 1:
            captured.append([x.detach().clone() if torch.is_tensor(x) else x
                             for x in args[:8]])
        capture.calls += 1
        return kernel(*args, **kw_)
    capture.calls = 0
    for name, bits in (("exact", None), ("int8", 8)):
        step = build_train_step(cfg, mesh, shape, TrainStepConfig(
            microbatches=TZ_MB, compression_bits=bits))
        params = step.init_params(SEED)
        opt = step.init_opt_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = {"loss": [], "grad_norm": [], "quant_noise": [], "ms": [],
               "launches": [],
               "resident_gb": torch.cuda.memory_allocated() / 1e9}
        for i, (tok, lab) in enumerate(batches):
            reset_all_counts()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            if i == 0:
                box = {}

                def one():
                    box["m"] = step(params, opt, tok, lab, donate=True)[2]
                    return box["m"]["loss"], None
                if name == "exact":
                    k6_ops.wkv6_bwd_cuda = capture
                try:
                    e0.record()
                    run["sync_sites_step1"] = sync_sites(one)
                    e1.record()
                finally:
                    k6_ops.wkv6_bwd_cuda = kernel
                m = box.pop("m")
                del one
            else:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    e0.record()
                    m = step(params, opt, tok, lab, donate=True)[2]
                    e1.record()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            e1.synchronize()
            run["ms"].append(e0.elapsed_time(e1))
            run["launches"].append({k_: v for k_, v in all_counts().items()
                                    if v})
            for key in ("loss", "grad_norm", "quant_noise"):
                run[key].append(float(m[key]))
        run["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["n_leaves"] = len(params)
        runs[name] = run
        del step, params, opt, m
        _free()
    assert capture.calls == TZ_BWD_CALLS and len(captured) == 2, capture.calls
    return runs, [_wkv6_bwd_vs_float64(*c) for c in captured]


def _wkv6_bwd_vs_float64(r, k_, v, logw, u, s0, dy, ds) -> dict:
    """K6's backward at inputs captured from the train step, against
    float64 autograd of ``wkv_chunked``: each result's error over its scale
    (for dr, dk, dv beyond one bf16 rounding, as in phase (a)) and the
    decay leaves' part (sum over (b, t) of dlogw * logw where logw > -2,
    w0's gradient through logw = -exp(min(w, ln 2))) over its norm; the same of the float64 results with dlogw and du
    rounded to bf16 (a reduced-precision control, recorded). Held to
    WKV_BWD_RTOL by ``run_train_zoo``."""
    with torch.enable_grad():
        ins = [x.detach().double().requires_grad_(True)
               for x in (r, k_, v, logw, u)]
        y, _ = wkv_chunked(*ins)
        want = torch.autograd.grad((y * dy.double()).sum(), ins)
    del y, ins
    got = kw.wkv6_bwd_cuda(r, k_, v, logw, u.float().contiguous(), s0, dy, ds)
    bf16 = [w.to(r.dtype) if i < 3 else w.bfloat16() for i, w in
            enumerate(want)]
    keep = (logw > -2.0).double()
    decay = lambda dlw: (dlw.double() * logw.double() * keep).sum((0, 1))
    out = {"dy_max_abs": float(dy.abs().max())}
    for tag, res in (("kernel", got), ("bf16_control", bf16)):
        row = {}
        for i, (key, g, w) in enumerate(zip(("dr", "dk", "dv", "dlogw", "du"),
                                            res, want)):
            ulp = 2.0 ** -8 * w.abs() if i < 3 and r.dtype == torch.bfloat16 \
                else 0.0
            excess = ((g.double() - w).abs() - ulp).clamp(min=0.0)
            row[f"{key}_err_of_scale"] = float(excess.max() / w.abs().max())
        row["decay_part_err_of_norm"] = float(
            (decay(res[3]) - decay(want[3])).norm() / decay(want[3]).norm())
        out[tag] = row
    return out


def _tz_aux(cfg, batch: int, device, dtype=torch.bfloat16) -> dict:
    """The stub inputs (whisper's frames, qwen2-vl's vision embeddings) of
    ``batch`` rows from a numpy seed."""
    n = (cfg.n_audio_frames if cfg.family == "whisper"
         else cfg.n_vision_tokens)
    if not n:
        return {}
    key = "frames" if cfg.family == "whisper" else "vision_embeds"
    a = np.random.default_rng(SEED).normal(size=(batch, n, cfg.d_model))
    return {key: torch.from_numpy(a.astype(np.float32)).to(dtype).to(device)}


def _tz_loss_grads(cfg, params, tok, lab, aux):
    keys = sorted(params)
    leaves = [params[k_].detach().clone().requires_grad_(True) for k_ in keys]
    loss = train_loss_fn(dict(zip(keys, leaves)), tok, lab, cfg, True, 2, aux)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {k_: g.float().cpu() for k_, g in zip(keys, grads)}


def _tz_compare(cfg, params, tok, lab, aux, dtype) -> dict:
    """One training loss and its gradients of ``params`` (cast to
    ``dtype``) on the card and on the CPU: the loss's relative gap, each
    leaf's max gap over its largest magnitude and norm gap over its norm
    (the worst leaf of each)."""
    p = {k_: v.to(dtype) for k_, v in params.items()}
    a = {k_: v.to(dtype) for k_, v in aux.items()}
    l_g, g_g = _tz_loss_grads(cfg, {k_: v.to(DEV) for k_, v in p.items()},
                              tok.to(DEV), lab.to(DEV),
                              {k_: v.to(DEV) for k_, v in a.items()})
    l_c, g_c = _tz_loss_grads(cfg, p, tok, lab, a)
    worst_max = max((float((g_g[k_] - g_c[k_]).abs().max()
                           / g_c[k_].abs().max().clamp(min=1e-30)), k_)
                    for k_ in g_c)
    worst_norm = max((float((g_g[k_] - g_c[k_]).norm()
                            / g_c[k_].norm().clamp(min=1e-30)), k_)
                     for k_ in g_c)
    return {"loss_card": l_g, "loss_cpu": l_c,
            "loss_rel_gap": abs(l_g - l_c) / abs(l_c),
            "grad_max_gap_of_scale": worst_max[0],
            "grad_max_gap_leaf": worst_max[1],
            "grad_norm_gap_of_norm": worst_norm[0],
            "grad_norm_gap_leaf": worst_norm[1]}


def _tz_small(mesh) -> dict:
    """Phase (c): each TZ_SMALL smoke config. One training loss and its
    gradients on the card against the CPU with float32 weights (asserted
    at TZ_LOSS_RTOL / TZ_GRAD_MAX / TZ_GRAD_NORM) and with the bf16 weights
    the model trains in (recorded: the two devices' products round bf16 at
    other places, the gap the CPU tests see between the reference's jitted
    and op-by-op runs); then TZ_SMALL_STEPS int8 donated steps on the card,
    whose loss falls, with K4a / K4b-sum / K4b 2 / 1 / 1 a leaf a step (and
    rwkv6's K6 two and its backward one a layer)."""
    out = {}
    for arch in TZ_SMALL:
        cfg = get_config(arch).smoke_config()
        shape = ShapeSpec("smoke", TZ_SMALL_SEQ, TZ_SMALL_BATCH, "train")
        step = build_train_step(cfg, mesh, shape, TrainStepConfig(
            compression_bits=8, moe_groups=2,
            adamw=AdamWConfig(lr=TZ_SMALL_LR)))
        cpu = build_train_step(cfg, make_host_mesh(model=1, device="cpu"),
                               shape, TrainStepConfig(moe_groups=2))
        params = cpu.init_params(SEED)
        data = SyntheticLMData(cfg.vocab, TZ_SMALL_SEQ, TZ_SMALL_BATCH,
                               seed=SEED)
        tok, lab = (torch.as_tensor(x) for x in data.global_arrays(
            0, make_host_mesh(model=1, device="cpu")))
        aux = _tz_aux(cfg, TZ_SMALL_BATCH, "cpu")
        f32 = _tz_compare(cfg, params, tok, lab, aux, torch.float32)
        bf16 = _tz_compare(cfg, params, tok, lab, aux, torch.bfloat16)
        row = {"float32": f32, "bf16_recorded": bf16}
        if arch == TZ_HEAD_ARCH:
            row["head_guard"] = _tz_head_guard(cfg, params, tok, lab)
        assert f32["loss_rel_gap"] <= TZ_LOSS_RTOL, (arch, f32)
        assert f32["grad_max_gap_of_scale"] <= TZ_GRAD_MAX, (arch, f32)
        assert f32["grad_norm_gap_of_norm"] <= TZ_GRAD_NORM, (arch, f32)
        p_dev = {k_: v.to(DEV) for k_, v in params.items()}
        opt = step.init_opt_state(p_dev)
        aux_dev = _tz_aux(cfg, TZ_SMALL_BATCH, DEV)
        losses, launches = [], []
        for i in range(TZ_SMALL_STEPS):
            t_i, l_i = data.global_arrays(i, mesh)
            reset_all_counts()
            m = step(p_dev, opt, t_i, l_i, aux_dev, donate=True)[2]
            losses.append(float(m["loss"]))
            launches.append({k_: v for k_, v in all_counts().items() if v})
        n = len(p_dev)
        want = {"quantize_blocks": 2 * n, "dequantize_sum": n,
                "dequantize_blocks": n}
        if cfg.family == "rwkv6":          # forward and recompute; backward
            want.update(wkv6=2 * cfg.n_layers, wkv6_bwd=cfg.n_layers)
        row.update(losses=losses, k4_launches_per_step=launches[0],
                   leaves=n)
        assert all(np.isfinite(losses)), (arch, losses)
        assert losses[-1] < losses[0], (arch, losses)
        for got in launches:
            assert {k_: got.get(k_, 0) for k_ in want} == want, (arch, got)
        out[arch] = row
        del step, cpu, params, p_dev, opt
        _free()
    return out


def _rglru_pass(cfg, params, tok, lab) -> tuple:
    """One training loss of an rglru model (``params`` float32, no
    recompute) and its gradients, with the model's blocks wrapped: the
    residual stream after each recurrent block and each attention + MLP
    tail, in the forward's order, the loss's gradient with respect to each,
    and each leaf's gradient; all float32 on the CPU."""
    from repro_torch.models import rglru
    saved = (rglru._rec_block, rglru._mlp_tail)
    acts, grads = [], {}

    def keep(y):
        i = len(acts)
        acts.append(y.detach().float().cpu())
        y.register_hook(lambda g: grads.__setitem__(i, g.detach().float()
                                                    .cpu()))

    def rec(x, *args, **kw):
        y = saved[0](x, *args, **kw)
        keep(y[0])
        return y

    def tail(x, *args, **kw):
        y = saved[1](x, *args, **kw)
        keep(y)
        return y
    keys = sorted(params)
    leaves = [params[k_].detach().clone().requires_grad_(True) for k_ in keys]
    rglru._rec_block, rglru._mlp_tail = rec, tail
    try:
        loss = train_loss_fn(dict(zip(keys, leaves)), tok, lab, cfg, False, 2,
                             {})
        g = torch.autograd.grad(loss, leaves)
    finally:
        rglru._rec_block, rglru._mlp_tail = saved
    return (acts, [grads[i] for i in range(len(acts))],
            {k_: x.float().cpu() for k_, x in zip(keys, g)})


@contextlib.contextmanager
def _float32_head():
    """The loss's LM head fed the float32 hidden state instead of its bf16
    rounding (``model_api._chunk_logits``' cast, the reference's
    ``hc.astype(jnp.bfloat16)``), for phase (c)'s TZ_HEAD_ARCH control and
    train_tp's float32 comparisons: in the backward that cast rounds the
    loss's gradient at the last block to bf16."""
    from repro_torch.models import model_api
    saved = model_api._chunk_logits
    model_api._chunk_logits = lambda hc, table: torch.matmul(
        hc.float(), table.float().T)
    try:
        yield
    finally:
        model_api._chunk_logits = saved


def _gap(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _tz_head_guard(cfg, params, tok, lab) -> dict:
    """TZ_HEAD_ARCH in float32, card against CPU, with the model's LM head
    and with the head fed float32 (``_float32_head``): each block's output
    and the loss's gradient at it (``_rglru_pass``) as a gap over its
    scale, and the largest leaf gap (max over the leaf's largest
    magnitude). The float32 head's leaves are held to TZ_HEAD_GRAD_MAX."""
    params = {k_: v.float() for k_, v in params.items()}
    p_dev = {k_: v.to(DEV) for k_, v in params.items()}
    out = {}
    for tag, head in (("model_head", contextlib.nullcontext),
                      ("float32_head", _float32_head)):
        with head():
            a_card, d_card, g_card = _rglru_pass(cfg, p_dev, tok.to(DEV),
                                                 lab.to(DEV))
            a_cpu, d_cpu, g_cpu = _rglru_pass(cfg, params, tok, lab)
        out[tag] = {
            "block_output_gaps": [_gap(x, y) for x, y in zip(a_card, a_cpu)],
            "block_grad_gaps": [_gap(x, y) for x, y in zip(d_card, d_cpu)],
            "leaf_max_gap": max(_gap(g_card[k_], g_cpu[k_]) for k_ in g_cpu)}
    assert out["float32_head"]["leaf_max_gap"] <= TZ_HEAD_GRAD_MAX, out
    return out


def run_train_zoo() -> dict:
    """Phase ``train_zoo``: (a) K6's backward against autograd of its plain
    forward; (b) rwkv6-3b at full width and depth, exact and int8, the
    donated step on an NCCL world of one; (c) the other families' smoke
    configs, card against CPU and int8 steps."""
    import tempfile
    import torch.distributed as dist
    t_phase = time.perf_counter()
    a = check_wkv6_bwd()
    store_dir = tempfile.mkdtemp(prefix="amp_train_zoo_")
    init_cluster(num_processes=1, process_id=0, backend="nccl",
                 store_path=os.path.join(store_dir, "nccl_train_zoo"),
                 device=str(DEV))
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                         device=str(DEV))
        runs, at_inputs = _rwkv_train_runs(mesh)
        small = _tz_small(mesh)
    finally:
        dist.destroy_process_group()
    cfg = get_config(TZ_ARCH)
    n_leaves = runs["exact"]["n_leaves"]
    per_step = {"wkv6": 2 * cfg.n_layers * TZ_MB,        # forward, recompute
                "wkv6_bwd": cfg.n_layers * TZ_MB}
    k4 = {"quantize_blocks": 2 * n_leaves, "dequantize_sum": n_leaves,
          "dequantize_blocks": n_leaves}
    tokens = TZ_BATCH * TZ_SEQ
    for run in runs.values():
        steady = statistics.median(run["ms"][1:])
        run["steady_step_ms"] = steady
        run["tokens_per_s"] = tokens / (steady / 1e3)
    gaps = [abs(x - y) for x, y in zip(runs["int8"]["loss"],
                                       runs["exact"]["loss"])]
    launches = {key: sum(r.get(key, 0) for run in runs.values()
                         for r in run["launches"])
                for key in ("wkv6", "wkv6_bwd")}
    # the line first, then the checks: a failed check still shows its data
    emit("train_zoo", card=nvidia_smi_line(), arch=TZ_ARCH,
         seq_len=TZ_SEQ, global_batch=TZ_BATCH, microbatches=TZ_MB,
         reduced=TZ_REDUCED, wkv6_bwd_times=a["times"], runs=runs,
         int8_exact_gaps=gaps,
         launches_per_step={"exact": per_step, "int8": {**per_step, **k4}},
         launches=launches, small=small,
         parent_exact_loss=TZ_PARENT_LOSS, wkv6_bwd_at_step_inputs=at_inputs,
         limits={"wkv6_bwd_rtol_of_scale": WKV_BWD_RTOL,
                 "int8_exact_gap_of_loss": TZ_INT8_REL,
                 "peak_gb": TZ_PEAK_GB,
                 "small_loss_rtol": TZ_LOSS_RTOL,
                 "small_grad_max_of_scale": TZ_GRAD_MAX,
                 "small_grad_norm_of_norm": TZ_GRAD_NORM},
         seconds=time.perf_counter() - t_phase)
    for name, run in runs.items():
        assert all(np.isfinite(run["loss"])), (name, run["loss"])
        assert run["loss"][-1] < run["loss"][0], (name, run["loss"])
        assert run["peak_memory_gb"] < TZ_PEAK_GB, (name, run)
        for i, got in enumerate(run["launches"]):
            want = dict(per_step, **(k4 if name == "int8" else {}))
            keys = list(per_step) + list(k4)
            assert {k_: got.get(k_, 0) for k_ in keys} == \
                {k_: want.get(k_, 0) for k_ in keys}, (name, i, got)
    assert all(g <= TZ_INT8_REL * abs(x) for g, x in
               zip(gaps, runs["exact"]["loss"])), (runs["int8"]["loss"],
                                                   runs["exact"]["loss"])
    exact = runs["exact"]["loss"]
    assert exact[0] == TZ_PARENT_LOSS[0], (exact, TZ_PARENT_LOSS)
    assert all(abs(x - y) <= TZ_INT8_REL * y for x, y in
               zip(exact[1:], TZ_PARENT_LOSS[1:])), (exact, TZ_PARENT_LOSS)
    for row in at_inputs:
        assert all(x <= WKV_BWD_RTOL for x in row["kernel"].values()), row
    # the fused gradients are the compressed ones: from step 2 on, the
    # int8 run's loss is not the exact run's
    assert all(x != y for x, y in zip(runs["int8"]["loss"][1:],
                                      runs["exact"]["loss"][1:])), gaps
    assert all(v > 0 for v in runs["int8"]["quant_noise"])
    return {"check": a, "launches": launches}


def train_zoo_kernel_rows(ctx) -> list:
    """The kernels line's rows of phase train_zoo: K6's backward and K6 at
    rwkv6-3b's training shape, timed there, with the launches of (b)'s six
    steps (counts set to 0 just before each step)."""
    rows = []
    err = ctx["check"]["rows"][WKV_BWD_PATH]
    for name, key, e in (("wkv6_bwd", "wkv6_bwd", err["max_abs_err"]),
                         ("wkv6/train_rwkv6_3b", "wkv6",
                          err["forward_y_max_abs_err"])):
        tm = ctx["check"]["times"][key]
        assert ctx["launches"][key] > 0, (name, ctx["launches"])
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[key],
            "replaces": REPLACES[key], "launches": ctx["launches"][key],
            "max_abs_err": e, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})
    return rows


# ---------------------------------------------------------------------------
# Tensor parallelism over "model" (phase train_tp)
# ---------------------------------------------------------------------------

# The ranks are gloo ranks spawned on the one card (NCCL refuses two ranks
# on one GPU), as the sharded phase's (b): the phase proves the "model" axis
# right and records what it moves; its times are of ranks oversubscribing
# one card, not of scaling.
# (1) gemma3-1b at its published width and depth, 'tp' at (data=1,
# model=2), train_4k's 4096 positions, a global batch of 2 rows that both
# ranks hold, in 2 microbatches; TP_STEPS donated steps against the world of
# one on the same rows (the loss within TP_LOSS_RTOL, the gradient norm
# within TP_NORM_RTOL: bf16 weights, products rounded alike, float32 sums
# in another order), and the loss lower at the last step than at the first
TP_ARCH, TP_SEQ, TP_BATCH, TP_MB, TP_STEPS = "gemma3-1b", 4096, 2, 2, 2
TP_LOSS_RTOL, TP_NORM_RTOL = 1e-3, 1e-2
# (2) the float32 guard: the same width at TP_F32_LAYERS layers, float32
# weights, the LM head fed the float32 hidden state (its bf16 rounding
# would flip with the summation order), 'tp', 'tp_sp' and 'fsdp' each
# against the world of one: the loss within TP_F32_LOSS relative, every
# leaf's fused gradient within TP_F32_GRAD of its largest magnitude
TP_F32_LAYERS, TP_F32_LOSS, TP_F32_GRAD = 2, 1e-6, 1e-5
# (3) (pod=2, data=1, model=2): four ranks, gemma3-1b cut to TP_POD_LAYERS
# layers (four ranks' peaks on one card), one row a pod, TP_POD_STEPS exact
# and TP_POD_STEPS int8-over-"pod" steps: K4a / K4b-sum / K4b at the
# slices' chunks, TRAIN_K4's launches a step on every rank
TP_POD_LAYERS, TP_POD_STEPS = 4, 2
# (4) 'tp_sp' and 'fsdp' at model=2 in bf16, gemma3-1b at TP_SP_LAYERS
# layers: step 1 against the world of one (TP_LOSS_RTOL, TP_NORM_RTOL),
# with each leaf's gradient norm beside. In bf16 the tied table's gradient
# depends on how many rows a loss chunk holds (its bf16 sums over the
# chunks): the world of one in 2 microbatches of a row and in 1 of 2 rows
# part by 1.45 % on the gradient norm, 2.05 % on embed/table's (an NVIDIA
# H100 80GB HBM3 at 700 W). 'tp_sp' runs 2 microbatches of a row as the
# first does; under 'fsdp' each rank's layers take its row but the loss
# takes both ranks' rows in each chunk, as the second: each is held to the
# world of one that chunks its loss alike, both gaps recorded
TP_SP_LAYERS = 2        # cut from 4 for tp_zoo's time
# (5) rwkv6-3b 'tp' at model=2: full width (40 heads, 20 a rank), 2 of its
# 32 layers (cut from 4); K6 and its backward at H = 20 on each rank; step 1's loss
# against the world of one (TP_LOSS_RTOL); the decay leaves' gradients in
# float32 (weights and LM head) within TP_F32_GRAD of their scale
TP_RWKV_ARCH, TP_RWKV_LAYERS = "rwkv6-3b", 2
# ... the float32 guard of rwkv6-3b: full width at TP_RWKV_F32_LAYERS
# layer and TP_SEQ positions, float32 weights and LM head, every leaf (the
# decay and mix LoRAs among them) against the world of one beside a
# control: the world of one with every weight moved by one float32
# rounding. The loss within TP_F32_LOSS; each leaf within TP_RWKV_CONTROL
# x its control, or TP_F32_GRAD where that is larger. Rounding alone moves
# the leaves upstream of the recurrence (embed, ln1, the mixes, w0,
# w_lora1/2, wr, wk, u) by up to 6.7e-5 of scale at 4096 positions and
# 3.9e-4 at 512 (the control; an NVIDIA H100 80GB HBM3 at 700 W; PERF.md,
# train_tp), so no leaf can be held to TP_F32_GRAD alone; a sum over "model"
# left out moves a leaf by a share of order 0.5. At TP_RWKV_LAYERS float32
# layers the decay leaves are chaotic (the control 1.4-2.1e-2 of scale)
TP_RWKV_F32_LAYERS, TP_RWKV_CONTROL = 1, 2.0
# (6) the kernels at this phase's shapes, before any rank starts: K6 and
# its backward at WKV_TP_CASE (a microbatch of 1 x 4096, 20 of rwkv6-3b's
# 40 heads of 64; WKV_BWD_CASES' form), the backward within WKV_BWD_RTOL
# of autograd of wkv_chunked and bit-identical over two runs, the forward
# within WKV_TOL of wkv_chunked; K4a / K4b-sum / K4b (int8, blocks of 512)
# bit for bit with their plain versions at (3)'s chunks: compressed_psum
# over "pod" cuts each rank's slice of a leaf into 2 chunks, K4a runs on
# the (2, C) chunks and on the (1, C) reduced one, K4b-sum and K4b on
# (2, C). gemma3-1b at 4 layers, model=2: embed/table 262144 x 1152 / 2,
# w_gate / w_up / w_down 4 x 1152 x 6912 / 2, wq / wo 4 x 1152 x 1024 / 2,
# wk / wv 4 x 1152 x 256 (whole), the 4 x 1152 norms, the 4 x 256 q / k
# norms and the final 1152, each padded to a multiple of 2 x 1024: each
# over 2 pods
WKV_TP_CASE = ("rwkv6_3b_tp", 1, 4096, 20, 64, torch.bfloat16, False, False,
               None)
TP_K4_CHUNKS = (75497472, 7962624, 1179648, 589824, 3072, 1024)
# (3) the int8 run against the exact one from the same init, every rank:
# step 1's gradient norm (of the fused, compressed gradients) within
# TP_INT8_NORM relative, each step's loss within TZ_INT8_REL of the exact
# loss. Quantization moves the norm by 6.5e-4 (an NVIDIA H100 80GB HBM3 at
# 700 W); a pod's gradient left out of the sum, or counted twice, moves it
# by far more (a CPU mutation run on the smoke config: PERF.md, train_tp)
TP_INT8_NORM = 1e-2
# (7) MoE with whole experts under 'tp_sp': qwen3-moe's smoke config with
# 3 experts of a d_ff of 129 (neither divides "model" = 2, so every rank
# holds every expert whole and runs the layer on the gathered token set),
# float32 weights and LM head, at (1, 2) against the world of one computed
# in this process before the world spawns: the loss within TP_F32_LOSS,
# every leaf's fused gradient (the router's and the experts' among them)
# within TP_F32_GRAD of its scale, every dispatch's kept slots the same; at
# the config's capacity factor and at 1.0, where slots are dropped
TP_MOE_WHOLE = (("qwen3-moe/whole", 1.25), ("qwen3-moe/whole_cf1", 1.0))
TP_KERNELS = ("quantize_blocks", "dequantize_blocks", "dequantize_sum",
              "quantize_blocks_packed", "dequantize_blocks_packed",
              "dequantize_sum_packed", "wkv6", "wkv6_bwd")
TP_REDUCED = {
    "gemma3-1b tp": "global batch 256 -> 2 (2 microbatches of 1 row), "
                    f"{TP_STEPS} steps, (data, model) = (1, 2)",
    "float32 guard": f"{TP_F32_LAYERS} of 26 layers",
    "pod int8": f"{TP_POD_LAYERS} of 26 layers, global batch 2, "
                "(pod, data, model) = (2, 1, 2)",
    "tp_sp / fsdp": f"{TP_SP_LAYERS} of 26 layers, global batch 2",
    "rwkv6-3b tp": f"{TP_RWKV_LAYERS} of 32 layers, global batch 2 in 2 "
                   "microbatches",
    "rwkv6-3b float32 guard": f"{TP_RWKV_F32_LAYERS} of 32 layers",
    "qwen3-moe whole experts tp_sp": "the smoke config with 3 experts of a "
                                     "d_ff of 129, global batch 2"}


def _local_grid() -> GridMesh:
    """A (data, model) mesh of one rank on the card inside a larger world:
    the world of one, no collective runs on it."""
    one = lambda: Mesh(group=None, size=1, rank=0, device=DEV,
                       backend="none")
    return GridMesh(shape={"data": 1, "model": 1},
                    coords={"data": 0, "model": 0}, rank=0, device=DEV,
                    meshes={("data",): one(), ("model",): one()})


def _rules_bytes(step) -> dict:
    """A rank's parameter (bf16) and AdamW-state bytes by the rules: each
    leaf's "model" slice, and its ZeRO-1 slice of that (the dry run's
    count, less AdamW's int32 step)."""
    b = train_argument_bytes(step)
    return {"params": b["params"], "opt": b["opt_state"] - 4}


def _leaf_norms(step, params, tok, lab) -> dict:
    """Each leaf's fused step-1 gradient norm (whole leaf: every distinct
    piece once, summed over the ranks)."""
    loss, grads = step._grads(params, tok, lab, {})
    with torch.no_grad():
        _, grads, _ = step._fuse(loss, grads)
        sq = torch.stack([step._slice(k_, grads[k_]).float().square().sum()
                          if step._owner[k_] else
                          torch.zeros((), device=DEV) for k_ in sorted(grads)])
        if step.world is not None and step.world.size > 1:
            sq = psum(sq, step.world)
    return dict(zip(sorted(grads), sq.sqrt().tolist()))


def _tp_steps(mesh, cfg, shape, tcfg, steps: int, k4_shapes: bool = False,
              leaf_norms: bool = False) -> dict:
    """``steps`` donated steps of ``cfg`` on ``mesh`` from the SEED init on
    the SEED data: per step the loss, gradient norm, CUDA-event and wall
    ms, the peak GB of this process, the launches and what the "model"
    (and "pod") axis's collectives moved; the rank's bytes against the
    rules'; with ``leaf_norms`` each leaf's step-1 gradient norm."""
    step = build_train_step(cfg, mesh, shape, tcfg)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch,
                           seed=SEED)
    params = step.init_params(SEED)
    opt = step.init_opt_state(params)
    norms = (_leaf_norms(step, params, *data.global_arrays(
        0, mesh, step.batch_axes)) if leaf_norms else None)
    got = {"params": sum(v.numel() * v.element_size()
                         for v in params.values()),
           "opt": sum(v.numel() * v.element_size() for key in
                      ("master", "m", "v") for v in opt[key].values())}
    run = {"bytes": got, "rules_bytes": _rules_bytes(step),
           "leaf_norms": norms, "loss": [],
           "grad_norm": [], "quant_noise": [], "ms": [], "wall_ms": [],
           "peak_gb": [], "launches": [], "collectives": []}
    axes = [a for a in ("model", "pod") if a in mesh.shape]
    for i in range(steps):
        tok, lab = data.global_arrays(i, mesh, step.batch_axes)
        for a in axes:
            mesh.axis(a).stats.reset()
        reset_all_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        with (k4_calls_by_shape() if k4_shapes
              else contextlib.nullcontext(None)) as by_shape:
            params, opt, m = step(params, opt, tok, lab, donate=True)
        e1.record()
        e1.synchronize()
        run["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        run["ms"].append(e0.elapsed_time(e1))
        run["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        run["launches"].append({k_: v for k_, v in all_counts().items()
                                if v})
        if by_shape is not None:
            run.setdefault("k4_by_shape", []).append(
                {f"{form} {key}": v for (form, key), v in by_shape.items()})
        run["collectives"].append({a: mesh.axis(a).stats.snapshot()
                                   for a in axes})
        for key in ("loss", "grad_norm", "quant_noise"):
            run[key].append(float(m[key]))
    del step, params, opt, m
    _free()
    return run


def _tp_grads(mesh, cfg, shape, tcfg, want: str | None = None,
              jitter: bool = False, aux: dict | None = None) -> tuple:
    """Step 1's loss and fused gradients of ``cfg`` with float32 weights
    and LM head on ``mesh``; with ``jitter`` every weight moved by one
    float32 rounding (a factor 1 +- 2^-23, signs from SEED + 1): a control
    of how far rounding alone moves them. ``aux``: the stub inputs of the
    global batch (whisper's frames). Without ``want`` (a world of one)
    returns the whole gradients. With ``want``, the world of one's whole
    gradients saved there (``torch.save``, read memory-mapped: a rank reads
    its slices only), returns instead per leaf this rank's slice's largest
    gap to them and their largest magnitude on it (``_merge_gaps`` takes
    the maxima over ranks): nothing is gathered, as whole float32 leaves at
    qwen2-vl's vocab through gloo's host copies on 8 ranks overran the
    host's memory."""
    step = build_train_step(cfg, mesh, shape, tcfg)
    data = SyntheticLMData(cfg.vocab, shape.seq_len, shape.global_batch,
                           seed=SEED)
    params = {k_: v.float() for k_, v in step.init_params(SEED).items()}
    if jitter:
        gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
        for k_ in sorted(params):
            sign = torch.randint(0, 2, params[k_].shape, generator=gen,
                                 device=DEV) * 2 - 1
            params[k_].mul_(1 + sign.float() * 2.0 ** -23)
    tok, lab = data.global_arrays(0, mesh, step.batch_axes)
    with _float32_head():
        loss, grads = step._grads(params, tok, lab, step._aux_rows(aux))
    del params
    with torch.no_grad():
        loss, grads, _ = step._fuse(loss, grads)
        if want is None:
            assert all(n == 1 for n in mesh.shape.values()), \
                "only a world of one returns whole leaves"
            return float(loss), grads
        whole = torch.load(want, mmap=True)
        r = mesh.coords.get("model", 0)
        gaps = {}
        for k_ in sorted(grads):
            g, w, d = grads.pop(k_), whole[k_], step.model_dims[k_]
            if d is not None and g.shape != w.shape:
                w = w.narrow(d, r * g.shape[d], g.shape[d])
            w = w.to(g.device)
            gaps[k_] = (float((g - w).abs().max()), float(w.abs().max()))
            del g, w
    del whole
    _free()
    return float(loss), gaps


def _moe_whole_cfg(cf: float):
    """(7)'s config: qwen3-moe's smoke config with 3 experts of a d_ff of
    129 at capacity factor ``cf``."""
    return dataclasses.replace(
        get_config("qwen3-moe-30b-a3b").smoke_config(), n_experts=3,
        d_ff=129, capacity_factor=cf)


def _moe_whole_checks(ones: dict, ranks: list, check) -> dict:
    """(7)'s comparisons of every rank's cases against the world of one
    (``ones``: ``world_of_one``'s)."""
    out = {}
    for name, cf in TP_MOE_WHOLE:
        want = ones[name]
        worst = _merge_gaps([r[name]["gaps"] for r in ranks])
        rec = out[name] = {
            "capacity_factor": cf, "loss_one": want["loss"],
            "dispatches": len(want["keeps"]),
            "dropped_slots": int(sum((~k_).sum() for k_ in want["keeps"])),
            "loss_rel": [_rel_gap(r[name]["loss"], want["loss"])
                         for r in ranks],
            "worst_leaf": max(worst.items(), key=lambda kv: kv[1])}
        check(max(rec["loss_rel"]) <= TP_F32_LOSS, f"{name} loss",
              rec["loss_rel"])
        check(rec["worst_leaf"][1] <= TP_F32_GRAD, f"{name} leaves",
              rec["worst_leaf"])
        for r in ranks:
            got = r[name]["keeps"]
            check(len(got) == len(want["keeps"]) and all(
                np.array_equal(a, b) for a, b in zip(got, want["keeps"])),
                  f"{name} dropped slots")
        # the router's and the experts' gradients are not all zero
        check(all(max(r[name]["gaps"][k_][1] for r in ranks) > 0 for k_ in (
            "layers/router", "layers/we_gate", "layers/we_up",
            "layers/we_down")), f"{name} expert gradients")
        if cf < 1.25:
            check(rec["dropped_slots"] > 0, f"{name} drops slots",
                  rec["dropped_slots"])
    return out


def _merge_gaps(ranks: list) -> dict:
    """Each leaf's largest gap over every rank's slice, over the world of
    one's largest magnitude (``_tp_grads``' pairs of every rank)."""
    return {k_: max(r[k_][0] for r in ranks)
            / max(max(r[k_][1] for r in ranks), 1e-30) for k_ in ranks[0]}


def _cut_cfg(arch: str, layers: int):
    """``arch`` at ``layers`` layers (whisper's encoder too)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    return (dataclasses.replace(cfg, n_enc_layers=layers)
            if cfg.n_enc_layers else cfg)


def _f32_aux(cfg, batch: int) -> dict | None:
    """The stub inputs of a float32 guard's global batch (whisper's)."""
    return (_tz_aux(cfg, batch, DEV, torch.float32)
            if cfg.family == "whisper" else None)


def world_of_one(cases, shape, tcfg, tmp: str) -> dict:
    """The float32 guards' world of one, in this process before their
    world spawns: per (key, cfg, control) of ``cases`` the loss, every MoE
    dispatch's kept slots (``moe.recorded_keeps``) and the whole fused
    gradients saved to a file under ``tmp``; with ``control`` also each
    leaf's gap under one float32 rounding of every weight
    (``_tp_grads(jitter=True)`` against that file), over its scale."""
    out = {}
    for key, cfg, control in cases:
        aux = _f32_aux(cfg, shape.global_batch)
        with lm_moe.recorded_keeps() as keeps:
            loss, g = _tp_grads(_local_grid(), cfg, shape, tcfg, aux=aux)
        rec = {"loss": loss, "keeps": [k_.cpu().numpy() for k_ in keeps],
               "path": os.path.join(tmp, re.sub(r"\W", "_", str(key))
                                    + ".pt")}
        torch.save({k_: v.cpu() for k_, v in g.items()}, rec["path"])
        del g, keeps
        _free()
        if control:
            _, gaps = _tp_grads(_local_grid(), cfg, shape, tcfg,
                                want=rec["path"], jitter=True, aux=aux)
            rec["control"] = _merge_gaps([gaps])
        out[key] = rec
    return out


@contextlib.contextmanager
def _k6_calls(key=lambda r, v: r.shape[2]):
    """Counts K6's and its backward's calls by ``key(r, v)`` of their
    operands (their H by default; the value columns Dv with
    ``lambda r, v: v.shape[-1]``): the dispatch's bindings of the wrappers
    wrapped, nothing read from the card."""
    tally = collections.Counter()
    fwd, bwd = k6_ops.wkv6_cuda, k6_ops.wkv6_bwd_cuda

    def f(r, k_, v, *a, **kw_):
        tally["wkv6", key(r, v)] += 1
        return fwd(r, k_, v, *a, **kw_)

    def b(r, k_, v, *a, **kw_):
        tally["wkv6_bwd", key(r, v)] += 1
        return bwd(r, k_, v, *a, **kw_)
    k6_ops.wkv6_cuda, k6_ops.wkv6_bwd_cuda = f, b
    try:
        yield tally
    finally:
        k6_ops.wkv6_cuda, k6_ops.wkv6_bwd_cuda = fwd, bwd


def check_train_tp_kernels() -> dict:
    """(6): K6 and its backward at WKV_TP_CASE, K4's int8 forms at each
    TP_K4_CHUNKS chunk, each against its plain version on the same inputs;
    the rows, and each kernel's largest error here."""
    name, b, t, h, dh, dtype, state, has_ds, nv = WKV_TP_CASE
    args = wkv_bwd_inputs(WKV_TP_CASE)
    got = kw.wkv6_bwd_cuda(*args, need_state0_grad=state, nv=nv)
    again = kw.wkv6_bwd_cuda(*args, need_state0_grad=state, nv=nv)
    want, _ = wkv_bwd_plain(*args)
    wkv = {"case": name, "B": b, "T": t, "H": h, "Dh": dh,
           "plan": wkv6_bwd_plan(b, h, dh, dtype, nv),
           "bit_identical": all(torch.equal(x, y) for x, y in
                                zip(got, again) if x is not None)}
    wkv["backward_ok"] = _wkv_bwd_errs(wkv, got, want, dtype)
    del got, again, want
    r, k_, v, logw, u, s0, _, _ = args
    y, _ = kw.wkv6_cuda(r, k_, v, logw, u, s0)
    y_r, _ = wkv_chunked(r, k_, v, logw, u, s0)
    wkv["forward_y_max_abs_err"] = float((y - y_r).abs().max())
    wkv["forward_ok"] = bool(torch.allclose(y, y_r, rtol=WKV_TOL,
                                            atol=WKV_TOL))
    del args, r, k_, v, logw, u, y, y_r
    _free()
    k4, errs = [], collections.defaultdict(float)
    for i, n in enumerate(TP_K4_CHUNKS):
        x = torch.cat([grad_inputs(n, SEED + 11 + 2 * i + j)
                       for j in range(2)])
        q, sc = kq.quantize_cuda(x, 127, 512)
        q1, s1 = kq.quantize_cuda(x[:1], 127, 512)
        qr, sr = qops.quantize_plain(x, 127, 512)
        q1r, s1r = qops.quantize_plain(x[:1], 127, 512)
        del x
        row = {"N": n,
               "quantize_blocks R2": bool(
                   torch.equal(q, qr) and torch.equal(sc.view(torch.int16),
                                                      sr.view(torch.int16))),
               "quantize_blocks R1": bool(
                   torch.equal(q1, q1r) and torch.equal(
                       s1.view(torch.int16), s1r.view(torch.int16)))}
        # K4a's error: the largest gap of its symbols
        gap = lambda a, b: float((a.float() - b.float()).abs().max())
        errs["quantize_blocks"] = max(errs["quantize_blocks"], gap(q, qr),
                                      gap(q1, q1r))
        del q, sc, q1, s1, q1r, s1r
        for form, fn, plain in (
                ("dequantize_sum", kq.dequantize_sum_cuda,
                 qops.dequantize_sum_plain),
                ("dequantize_blocks", kq.dequantize_cuda,
                 qops.dequantize_plain)):
            a, w = fn(qr, sr, 512), plain(qr, sr, 512)
            row[f"{form} R2"] = bool(torch.equal(a, w))
            errs[form] = max(errs[form], float((a - w).abs().max()))
            del a, w
        k4.append(row)
        del qr, sr
        _free()
    return {"wkv6_bwd": wkv, "k4": k4,
            "max_abs_err": {"wkv6": wkv["forward_y_max_abs_err"],
                            "wkv6_bwd": wkv["max_abs_err"], **errs}}


def train_tp_rank(serve_mesh, ones: dict) -> dict:
    """One rank of (1), (2), (4) and (5)'s world of two gloo ranks sharing
    the card, (data=1, model=2); rank 0 also runs each world of one of (1),
    (4) and (5) (the other rank waits at its next collective). The float32
    guards' world of one is ``ones`` (``world_of_one``'s, run before the
    world spawns): each rank compares its slices."""
    grid = make_mesh((1, 2), ("data", "model"), device=str(serve_mesh.device))
    lead = grid.rank == 0
    out = {}
    # (1) gemma3-1b at full width and depth, 'tp' (the world of one's step 1)
    cfg = get_config(TP_ARCH)
    shape = ShapeSpec("train_4k_cut", TP_SEQ, TP_BATCH, "train")
    tcfg = TrainStepConfig(microbatches=TP_MB)
    tcfgs = {"tp": tcfg,
             "tp_sp": TrainStepConfig(microbatches=TP_MB, strategy="tp_sp"),
             "fsdp": TrainStepConfig(strategy="fsdp")}
    if lead:
        out["tp_one"] = _tp_steps(_local_grid(), cfg, shape, tcfg, 1)
    out["tp"] = _tp_steps(grid, cfg, shape, tcfg, TP_STEPS)
    # (2) the float32 guard, every strategy against one world of one
    cut = _cut_cfg(TP_ARCH, TP_F32_LAYERS)
    path = ones[(TP_ARCH, TP_F32_LAYERS)]["path"]
    out["f32"] = {}
    for name, tc in tcfgs.items():
        loss, gaps = _tp_grads(grid, cut, shape, tc, want=path)
        out["f32"][name] = {"loss": loss, "gaps": gaps}
    # (4) 'tp_sp' and 'fsdp' in bf16 at TP_SP_LAYERS layers, step 1
    cut = dataclasses.replace(cfg, n_layers=TP_SP_LAYERS)
    if lead:
        out["sp_one"] = _tp_steps(_local_grid(), cut, shape, tcfg, 1,
                                  leaf_norms=True)
        # a rounding control: the world of one in one microbatch of 2 rows
        out["sp_one_mb1"] = _tp_steps(_local_grid(), cut, shape,
                                      TrainStepConfig(), 1, leaf_norms=True)
    for name in ("tp_sp", "fsdp"):
        out[name] = _tp_steps(grid, cut, shape, tcfgs[name], 1,
                              leaf_norms=True)
    # (7) whole experts under 'tp_sp', every dispatch's kept slots
    out["moe_whole"] = {}
    for name, cf in TP_MOE_WHOLE:
        with lm_moe.recorded_keeps() as keeps:
            loss, gaps = _tp_grads(grid, _moe_whole_cfg(cf), shape,
                                   tcfgs["tp_sp"], want=ones[name]["path"])
        out["moe_whole"][name] = {"loss": loss, "gaps": gaps, "keeps": [
            k_.cpu().numpy() for k_ in keeps]}
    # (5) rwkv6-3b 'tp', TP_RWKV_LAYERS layers
    rcfg = dataclasses.replace(get_config(TP_RWKV_ARCH),
                               n_layers=TP_RWKV_LAYERS)
    if lead:
        out["rwkv_one"] = _tp_steps(_local_grid(), rcfg, shape, tcfg, 1)
    with _k6_calls() as heads:
        out["rwkv"] = _tp_steps(grid, rcfg, shape, tcfg, 1)
    out["rwkv"]["k6_calls_by_heads"] = {f"{n} H{h}": v for (n, h), v
                                        in sorted(heads.items())}
    # ... its float32 guard, every leaf, at TP_RWKV_F32_LAYERS layer
    cut = _cut_cfg(TP_RWKV_ARCH, TP_RWKV_F32_LAYERS)
    loss, gaps = _tp_grads(grid, cut, shape, tcfg, want=ones[
        (TP_RWKV_ARCH, TP_RWKV_F32_LAYERS)]["path"])
    out["rwkv_guard"] = {"loss": loss, "gaps": gaps}
    return out


def train_tp_pod_rank(serve_mesh) -> dict:
    """One rank of (3)'s world of four gloo ranks sharing the card, (pod=2,
    data=1, model=2): exact and int8-over-"pod" steps."""
    grid = make_mesh((2, 1, 2), ("pod", "data", "model"),
                     device=str(serve_mesh.device))
    cfg = dataclasses.replace(get_config(TP_ARCH), n_layers=TP_POD_LAYERS)
    shape = ShapeSpec("train_4k_cut", TP_SEQ, TP_BATCH, "train")
    return {name: _tp_steps(grid, cfg, shape,
                            TrainStepConfig(compression_bits=bits),
                            TP_POD_STEPS, k4_shapes=True)
            for name, bits in (("exact", None), ("int8", 8))}


def _rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def run_train_tp() -> dict:
    """Phase ``train_tp``: tensor parallelism over "model" on gloo ranks
    sharing the card, (1)-(6) above. Every check is read before the phase's
    line is printed, and the phase fails after it if any failed. Returns
    this phase's launches of K4 and K6 (summed over ranks and steps) by
    kernel and by shape."""
    import tempfile
    t_phase = time.perf_counter()
    kernels = check_train_tp_kernels()
    t_kernels = time.perf_counter() - t_phase
    store_dir = tempfile.mkdtemp(prefix="amp_train_tp_")
    ones = world_of_one(
        [((TP_ARCH, TP_F32_LAYERS), _cut_cfg(TP_ARCH, TP_F32_LAYERS), False),
         ((TP_RWKV_ARCH, TP_RWKV_F32_LAYERS),
          _cut_cfg(TP_RWKV_ARCH, TP_RWKV_F32_LAYERS), True)]
        + [(name, _moe_whole_cfg(cf), False) for name, cf in TP_MOE_WHOLE],
        ShapeSpec("train_4k_cut", TP_SEQ, TP_BATCH, "train"),
        TrainStepConfig(microbatches=TP_MB), store_dir)
    t_one = time.perf_counter() - t_phase - t_kernels
    two = spawn_world(train_tp_rank, 2, backend="gloo", device=str(DEV),
                      store_path=os.path.join(store_dir, "tp2"),
                      args=(ones,), timeout_s=600)
    for rec in ones.values():
        os.remove(rec["path"])
    t_two = time.perf_counter() - t_phase - t_kernels - t_one
    four = spawn_world(train_tp_pod_rank, 4, backend="gloo",
                       device=str(DEV),
                       store_path=os.path.join(store_dir, "tp4"),
                       timeout_s=400)
    failed = []

    def check(ok, what, *detail):
        if not ok:
            failed.append([what, *detail])

    lead = two[0]
    # (6) the kernels at this phase's shapes
    wkv = kernels["wkv6_bwd"]
    check(wkv["backward_ok"] and wkv["bit_identical"] and wkv["forward_ok"],
          "K6 at the train_tp shape", wkv)
    for row in kernels["k4"]:
        check(all(v for key, v in row.items() if key != "N"),
              "K4 at a train_tp chunk", row)
    # (1) tp against the world of one; the rules' bytes
    one, tp = lead["tp_one"], lead["tp"]
    for r in two:
        check(r["tp"]["loss"] == tp["loss"], "tp ranks' losses",
              r["tp"]["loss"], tp["loss"])
        for key in ("tp", "tp_sp", "fsdp", "rwkv"):
            check(r[key]["bytes"] == r[key]["rules_bytes"],
                  f"{key} bytes", r[key]["bytes"], r[key]["rules_bytes"])
    gaps = {"loss_rel_step1": _rel_gap(tp["loss"][0], one["loss"][0]),
            "grad_norm_rel_step1": _rel_gap(tp["grad_norm"][0],
                                            one["grad_norm"][0]),
            "bytes_over_model_one": {
                k_: tp["bytes"][k_] / one["bytes"][k_] for k_ in tp["bytes"]}}
    check(gaps["loss_rel_step1"] <= TP_LOSS_RTOL, "tp loss", gaps)
    check(gaps["grad_norm_rel_step1"] <= TP_NORM_RTOL, "tp grad norm", gaps)
    check(tp["loss"][-1] < tp["loss"][0], "tp loss falls", tp["loss"])
    # (2) the float32 guard, each strategy
    f32_one = ones[(TP_ARCH, TP_F32_LAYERS)]
    f32 = {}
    for name, got in lead["f32"].items():
        g = f32[name] = {
            "loss": got["loss"], "loss_one": f32_one["loss"],
            "loss_rel": _rel_gap(got["loss"], f32_one["loss"]),
            "grad_gap_of_scale": _merge_gaps([r["f32"][name]["gaps"]
                                              for r in two])}
        g["worst_leaf"] = max(g["grad_gap_of_scale"].items(),
                              key=lambda kv: kv[1])
        check(g["loss_rel"] <= TP_F32_LOSS, f"{name} float32 loss",
              g["loss_rel"])
        check(g["worst_leaf"][1] <= TP_F32_GRAD, f"{name} float32 leaves",
              g["worst_leaf"])
    # (4) tp_sp and fsdp in bf16 against the world of one
    sp_one, strategies = lead["sp_one"], {}
    mb1 = lead["sp_one_mb1"]
    strategies["control_one_microbatch"] = {
        "loss_rel": _rel_gap(mb1["loss"][0], sp_one["loss"][0]),
        "grad_norm_rel": _rel_gap(mb1["grad_norm"][0],
                                  sp_one["grad_norm"][0]),
        "leaf_norm_rel": {k_: _rel_gap(mb1["leaf_norms"][k_], v)
                          for k_, v in sp_one["leaf_norms"].items() if v > 0}}
    for key, ref in (("tp_sp", sp_one), ("fsdp", mb1)):
        run = lead[key]
        leaves = {k_: _rel_gap(run["leaf_norms"][k_], v)
                  for k_, v in ref["leaf_norms"].items() if v > 0}
        strategies[key] = {
            "world_of_one": ("2 microbatches of 1 row" if ref is sp_one
                             else "1 microbatch of 2 rows"),
            "loss": run["loss"][0], "loss_one": ref["loss"][0],
            "loss_rel": _rel_gap(run["loss"][0], ref["loss"][0]),
            "grad_norm": run["grad_norm"][0],
            "grad_norm_one": ref["grad_norm"][0],
            "grad_norm_rel": _rel_gap(run["grad_norm"][0],
                                      ref["grad_norm"][0]),
            "grad_norm_rel_other_one": _rel_gap(
                run["grad_norm"][0],
                (mb1 if ref is sp_one else sp_one)["grad_norm"][0]),
            "leaf_norm_rel": leaves,
            "leaf_norms_one": ref["leaf_norms"]}
        check(strategies[key]["loss_rel"] <= TP_LOSS_RTOL, f"{key} loss",
              strategies[key]["loss_rel"])
        check(strategies[key]["grad_norm_rel"] <= TP_NORM_RTOL,
              f"{key} grad norm", strategies[key]["grad_norm_rel"])
    # (5) rwkv6-3b
    rwkv, r_one = lead["rwkv"], lead["rwkv_one"]
    r_gap = _rel_gap(rwkv["loss"][0], r_one["loss"][0])
    check(r_gap <= TP_LOSS_RTOL, "rwkv loss", rwkv["loss"], r_one["loss"])
    r_f32_one = ones[(TP_RWKV_ARCH, TP_RWKV_F32_LAYERS)]
    guard = {"loss": lead["rwkv_guard"]["loss"],
             "loss_one": r_f32_one["loss"],
             "loss_rel": _rel_gap(lead["rwkv_guard"]["loss"],
                                  r_f32_one["loss"]),
             "grad_gap_of_scale": _merge_gaps([r["rwkv_guard"]["gaps"]
                                               for r in two]),
             "jitter_control_gap_of_scale": r_f32_one["control"]}
    ctl = guard["jitter_control_gap_of_scale"]
    guard["gap_of_limit"] = {
        k_: v / max(TP_F32_GRAD, TP_RWKV_CONTROL * ctl[k_])
        for k_, v in guard["grad_gap_of_scale"].items()}
    guard["worst_leaf"] = max(guard["gap_of_limit"].items(),
                              key=lambda kv: kv[1])
    check(guard["loss_rel"] <= TP_F32_LOSS, "rwkv float32 loss",
          guard["loss_rel"])
    check(guard["worst_leaf"][1] <= 1.0, "rwkv float32 leaves",
          guard["worst_leaf"])
    half = get_config(TP_RWKV_ARCH).n_heads // 2
    check(half == WKV_TP_CASE[3], "K6 checked at the path's heads", half)
    for r in two:
        calls = r["rwkv"]["k6_calls_by_heads"]
        check(set(calls) == {f"wkv6 H{half}", f"wkv6_bwd H{half}"},
              "K6 heads", calls)
        got = r["rwkv"]["launches"][0]
        check(got.get("wkv6", 0) > 0 and got.get("wkv6_bwd", 0) > 0,
              "K6 launches", got)
    # (3) int8 over "pod" at (2, 1, 2)
    for r in four:
        for i, got in enumerate(r["int8"]["launches"]):
            k4 = {k_: got.get(k_, 0) for k_ in TRAIN_K4}
            check(k4 == TRAIN_K4, "K4 launches an int8 step", i, got)
        for got in r["exact"]["launches"]:
            check(not any(got.get(k_, 0) for k_ in TRAIN_K4),
                  "no K4 in an exact step", got)
        check(all(np.isfinite(r["int8"]["loss"] + r["exact"]["loss"])),
              "pod losses finite", r["int8"]["loss"], r["exact"]["loss"])
        check(all(a != b for a, b in zip(r["int8"]["loss"][1:],
                                         r["exact"]["loss"][1:])),
              "int8 not exact", r["int8"]["loss"], r["exact"]["loss"])
        pod = r["int8"]["collectives"][0]["pod"]["bytes"]
        check(set(pod.get("all_to_all", {})) == {"uint8"}, "int8 wire", pod)
        x8, ex = r["int8"], r["exact"]
        check(_rel_gap(x8["grad_norm"][0], ex["grad_norm"][0])
              <= TP_INT8_NORM, "int8 step-1 gradient norm",
              x8["grad_norm"][0], ex["grad_norm"][0])
        check(all(abs(a - b) <= TZ_INT8_REL * abs(b)
                  for a, b in zip(x8["loss"], ex["loss"])),
              "int8 losses", x8["loss"], ex["loss"])
        for got in r["int8"].get("k4_by_shape", []):
            unchecked = {key for key in got if int(key.split(" N")[-1])
                         not in TP_K4_CHUNKS}
            check(not unchecked, "K4 at an unchecked chunk", unchecked)
    # (7) whole experts under 'tp_sp'
    moe_whole = _moe_whole_checks(ones, [r["moe_whole"] for r in two],
                                  check)
    pod_gap = abs(four[0]["int8"]["loss"][-1] - four[0]["exact"]["loss"][-1])
    pod_norm_gap = _rel_gap(four[0]["int8"]["grad_norm"][0],
                            four[0]["exact"]["grad_norm"][0])
    # this phase's launches of K4 and K6, every rank and step
    launches, by_shape = collections.Counter(), collections.Counter()
    for r in two:
        for key in ("tp", "tp_sp", "fsdp", "rwkv"):
            for got in r[key]["launches"]:
                launches.update({k_: v for k_, v in got.items()
                                 if k_ in TP_KERNELS})
        by_shape.update(r["rwkv"]["k6_calls_by_heads"])
    for r in four:
        for name in ("exact", "int8"):
            for got in r[name]["launches"]:
                launches.update({k_: v for k_, v in got.items()
                                 if k_ in TP_KERNELS})
            for got in r[name].get("k4_by_shape", []):
                by_shape.update(got)
    per_step = lambda run: [{key: run[key][i] for key in (
        "loss", "grad_norm", "ms", "wall_ms", "peak_gb", "collectives")}
        for i in range(len(run["loss"]))]
    emit("train_tp", card=nvidia_smi_line(),
         note="gloo ranks sharing one card: times are oversubscription, "
              "not scaling",
         reduced=TP_REDUCED, failed=failed,
         gemma3_1b_tp={"ranks": [per_step(r["tp"]) for r in two],
                       "world_of_one": per_step(one),
                       "bytes": tp["bytes"], "rules_bytes": tp["rules_bytes"],
                       "bytes_model_one": one["bytes"], **gaps},
         float32_guard=f32,
         strategies=strategies,
         pod_int8={"ranks": [{name: per_step(r[name]) for name in r}
                             for r in four],
                   "k4_launches_per_step": {k_: four[0]["int8"]["launches"][
                       0].get(k_, 0) for k_ in TRAIN_K4},
                   "k4_calls_by_shape_rank0": four[0]["int8"]["k4_by_shape"],
                   "int8_exact_gap_last_step": pod_gap,
                   "int8_exact_grad_norm_rel_step1": pod_norm_gap},
         rwkv6_3b_tp={"ranks": [per_step(r["rwkv"]) for r in two],
                      "world_of_one": per_step(r_one), "loss_rel": r_gap,
                      "k6_calls_by_heads": [r["rwkv"]["k6_calls_by_heads"]
                                            for r in two],
                      "float32_guard": guard},
         moe_whole_experts_tp_sp=moe_whole,
         kernels_at_phase_shapes=kernels,
         launches=dict(launches), launches_by_shape=dict(by_shape),
         limits={"loss_rel": TP_LOSS_RTOL, "grad_norm_rel": TP_NORM_RTOL,
                 "float32_loss_rel": TP_F32_LOSS,
                 "float32_grad_of_scale": TP_F32_GRAD,
                 "rwkv_float32_grad_of_control": TP_RWKV_CONTROL,
                 "int8_grad_norm_rel_step1": TP_INT8_NORM,
                 "int8_loss_of_exact": TZ_INT8_REL,
                 "wkv6_bwd_rtol_of_scale": WKV_BWD_RTOL,
                 "wkv6_rtol_atol": WKV_TOL, "k4": "bit-identical",
                 "k4_launches_per_int8_step": TRAIN_K4},
         seconds_kernel_checks=t_kernels, seconds_worlds_of_one=t_one,
         seconds_two_ranks=t_two, seconds=time.perf_counter() - t_phase)
    assert not failed, failed
    return {"launches": dict(launches), "by_shape": dict(by_shape),
            "max_abs_err": kernels["max_abs_err"]}


# ---------------------------------------------------------------------------
# sharded LM serving (phase serve_tp): build_serve_step over "model"
# ---------------------------------------------------------------------------

# (a) gemma3-1b at full width and depth on (data 1, model 2): B=8, prompts
# of 1000, 32 greedy steps from the prompt's last token at position 1000,
# a cache of 1032 rows (516 a rank). Prefill's last-64 logits and every
# decode step's logits (the two ranks teacher-forced on the world of one's
# ids) against the world of one at the bf16 serving limits (LM_RTOL /
# LM_ATOL, PERF.md §2), the ids compared; K5's slice form launched on each
# rank where its rows meet the position's window and nowhere else (worked
# out from the positions: rank 0 holds none of a local window past 1026)
ST_ARCH, ST_BATCH, ST_PROMPT, ST_GEN = "gemma3-1b", 8, 1000, 32
# (b) rwkv6-3b at full width and depth on (1, 2): B=4 x 1000, 32 steps, K6
# at H = 20 in prefill. Float32 weights (its random init amplifies bf16
# rounding through 32 layers: PERF.md, LM serving), logits within
# LM_F32_TOL of their scale
ST_RWKV, ST_RWKV_BATCH = "rwkv6-3b", 4
# (c) the batch-1 long-context form: gemma3-1b at (data 2, model 2), B=1, a
# prompt of 16384 and 32 steps, the cache of 16416 rows over ("data",
# "model"), 4104 rows a rank; at full depth
ST_LONG_PROMPT = 16384
# (d) float32 guards at 2 layers on (1, 2): prefill's logits and 4
# teacher-forced decode steps' within ST_F32_TOL of their scale of the world
# of one's; B=2, prompts of 1040 (qwen2-vl's 1024 vision embeddings, random
# from SEED, and 16 text tokens)
ST_F32_ARCHS = ("gemma3-1b", "qwen2-vl-7b", "qwen3-moe-30b-a3b",
                "mixtral-8x7b")
ST_F32_LAYERS, ST_F32_BATCH, ST_F32_PROMPT, ST_F32_GEN = 2, 2, 1040, 4
ST_F32_TOL = 1e-5
# (e) K5's slice form against its plain version: float32 output within one
# bf16 ulp of the value (2^-7 relative, as the one-device form's bf16
# check), the log-sum-exp within ST_LSE_TOL; bit-identical over two calls
ST_LSE_TOL = 1e-4
# (f) the dry-run's count of (a)'s rank bytes (parameters + decode state)
# against the rise of torch.cuda.memory_allocated as they are placed: within
# the caching allocator's rounding, 512 bytes a tensor
ST_ALLOC_ROUND = 512
ST_REDUCED = {"gemma3-1b (1, 2)": "none (26 layers, B=8 x 1000, 32 steps)",
              "rwkv6-3b (1, 2)": "none (32 layers); float32 weights",
              "gemma3-1b (2, 2) B=1": "none (26 layers, 16384 + 32)",
              "float32 guards": f"{ST_F32_LAYERS} layers, B={ST_F32_BATCH}"}
# the dry-run's cells (on meta, a CPU subprocess beside the card's phases,
# read after the last: qwen3-moe-30b-a3b's 32k prefill on pod2 takes ~6
# minutes of one host core; recurrentgemma's decode runs its LRU columns
# and the head_dim fallback)
ST_DRYRUN = (("gemma3-1b", "decode_32k", "pod1"),
             ("qwen3-moe-30b-a3b", "prefill_32k", "pod2"),
             ("recurrentgemma-2b", "decode_32k", "pod1"),
             ("rwkv6-3b", "long_500k", "pod1"))


def _slice_launches(n_layers_kinds, rows: int, row0: int, positions) -> int:
    """K5's slice-form launches a rank makes: one per layer and position
    whose window meets its rows (``slice_rows``)."""
    return sum(slice_rows(rows, row0, p, w) is not None
               for p in positions for w in n_layers_kinds)


def _windows(cfg) -> list:
    return [cfg.window if k == "local" else 0 for k in cfg.attn_kinds]


def _serve_world(mesh, cfg, batch, prompt, gen, params_full, fed=None,
                 aux=None, state_dtype=torch.bfloat16) -> dict:
    """Prefill and ``gen`` decode steps of ``cfg`` on ``mesh`` from the
    whole ``params_full`` (this rank's slices cut here): greedy on its own
    ids, or fed the ids ``fed`` (B, gen) (teacher-forced). On this rank:
    the prefill logits and each step's (every vocab column, its rows), the
    greedy ids, the launches, times and "model" bytes of a step."""
    pre = build_serve_step(cfg, mesh, ShapeSpec("p", prompt, batch,
                                                "prefill"))
    dec = build_serve_step(cfg, mesh, ShapeSpec("d", prompt + gen, batch,
                                                "decode"))
    params = pre.shard_params(params_full)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (batch, prompt))).to(DEV)
    mine = toks[pre.row0:pre.row0 + pre.rows]
    model_mesh = mesh.axis("model") if "model" in mesh.shape else None
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = pre(params, mine, aux)
    state = dec.to_decode_state(caches, dtype=state_dtype)
    del caches
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    out = {"rows": (pre.row0, pre.rows), "kv": None if dec.kv.mesh is None
           else (dec.kv.row0, dec.kv.rows, dec.kv.mesh.size),
           "prefill": pre.gather_logits(logits)}
    cur = (mine[:, -1:] if fed is None else fed[pre.row0:pre.row0
                                                + pre.rows, :1])
    steps, ids, bytes_step = [], [], None
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(gen):
        if model_mesh is not None and i == gen - 1:
            model_mesh.stats.reset()
        lg, state = dec(params, cur, state, prompt + i)
        if model_mesh is not None and i == gen - 1:
            bytes_step = model_mesh.stats.snapshot()
        steps.append(dec.gather_logits(lg)[:, 0])
        nxt = dec.greedy(lg)
        ids.append(nxt)
        cur = (nxt if fed is None
               else fed[pre.row0:pre.row0 + pre.rows, i + 1:i + 2])
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t1
    out.update(decode=torch.stack(steps, 1), ids=torch.cat(ids, 1),
               launches={k_: v for k_, v in all_counts().items() if v},
               prefill_ms=1e3 * t_pre, decode_ms_per_step=1e3 * t_dec / gen,
               model_bytes_last_step=bytes_step,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, state
    return out


def _near(got, want, rtol, atol) -> dict:
    """Gap of ``got`` to ``want``: the largest |diff| over the scale, and
    whether every element is within atol + rtol |want|."""
    d = (got.float() - want.float()).abs()
    return {"gap_of_scale": float(d.max() / want.float().abs().max()),
            "max_abs": float(d.max()),
            "ok": bool((d <= atol + rtol * want.float().abs()).all())}


def _ids_agree(ids, want_ids, want_logits, tol) -> dict:
    """The greedy ids against the world of one's: equal, or where they
    differ a near tie in its logits (the top two within ``tol`` of the
    scale)."""
    diff = (ids != want_ids).nonzero().tolist()
    scale = float(want_logits.abs().max())
    ties = []
    for b, i in diff:
        top = torch.topk(want_logits[b, i].float(), 2).values
        ties.append(float(top[0] - top[1]) <= tol * scale)
    return {"equal": len(diff) == 0, "differ_at": diff[:8],
            "near_ties": all(ties)}


def _world_of_one_and_fed(mesh, cfg, batch, prompt, gen, full, aux, dtype,
                          lead: bool):
    """Rank 0 runs the world of one (greedy); its ids go to every rank of
    ``mesh`` (``broadcast_object``), which then run fed them."""
    one = None
    if lead:
        one = _serve_world(_local_grid(), cfg, batch, prompt, gen, full,
                           aux=aux, state_dtype=dtype)
        ids = one["ids"].cpu()
        fed = torch.cat([torch.from_numpy(np.random.default_rng(SEED)
                                          .integers(0, cfg.vocab,
                                                    (batch, prompt)))[:, -1:],
                         ids[:, :-1]], 1)
    else:
        fed = None
    fed = broadcast_object(fed, mesh.axes(tuple(mesh.shape)), 0).to(DEV)
    return one, fed


def _compare(one, two, rtol, atol, tol_ids) -> dict:
    lo, n = two["rows"]
    rows = slice(lo, lo + n)
    return {"prefill": _near(two["prefill"], one["prefill"][rows], rtol, atol),
            "decode": _near(two["decode"], one["decode"][rows], rtol, atol),
            "ids": _ids_agree(two["ids"], one["ids"][rows],
                              one["decode"][rows], tol_ids)}


def _summary(r) -> dict:
    return {k_: r[k_] for k_ in ("rows", "kv", "launches", "prefill_ms",
                                 "decode_ms_per_step",
                                 "model_bytes_last_step", "peak_gb")}


def serve_tp_rank(serve_mesh) -> dict:
    """One rank of (a), (b), (d) and (f) on (data 1, model 2), gloo ranks
    sharing the card; rank 0 also runs each world of one."""
    grid = make_mesh((1, 2), ("data", "model"), device=str(serve_mesh.device))
    lead = grid.rank == 0
    out = {}
    cfg = get_config(ST_ARCH)
    # (f) the rank's bytes as placed against the dry-run's count
    dec = build_serve_step(cfg, grid, ShapeSpec("d", ST_PROMPT + ST_GEN,
                                                ST_BATCH, "decode"))
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = dec.init_params(SEED)
    m1 = torch.cuda.memory_allocated()
    state = dec.init_state()
    m2 = torch.cuda.memory_allocated()
    counted = serve_argument_bytes(dec)
    out["bytes"] = {"params_allocated": m1 - m0,
                    "state_allocated": m2 - m1,
                    "params_counted": counted["params"],
                    "state_counted": counted["state"],
                    "n_params": len(params),
                    "n_state": len(flat_tree(state))}
    del params, state
    _free()
    # (a)
    full = init_from_schema(schema_for(cfg), torch.Generator(
        device=DEV).manual_seed(SEED), DEV)
    one, fed = _world_of_one_and_fed(grid, cfg, ST_BATCH, ST_PROMPT, ST_GEN,
                                     full, None, torch.bfloat16, lead)
    torch.cuda.reset_peak_memory_stats()
    two = _serve_world(grid, cfg, ST_BATCH, ST_PROMPT, ST_GEN, full, fed)
    del full
    positions = range(ST_PROMPT, ST_PROMPT + ST_GEN)
    lo, rows = two["kv"][0], two["kv"][1]
    out["a"] = {**_summary(two),
                "k5_slice_expected": _slice_launches(_windows(cfg), rows, lo,
                                                     positions)}
    if lead:
        out["a"]["world_of_one"] = _summary(one)
        out["a"]["gaps"] = _compare(one, two, LM_RTOL, LM_ATOL, LM_SMALL_TOL)
    del one, two
    _free()
    # (b) rwkv6-3b, float32 weights
    rcfg = get_config(ST_RWKV)
    full = {k_: v.float() for k_, v in init_from_schema(
        schema_for(rcfg), torch.Generator(device=DEV).manual_seed(SEED),
        DEV).items()}
    one, fed = _world_of_one_and_fed(grid, rcfg, ST_RWKV_BATCH, ST_PROMPT,
                                     ST_GEN, full, None, torch.float32, lead)
    with _k6_calls() as heads:
        two = _serve_world(grid, rcfg, ST_RWKV_BATCH, ST_PROMPT, ST_GEN, full,
                           fed, state_dtype=torch.float32)
    del full
    out["b"] = {**_summary(two),
                "k6_calls_by_heads": {f"{n} H{h}": v for (n, h), v
                                      in sorted(heads.items())}}
    if lead:
        out["b"]["world_of_one"] = _summary(one)
        out["b"]["gaps"] = _compare(one, two, LM_F32_TOL, 0.0, LM_F32_TOL)
    del one, two
    _free()
    # (d) float32 guards, 2 layers
    out["d"] = {}
    for arch in ST_F32_ARCHS:
        c = dataclasses.replace(get_config(arch), n_layers=ST_F32_LAYERS)
        full = {k_: v.float() for k_, v in init_from_schema(
            schema_for(c), torch.Generator(device=DEV).manual_seed(SEED),
            DEV).items()}
        aux = None
        if c.n_vision_tokens:
            g = torch.Generator(device=DEV).manual_seed(SEED + 3)
            aux = {"vision_embeds": torch.randn(
                ST_F32_BATCH, c.n_vision_tokens, c.d_model, generator=g,
                device=DEV)}
        one, fed = _world_of_one_and_fed(grid, c, ST_F32_BATCH, ST_F32_PROMPT,
                                         ST_F32_GEN, full, aux, torch.float32,
                                         lead)
        two = _serve_world(grid, c, ST_F32_BATCH, ST_F32_PROMPT, ST_F32_GEN,
                           full, fed, aux=aux, state_dtype=torch.float32)
        del full
        if lead:
            out["d"][arch] = _compare(one, two, ST_F32_TOL, 0.0, ST_F32_TOL)
        del one, two
        _free()
    return out


def serve_tp_long_rank(serve_mesh) -> dict:
    """One rank of (c): gemma3-1b B=1 at (data 2, model 2), the cache over
    ("data", "model"); rank 0 also runs the world of one."""
    grid = make_mesh((2, 2), ("data", "model"), device=str(serve_mesh.device))
    cfg = get_config(ST_ARCH)
    full = init_from_schema(schema_for(cfg), torch.Generator(
        device=DEV).manual_seed(SEED), DEV)
    one, fed = _world_of_one_and_fed(grid, cfg, 1, ST_LONG_PROMPT, ST_GEN,
                                     full, None, torch.bfloat16,
                                     grid.rank == 0)
    torch.cuda.reset_peak_memory_stats()
    two = _serve_world(grid, cfg, 1, ST_LONG_PROMPT, ST_GEN, full, fed)
    positions = range(ST_LONG_PROMPT, ST_LONG_PROMPT + ST_GEN)
    lo, rows = two["kv"][0], two["kv"][1]
    out = {**_summary(two),
           "k5_slice_expected": _slice_launches(_windows(cfg), rows, lo,
                                                positions)}
    if grid.rank == 0:
        out["world_of_one"] = _summary(one)
        out["gaps"] = _compare(one, two, LM_RTOL, LM_ATOL, LM_SMALL_TOL)
    return out


def slice_bound(b, h, kv, dh, rows, dtype) -> dict:
    """K5's slice form's least time: q read, the float32 output and
    log-sum-exp written, K and V of the rows read once; operations as
    ``decode_attn_bound``."""
    e = 2 if dtype == torch.bfloat16 else 4
    nbytes = b * h * dh * e + 4 * b * h * (dh + 1) + 2 * rows * b * kv * dh * e
    return bound(nbytes, 4.0 * b * h * dh * rows + 5.0 * b * h * rows)


# (name, B, H, KV, Dh, slice rows, row0, pos, window): (a)'s slices at its
# first and last steps, global and local (rank 0's local slice at the last
# step is empty), and (c)'s
ST_SLICE_CASES = [
    ("a_rank0_global_last", 8, 4, 1, 256, 516, 0, 1031, 0),
    ("a_rank1_global_last", 8, 4, 1, 256, 516, 516, 1031, 0),
    ("a_rank0_local_first", 8, 4, 1, 256, 516, 0, 1000, 512),
    ("a_rank1_local_last", 8, 4, 1, 256, 516, 516, 1031, 512),
    ("a_rank0_local_last_empty", 8, 4, 1, 256, 516, 0, 1031, 512),
    ("c_rank0_global_last", 1, 4, 1, 256, 4104, 0, 16415, 0),
    ("c_rank3_global_last", 1, 4, 1, 256, 4104, 12312, 16415, 0),
    ("c_rank3_local_last", 1, 4, 1, 256, 4104, 12312, 16415, 512)]
# the timed ones: (a)'s and (c)'s global layer on the rank whose rows hold
# the position
ST_SLICE_TIMED = {"decode_attn_slice": "a_rank1_global_last",
                  "decode_attn_slice/long_b1": "c_rank3_global_last"}


def check_slice_kernel(cases=None) -> dict:
    """(e) K5's slice form against its plain version at ``cases``
    (ST_SLICE_CASES); an empty slice writes (0, -inf) and launches
    nothing."""
    rows = []
    for name, b, h, kv, dh, s, row0, pos, win in cases or ST_SLICE_CASES:
        q, kc_, vc_ = da_inputs(b, h, kv, dh, s, torch.bfloat16,
                                torch.bfloat16, SEED)
        before = kd.launch_counts["decode_attn_slice"]
        o, lse = kd.decode_attn_slice_cuda(q, kc_, vc_, pos, win, row0)
        o2, lse2 = kd.decode_attn_slice_cuda(q, kc_, vc_, pos, win, row0)
        launched = kd.launch_counts["decode_attn_slice"] - before
        wo, wl = decode_attn_slice_ref(q, kc_, vc_, pos, win, row0)
        torch.cuda.synchronize()
        empty = slice_rows(s, row0, pos, win) is None
        d = (o - wo).abs()
        fin = torch.isfinite(wl)
        row = {"case": name, "B": b, "S_rank": s, "row0": row0, "pos": pos,
               "window": win, "empty": empty, "launches": launched,
               "max_abs_err": float(d.max()),
               "lse_max_abs_err": float((lse[fin] - wl[fin]).abs().max())
               if bool(fin.any()) else 0.0,
               "bit_identical": bool(torch.equal(o, o2)
                                     and torch.equal(lse, lse2))}
        row["ok"] = (row["bit_identical"]
                     and bool((d <= 2.0 ** -7 * wo.abs() + 1e-6).all())
                     and bool(torch.equal(torch.isfinite(lse), fin))
                     and row["lse_max_abs_err"] <= ST_LSE_TOL
                     and launched == (0 if empty else 2)
                     and (not empty or (bool((o == 0).all())
                                        and not bool(fin.any()))))
        rows.append(row)
        del q, kc_, vc_, o, o2, lse, lse2, wo, wl
    return {r["case"]: r for r in rows}


def time_slice_kernel(timed=None, cases=None) -> dict:
    """K5's slice form at ``timed`` (ST_SLICE_TIMED, of ``cases``): the
    kernel, its plain version and ``scaled_dot_product_attention`` over
    the same slice (GQA, the boolean mask of the rows the position attends
    to: the normalised output alone), L2-hot, beside the bound."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for key, case in (timed or ST_SLICE_TIMED).items():
        _, b, h, kv, dh, s, row0, pos, win = next(
            c for c in cases or ST_SLICE_CASES if c[0] == case)
        q, kc_, vc_ = da_inputs(b, h, kv, dh, s, torch.bfloat16,
                                torch.bfloat16, SEED)
        lo, hi = slice_rows(s, row0, pos, win)
        t_idx = torch.arange(s, device=DEV)
        mask = ((t_idx >= lo) & (t_idx <= hi))[None, None, None]
        q4, k_t, v_t = (q[:, :, None], kc_.transpose(1, 2).contiguous(),
                        vc_.transpose(1, 2).contiguous())
        calls = {key: {
            "ms": lambda: kd.decode_attn_slice_cuda(q, kc_, vc_, pos, win,
                                                    row0),
            "plain_ms": lambda: decode_attn_slice_ref(q, kc_, vc_, pos, win,
                                                      row0),
            "library_ms": lambda: sdpa(q4, k_t, v_t, attn_mask=mask,
                                       enable_gqa=True)}}
        row = _time_calls(calls, {key: slice_bound(
            b, h, kv, dh, hi - lo + 1, torch.bfloat16)})[key]
        row.update(case=case, B=b, S_rank=s, row0=row0, pos=pos,
                   rows_read=hi - lo + 1,
                   plan=da_plan(b, h, kv, dh, lo, hi, torch.bfloat16))
        out[key] = row
        del q, kc_, vc_, q4, k_t, v_t
    return out


_DRYRUN: dict = {}


def start_dryrun() -> None:
    """The dry-run's ST_DRYRUN cells on meta in a CPU subprocess, started
    after the build and read by ``finish_dryrun`` after the last phase
    (qwen3-moe's 32k prefill takes minutes to trace)."""
    import tempfile
    out = os.path.join(tempfile.mkdtemp(prefix="amp_dryrun_"), "dryrun.json")
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.launch.dryrun import run_cell; import json; "
            f"cells = {list(ST_DRYRUN)!r}; "
            "recs = [run_cell(a, s, m) for a, s, m in cells]; "
            f"json.dump(recs, open({out!r}, 'w'))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    _DRYRUN.update(out=out, t0=time.perf_counter(), proc=subprocess.Popen(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    atexit.register(stop_dryrun)   # also when a check fails before its end


def stop_dryrun() -> None:
    """Ends the dry-run's subprocess if it still runs (a failed phase)."""
    proc = _DRYRUN.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


def read_dryrun() -> tuple:
    """(records, seconds, stderr's tail) of the dry-run's subprocess, which
    gets up to 1100 s from its start."""
    proc = _DRYRUN["proc"]
    left = 1100 - (time.perf_counter() - _DRYRUN["t0"])
    try:
        _, err = proc.communicate(timeout=max(1.0, left))
    finally:
        stop_dryrun()
    seconds = time.perf_counter() - _DRYRUN["t0"]
    if proc.returncode != 0:
        return None, seconds, err.decode()[-2000:]
    with open(_DRYRUN["out"]) as fh:
        return json.load(fh), seconds, ""


def finish_dryrun() -> None:
    """Phase ``dryrun``: the subprocess's records, each cell ok (the rules'
    argument bytes, FLOPs and collectives of rank 0's count); fails if the
    subprocess did not end well or a cell stopped."""
    recs, seconds, err = read_dryrun()
    failed = [] if recs is not None else [["dry-run subprocess", err]]
    for rec in recs or []:
        rec.pop("traceback", None)
        if not rec["ok"]:
            failed.append(["dry-run cell", rec])
    emit("dryrun", cells=recs, seconds_since_start=seconds, failed=failed,
         note="rank 0's count on a counting mesh, meta tensors, a CPU "
              "subprocess started after the build")
    assert not failed, failed


def run_serve_tp() -> dict:
    """Phase ``serve_tp``: (a)-(f) above on gloo ranks sharing the card
    (the dry-run's cells are ``finish_dryrun``'s). Every check is read
    before the phase's line is printed, and the phase fails after it if any
    failed. Returns the slice form's rows for the kernels line."""
    import tempfile
    t_phase = time.perf_counter()
    store_dir = tempfile.mkdtemp(prefix="amp_serve_tp_")
    slices = check_slice_kernel()
    two = spawn_world(serve_tp_rank, 2, backend="gloo", device=str(DEV),
                      store_path=os.path.join(store_dir, "st2"),
                      timeout_s=900)
    t_two = time.perf_counter() - t_phase
    four = spawn_world(serve_tp_long_rank, 4, backend="gloo",
                       device=str(DEV),
                       store_path=os.path.join(store_dir, "st4"),
                       timeout_s=600)
    t_four = time.perf_counter() - t_phase - t_two
    times = time_slice_kernel()
    t_card = time.perf_counter() - t_phase
    failed = []

    def check(ok, what, *detail):
        if not ok:
            failed.append([what, *detail])

    for name, row in slices.items():
        check(row["ok"], "K5 slice form", row)
    lead = two[0]
    for key in ("a",):
        g = lead[key]["gaps"]
        check(g["prefill"]["ok"] and g["decode"]["ok"], f"({key}) logits",
              g["prefill"], g["decode"])
        check(g["ids"]["equal"] or g["ids"]["near_ties"], f"({key}) ids",
              g["ids"])
    g = lead["b"]["gaps"]
    check(g["prefill"]["gap_of_scale"] <= LM_F32_TOL
          and g["decode"]["gap_of_scale"] <= LM_F32_TOL, "(b) logits",
          g["prefill"], g["decode"])
    check(g["ids"]["equal"] or g["ids"]["near_ties"], "(b) ids", g["ids"])
    for arch, g in lead["d"].items():
        check(g["prefill"]["gap_of_scale"] <= ST_F32_TOL
              and g["decode"]["gap_of_scale"] <= ST_F32_TOL,
              f"(d) {arch} logits", g["prefill"], g["decode"])
    g = four[0]["gaps"]
    check(g["prefill"]["ok"] and g["decode"]["ok"], "(c) logits",
          g["prefill"], g["decode"])
    check(g["ids"]["equal"] or g["ids"]["near_ties"], "(c) ids", g["ids"])
    half = get_config(ST_RWKV).n_heads // 2
    launches = collections.Counter()
    for r in two:
        got = r["a"]["launches"].get("decode_attn_slice", 0)
        check(got == r["a"]["k5_slice_expected"], "(a) K5 slice launches",
              got, r["a"]["k5_slice_expected"])
        check(r["a"]["launches"].get("decode_attn", 0) == 0,
              "(a) no one-device K5", r["a"]["launches"])
        calls = r["b"]["k6_calls_by_heads"]
        check(set(calls) == {f"wkv6 H{half}"}, "(b) K6 heads", calls)
        by = r["bytes"]
        check(0 <= by["params_allocated"] - by["params_counted"]
              <= ST_ALLOC_ROUND * by["n_params"], "(f) params bytes", by)
        check(0 <= by["state_allocated"] - by["state_counted"]
              <= ST_ALLOC_ROUND * by["n_state"], "(f) state bytes", by)
        launches["decode_attn_slice"] += got
        launches["wkv6"] += r["b"]["launches"].get("wkv6", 0)
    long_launches = 0
    for r in four:
        got = r["launches"].get("decode_attn_slice", 0)
        check(got == r["k5_slice_expected"], "(c) K5 slice launches", got,
              r["k5_slice_expected"])
        long_launches += got
    emit("serve_tp", card=nvidia_smi_line(),
         note="gloo ranks sharing one card: times are oversubscription, "
              "not scaling",
         reduced=ST_REDUCED, failed=failed,
         gemma3_1b=[{k_: v for k_, v in r["a"].items()} for r in two],
         rwkv6_3b=[r["b"] for r in two],
         long_b1=four, float32_guards=lead["d"],
         bytes_vs_dryrun=[r["bytes"] for r in two],
         k5_slice_checks=slices,
         limits={"bf16_rtol": LM_RTOL, "bf16_atol": LM_ATOL,
                 "rwkv_float32_of_scale": LM_F32_TOL,
                 "float32_guard_of_scale": ST_F32_TOL,
                 "k5_slice": "1 bf16 ulp of the value; lse "
                             f"{ST_LSE_TOL} abs",
                 "alloc_round_per_tensor": ST_ALLOC_ROUND},
         seconds_two_ranks=t_two, seconds_four_ranks=t_four,
         seconds_on_card=t_card, seconds=time.perf_counter() - t_phase)
    assert not failed, failed
    err_of = lambda names: max(slices[n]["max_abs_err"] for n in names)
    rows = []
    for key, n in (("decode_attn_slice", launches["decode_attn_slice"]),
                   ("decode_attn_slice/long_b1", long_launches)):
        tm = times[key]
        prefix = "a_" if key == "decode_attn_slice" else "c_"
        rows.append({
            "name": key, "route": "cuda", "source": SOURCES["decode_attn"],
            "replaces": REPLACES["decode_attn"], "launches": n,
            "max_abs_err": err_of([c for c in slices if c.startswith(prefix)]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})
        assert n > 0, (key, n)
    return {"rows": rows, "wkv6_launches": launches["wkv6"]}


# ---------------------------------------------------------------------------
# the "model" axis across the zoo (phase tp_zoo): the head_dim fallback,
# recurrentgemma and whisper over "model", K6's value-column form
# ---------------------------------------------------------------------------

# (a) recurrentgemma-2b at full width and depth on (data 1, model 4): its 10
# heads do not divide 4, so the local attention takes the head_dim fallback
# (256 / 4 columns a rank) and the recurrent blocks the rank's 640 LRU
# columns. B=2, prompts of 3000, 16 greedy steps: a cache of 3016 rows, 754
# a rank, whose window of 2048 misses rank 0 and crosses rank 1's edge.
# Logits and ids against the world of one at the bf16 serving limits
# (LM_RTOL / LM_ATOL), K5's slice form launched where the window meets the
# rank's rows (worked out from the positions)
TPZ_RGLRU, TPZ_RGLRU_MESH = "recurrentgemma-2b", (1, 4)
TPZ_RGLRU_BATCH, TPZ_RGLRU_PROMPT, TPZ_RGLRU_GEN = 2, 3000, 16
# (b) gemma3-1b at full width and depth on (1, 8): 4 heads on 8, the
# head_dim fallback (32 of 256 columns a rank; its one K/V head's too).
# B=2, prompts of 508 and 4 steps (a step takes ~2.8 s a rank: 157
# host-staged collectives on 8 processes), a cache of 512 rows (64 a rank),
# the same limits
TPZ_GEMMA, TPZ_GEMMA_MESH = "gemma3-1b", (1, 8)
TPZ_GEMMA_BATCH, TPZ_GEMMA_PROMPT, TPZ_GEMMA_GEN = 2, 508, 4
# (c) whisper-small at full width and depth on (1, 2): 12 heads, 6 a rank.
# B=8, 1500 frames, a decoder budget of 448 (prompts of 432 + 16 steps):
# the self cache 224 rows a rank, the cross cache of the 1500 frames 750 a
# rank (the decode rules' "kv_seq" slices both), K5's slice form on each
# and folded; the same limits
TPZ_WHISPER, TPZ_WHISPER_MESH = "whisper-small", (1, 2)
TPZ_WHISPER_BATCH, TPZ_WHISPER_PROMPT, TPZ_WHISPER_GEN = 8, 432, 16
# (d) K6's value-column form against its plain version at rwkv6-3b's train
# microbatch (2 x 4096, 40 heads of 64) with Dv = 32, 16 and 4 value
# columns (a rank's at model 2, 4 and 16): y and the final state within
# TPZ_VC_FWD_TOL of their scale of ``wkv_chunked`` on the same columns; the
# backward within TPZ_VC_BWD_TOL of float64 autograd of ``wkv_chunked``
# (dr, dk, dv beyond one bf16 rounding, as WKV_BWD_CASES); bit-identical
# over two runs; the same at the 16-rank path's own shape and dtype (2 x
# 512, Dv = 4, float32). In float32 at (1, 1024, 40, 64), the four Dv = 16
# slices' partials of dr, dk, dlogw and du summed in rank order against
# float64 autograd of the whole head (what the "model" axis sums)
TPZ_VC_CASES = [("rwkv6_3b_dv32", 2, 4096, 40, 64, 32, torch.bfloat16),
                ("rwkv6_3b_dv16", 2, 4096, 40, 64, 16, torch.bfloat16),
                ("rwkv6_3b_dv4", 2, 4096, 40, 64, 4, torch.bfloat16),
                ("rwkv6_3b_dv4_f32_path", 2, 512, 40, 64, 4, torch.float32)]
TPZ_VC_SUM = ("rwkv6_3b_dv16_f32_sum", 1, 1024, 40, 64, 16, torch.float32)
TPZ_VC_FWD_TOL, TPZ_VC_BWD_TOL = 1.4e-5, 2.0e-6
# ... and rwkv6-3b at full width, 1 of its 32 layers, on (1, 16) (40 heads
# on 16: a rank's 4 value columns of every head), float32 weights: one
# train step of B=2 x 512 (K6 and its backward on the value columns; the
# loss within TPZ_F32_TOL relative, each leaf within TPZ_F32_TOL of its
# scale or TP_RWKV_CONTROL x the world of one's own move under one float32
# rounding, train_tp's rule); then its serving, float32, B=2 x 512 + 4
# greedy steps: prefill with K6 on the value columns, decode through the
# state's conversions between the rules' layout (``wkv`` whole) and the
# rank's value columns; logits within TPZ_F32_TOL of their scale of the
# world of one's, the ids equal (or near ties)
TPZ_RWKV, TPZ_RWKV_MESH, TPZ_RWKV_LAYERS = "rwkv6-3b", (1, 16), 1
TPZ_RWKV_BATCH, TPZ_RWKV_PROMPT, TPZ_RWKV_GEN = 2, 512, 4
# (e) float32 training guards, S = 512, B = 2: step 1's loss and every
# leaf's gradient within TPZ_F32_TOL (relative; of the leaf's scale) of the
# world of one's. gemma3-1b 'tp' and 'tp_sp' and qwen2-vl-7b 'tp' (28
# heads on 8: M-RoPE's sections under the fallback; its vision grid's
# positions, no vision embeddings) on (1, 8) at 2 layers; recurrentgemma-2b
# 'tp' on (1, 4) at 3 layers (2 would be its recurrent tail alone, no
# attention); whisper-small 'tp' on (1, 2) at 2 encoder and 2 decoder
# layers, 1500 frames
TPZ_F32_SEQ, TPZ_F32_BATCH, TPZ_F32_TOL = 512, 2, 1e-5
TPZ_F32_CASES = {8: [("gemma3-1b", 2, "tp"), ("gemma3-1b", 2, "tp_sp"),
                     ("qwen2-vl-7b", 2, "tp")],
                 4: [("recurrentgemma-2b", 3, "tp")],
                 2: [("whisper-small", 2, "tp")]}
TPZ_REDUCED = {
    "recurrentgemma-2b (1, 4)": "none (26 layers, B=2 x 3000, 16 steps)",
    "gemma3-1b (1, 8)": "none (26 layers, B=2 x 508, 4 steps)",
    "whisper-small (1, 2)": "none (12 + 12 layers, B=8 x (1500 + 448))",
    "rwkv6-3b (1, 16)": f"{TPZ_RWKV_LAYERS} of 32 layers (B=2 x 512, "
                        "4 steps)",
    "float32 guards": "2 layers (recurrentgemma 3; whisper 2 + 2), "
                      "S = 512, B = 2"}
# (f) K5's slice form at this phase's shapes, against its plain version
# (check_slice_kernel's rules) and timed beside SDPA on the same slice:
# (a)'s rank 3 and rank 1 (the window crossing its first row), (b)'s rank
# 7, (c)'s self and cross slices of rank 1
TPZ_SLICE_CASES = [
    ("rglru_rank3_last", 2, 10, 1, 256, 754, 2262, 3015, 2048),
    ("rglru_rank1_first", 2, 10, 1, 256, 754, 754, 3000, 2048),
    ("gemma3_m8_rank7_global_last", 2, 4, 1, 256, 64, 448, 511, 0),
    ("gemma3_m8_rank0_local_first", 2, 4, 1, 256, 64, 0, 508, 512),
    ("whisper_self_rank1_last", 8, 12, 12, 64, 224, 224, 447, 0),
    ("whisper_cross_rank1", 8, 12, 12, 64, 750, 750, 1499, 0)]
TPZ_SLICE_TIMED = {"decode_attn_slice/rglru_window": "rglru_rank3_last",
                   "decode_attn_slice/gemma3_m8": "gemma3_m8_rank7_global_last",
                   "decode_attn_slice/whisper_self": "whisper_self_rank1_last",
                   "decode_attn_slice/whisper_cross": "whisper_cross_rank1"}


@contextlib.contextmanager
def _k5_slice_rows():
    """K5's slice-form launches by the rows of the cache slice they read
    (the dispatch's binding of the wrapper wrapped; the wrapper's own
    count, so an empty slice counts nothing)."""
    tally = collections.Counter()
    fn = kd_ops.decode_attn_slice_cuda

    def f(q, k_slice, *a, **kw_):
        before = kd.launch_counts["decode_attn_slice"]
        out = fn(q, k_slice, *a, **kw_)
        tally[k_slice.shape[1]] += kd.launch_counts["decode_attn_slice"] \
            - before
        return out
    kd_ops.decode_attn_slice_cuda = f
    try:
        yield tally
    finally:
        kd_ops.decode_attn_slice_cuda = fn


def _of_scale(got, want, ulp: bool = False) -> float:
    """The largest |got - want| (beyond one bf16 rounding of want with
    ``ulp``) over want's largest magnitude, in float64."""
    g, w = got.double(), want.double()
    d = (g - w).abs()
    if ulp:
        d = (d - 2.0 ** -8 * w.abs()).clamp(min=0.0)
    return float(d.max() / w.abs().max().clamp_min(1e-300))


def _float64_grads(r, k_, v, logw, u, dy):
    """Float64 autograd of ``wkv_chunked`` (dr, dk, dv, dlogw, du)."""
    with torch.enable_grad():
        ins = [x.detach().double().requires_grad_(True)
               for x in (r, k_, v, logw, u)]
        y, _ = wkv_chunked(*ins)
        return torch.autograd.grad((y * dy.double()).sum(), ins)


def check_wkv6_value_cols() -> dict:
    """(d) K6's value-column form: every TPZ_VC_CASES case on rank 1's
    columns (the forward and the backward against their plain versions),
    and TPZ_VC_SUM's slices summed; the path's shape timed."""
    rows = []
    for name, b, t, h, dh, dv, dtype in TPZ_VC_CASES:
        r, k_, v, logw, u, _ = wkv_inputs(b, t, h, dh, dtype, False, SEED)
        v = v[..., dv:2 * dv].contiguous()
        g = torch.Generator(device=DEV).manual_seed(SEED + 1)
        dy = torch.randn(b, t, h, dv, generator=g, device=DEV)
        y, s = kw.wkv6_cuda(r, k_, v, logw, u)
        y2, s2 = kw.wkv6_cuda(r, k_, v, logw, u)
        y_r, s_r = wkv_chunked(r, k_, v, logw, u)
        u32 = u.float().contiguous()
        got = kw.wkv6_bwd_cuda(r, k_, v, logw, u32, None, dy)
        again = kw.wkv6_bwd_cuda(r, k_, v, logw, u32, None, dy)
        want = _float64_grads(r, k_, v, logw, u, dy)
        row = {"case": name, "B": b, "T": t, "H": h, "Dh": dh, "Dv": dv,
               "dtype": str(dtype).split(".")[-1],
               "plan_nv": kw.wkv_plan(b, h, dv, lambda vb: kw.max_active_blocks(
                   DEV, dtype, dh, vb)),
               "bwd_plan_nv": kw.bwd_plan(b, h, dv, lambda n: (
                   kw.max_active_clusters(DEV, dtype, dh, n, dv))),
               "y_err_of_scale": _of_scale(y, y_r),
               "state_err_of_scale": _of_scale(s, s_r),
               "y_max_abs_err": float((y - y_r).abs().max()),
               "bit_identical": bool(
                   torch.equal(y, y2) and torch.equal(s, s2) and all(
                       torch.equal(x, z) for x, z in zip(got, again)
                       if x is not None))}
        for i, key in enumerate(("dr", "dk", "dv", "dlogw", "du")):
            row[f"{key}_err_of_scale"] = _of_scale(
                got[i], want[i], ulp=i < 3 and dtype == torch.bfloat16)
        row["max_abs_err"] = max(float((got[i].double() - want[i]).abs()
                                       .max()) for i in range(5))
        row["ok"] = (row["bit_identical"]
                     and row["y_err_of_scale"] <= TPZ_VC_FWD_TOL
                     and row["state_err_of_scale"] <= TPZ_VC_FWD_TOL
                     and all(row[f"{key}_err_of_scale"] <= TPZ_VC_BWD_TOL
                             for key in ("dr", "dk", "dv", "dlogw", "du")))
        rows.append(row)
        del r, k_, v, logw, u, u32, y, y2, s, s2, y_r, s_r, got, again, want
        _free()
    # the slices' partials summed in rank order, float32
    name, b, t, h, dh, dv, dtype = TPZ_VC_SUM
    r, k_, v, logw, u, _ = wkv_inputs(b, t, h, dh, dtype, False, SEED)
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    dy = torch.randn(b, t, h, dh, generator=g, device=DEV)
    want = _float64_grads(r, k_, v, logw, u, dy)
    sums = None
    for j in range(dh // dv):
        cols = slice(j * dv, (j + 1) * dv)
        part = kw.wkv6_bwd_cuda(r, k_, v[..., cols].contiguous(), logw,
                                u.contiguous(), None,
                                dy[..., cols].contiguous())
        part = [part[i] for i in (0, 1, 3, 4)]
        sums = part if sums is None else [a + p for a, p in zip(sums, part)]
    row = {"case": name, "slices": dh // dv, "Dv": dv}
    for key, got_, w in zip(("dr", "dk", "dlogw", "du"), sums,
                            (want[0], want[1], want[3], want[4])):
        row[f"{key}_err_of_scale"] = _of_scale(got_, w)
    row["ok"] = all(row[f"{key}_err_of_scale"] <= TPZ_VC_BWD_TOL
                    for key in ("dr", "dk", "dlogw", "du"))
    rows.append(row)
    del r, k_, v, logw, u, dy, want, sums
    _free()
    return {"rows": rows, "times": time_wkv6_value_cols()}


def time_wkv6_value_cols() -> dict:
    """K6's value-column form and its backward at the shape and dtype (d)'s
    16-rank path gives them (B=2 x 512, 40 heads of 64, Dv = 4, float32,
    no state), beside their plain versions and bounds; no one PyTorch call
    computes the recurrence."""
    b, t, h, dh = TPZ_F32_BATCH, TPZ_F32_SEQ, 40, 64
    dv, dtype = dh // TPZ_RWKV_MESH[1], torch.float32
    r, k_, v, logw, u, _ = wkv_inputs(b, t, h, dh, dtype, False, SEED)
    v = v[..., :dv].contiguous()
    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    dy = torch.randn(b, t, h, dv, generator=g, device=DEV)
    u32 = u.float().contiguous()
    y, _ = kw.wkv6_cuda(r, k_, v, logw, u)
    y_r, _ = wkv_chunked(r, k_, v, logw, u)
    _, plain = wkv_bwd_plain(r, k_, v, logw, u, None, dy, None)
    out = _time_calls(
        {"wkv6/value_cols": {
            "ms": lambda: kw.wkv6_cuda(r, k_, v, logw, u),
            "plain_ms": lambda: wkv_chunked(r, k_, v, logw, u)},
         "wkv6_bwd/value_cols": {
            "ms": lambda: kw.wkv6_bwd_cuda(r, k_, v, logw, u32, None, dy),
            "plain_ms": plain}},
        {"wkv6/value_cols": wkv6_bound(b, t, h, dh, dtype, False, dv),
         "wkv6_bwd/value_cols": wkv6_bwd_bound(b, t, h, dh, dtype, False,
                                               False, dv)})
    for key in out:
        out[key].update(B=b, T=t, H=h, Dh=dh, Dv=dv, dtype="float32")
    out["wkv6/value_cols"]["y_max_abs_err"] = float((y - y_r).abs().max())
    out["wkv6_bwd/value_cols"]["plain_is"] = \
        "the backward of autograd over wkv_chunked (graph kept)"
    del r, k_, v, logw, u, u32, dy, y, y_r, plain
    _free()
    return out


def _tpz_serve(grid, cfg, batch, prompt, gen, full, aux, dtype, lead,
               limits) -> dict:
    """A serving case on ``grid`` against the world of one (rank 0): the
    rank's summary, K5's slice-form launches by the rows of the slice,
    K6's by value columns, and (rank 0) the gaps."""
    one, fed = _world_of_one_and_fed(grid, cfg, batch, prompt, gen, full,
                                     aux, dtype, lead)
    torch.cuda.reset_peak_memory_stats()
    with _k5_slice_rows() as k5, _k6_calls(lambda r, v: v.shape[-1]) as k6:
        two = _serve_world(grid, cfg, batch, prompt, gen, full, fed, aux=aux,
                           state_dtype=dtype)
    out = {**_summary(two), "k5_slice_by_rows": dict(k5),
           "k6_by_value_cols": {f"{n} Dv{d}": c for (n, d), c in
                                sorted(k6.items())}}
    if lead:
        out["world_of_one"] = _summary(one)
        out["gaps"] = _compare(one, two, *limits)
    del one, two
    _free()
    return out


def _tpz_guards(grid, cases, ones: dict) -> dict:
    """(e) each (arch, layers, strategy) of ``cases``: step 1's float32
    loss and this rank's slices of the leaves on ``grid`` against the world
    of one's (``ones``: ``world_of_one``'s)."""
    out = {}
    shape = ShapeSpec("tpz_f32", TPZ_F32_SEQ, TPZ_F32_BATCH, "train")
    for arch, layers, strategy in cases:
        cfg = _cut_cfg(arch, layers)
        loss, gaps = _tp_grads(grid, cfg, shape,
                               TrainStepConfig(strategy=strategy),
                               want=ones[(arch, layers)]["path"],
                               aux=_f32_aux(cfg, TPZ_F32_BATCH))
        out[f"{arch} {strategy}"] = {"layers": layers, "loss": loss,
                                     "gaps": gaps}
    return out


def _full_init(cfg, dtype=torch.bfloat16) -> dict:
    """The SEED init of ``cfg``'s whole leaves on the card, in ``dtype``."""
    full = init_from_schema(schema_for(cfg), torch.Generator(
        device=DEV).manual_seed(SEED), DEV)
    return full if dtype == torch.bfloat16 else {
        k_: v.to(dtype) for k_, v in full.items()}


def _grid(serve_mesh, shape):
    return make_mesh(shape, ("data", "model"), device=str(serve_mesh.device))


def tpz_w4_rank(serve_mesh, ones: dict) -> dict:
    """(a) and recurrentgemma's float32 guard on (1, 4)."""
    grid = _grid(serve_mesh, TPZ_RGLRU_MESH)
    lead = grid.rank == 0
    out = {"e": _tpz_guards(grid, TPZ_F32_CASES[4], ones)}
    cfg = get_config(TPZ_RGLRU)
    full = _full_init(cfg)
    out["a"] = _tpz_serve(grid, cfg, TPZ_RGLRU_BATCH, TPZ_RGLRU_PROMPT,
                          TPZ_RGLRU_GEN, full, None, torch.bfloat16, lead,
                          (LM_RTOL, LM_ATOL, LM_SMALL_TOL))
    del full
    _free()
    n_macro = cfg.n_layers // 3
    lo, rows = out["a"]["kv"][0], out["a"]["kv"][1]
    out["a"]["k5_slice_expected"] = _slice_launches(
        [cfg.window] * n_macro, rows, lo,
        range(TPZ_RGLRU_PROMPT, TPZ_RGLRU_PROMPT + TPZ_RGLRU_GEN))
    return out


def tpz_w8_rank(serve_mesh, ones: dict) -> dict:
    """(b) and the float32 guards on (1, 8)."""
    grid = _grid(serve_mesh, TPZ_GEMMA_MESH)
    lead = grid.rank == 0
    out = {"e": _tpz_guards(grid, TPZ_F32_CASES[8], ones)}
    cfg = get_config(TPZ_GEMMA)
    full = _full_init(cfg)
    out["b"] = _tpz_serve(grid, cfg, TPZ_GEMMA_BATCH, TPZ_GEMMA_PROMPT,
                          TPZ_GEMMA_GEN, full, None, torch.bfloat16, lead,
                          (LM_RTOL, LM_ATOL, LM_SMALL_TOL))
    del full
    _free()
    lo, rows = out["b"]["kv"][0], out["b"]["kv"][1]
    out["b"]["k5_slice_expected"] = _slice_launches(
        _windows(cfg), rows, lo,
        range(TPZ_GEMMA_PROMPT, TPZ_GEMMA_PROMPT + TPZ_GEMMA_GEN))
    return out


def tpz_w2_rank(serve_mesh, ones: dict) -> dict:
    """(c) and whisper's float32 guard on (1, 2)."""
    grid = _grid(serve_mesh, TPZ_WHISPER_MESH)
    lead = grid.rank == 0
    out = {"e": _tpz_guards(grid, TPZ_F32_CASES[2], ones)}
    cfg = get_config(TPZ_WHISPER)
    full = _full_init(cfg)
    aux = _tz_aux(cfg, TPZ_WHISPER_BATCH, DEV)
    out["c"] = _tpz_serve(grid, cfg, TPZ_WHISPER_BATCH, TPZ_WHISPER_PROMPT,
                          TPZ_WHISPER_GEN, full, aux, torch.bfloat16, lead,
                          (LM_RTOL, LM_ATOL, LM_SMALL_TOL))
    del full, aux
    _free()
    lo, rows = out["c"]["kv"][0], out["c"]["kv"][1]
    steps = range(TPZ_WHISPER_PROMPT, TPZ_WHISPER_PROMPT + TPZ_WHISPER_GEN)
    frames = cfg.n_audio_frames // TPZ_WHISPER_MESH[1]
    out["c"]["k5_slice_expected"] = {
        rows: _slice_launches([0] * cfg.n_layers, rows, lo, steps),
        frames: _slice_launches([0] * cfg.n_layers, frames,
                                grid.coords["model"] * frames,
                                [cfg.n_audio_frames - 1] * len(steps))}
    return out


def tpz_w16_rank(serve_mesh, ones: dict) -> dict:
    """(d)'s rwkv6-3b on (1, 16), float32: one train step held to the
    world of one's (``world_of_one``'s, with train_tp's jitter control),
    then its serving against the world of one (rank 0)."""
    grid = _grid(serve_mesh, TPZ_RWKV_MESH)
    cfg = _cut_cfg(TPZ_RWKV, TPZ_RWKV_LAYERS)
    shape = ShapeSpec("tpz_f32", TPZ_F32_SEQ, TPZ_F32_BATCH, "train")
    with _k6_calls(lambda r, v: v.shape[-1]) as k6:
        loss, gaps = _tp_grads(grid, cfg, shape, TrainStepConfig(),
                               want=ones[(TPZ_RWKV, TPZ_RWKV_LAYERS)]["path"])
    out = {"train": {"loss": loss, "gaps": gaps},
           "train_k6_by_value_cols": {f"{n} Dv{d}": c for (n, d), c in
                                      sorted(k6.items())}}
    _free()
    out["serve"] = _tpz_serve(grid, cfg, TPZ_RWKV_BATCH, TPZ_RWKV_PROMPT,
                              TPZ_RWKV_GEN, _full_init(cfg, torch.float32),
                              None, torch.float32, grid.rank == 0,
                              (TPZ_F32_TOL, 0.0, TPZ_F32_TOL))
    return out


def _first_rank_error(msg: str) -> str:
    """Of a failed world's report (every rank's traceback), the first
    rank's that is not another rank's lost connection, whole: the others
    only say that a peer went away."""
    parts = msg.split("\nrank ")
    own = [p for p in parts[1:] if "Connection closed by peer" not in p
           and "Connection reset by peer" not in p]
    return (parts[0] + "\nrank " + (own or parts[1:] or [""])[0]
            + f"\n({len(parts) - 1} ranks reported)")


def run_tp_zoo() -> dict:
    """Phase ``tp_zoo``: (a)-(f) above, the worlds of 4, 8, 2 and 16 gloo
    ranks sharing the card one after the other. Every check is read before
    the phase's line is printed, and the phase fails after it if any
    failed. Returns the kernels line's rows of this phase."""
    import tempfile
    t_phase = time.perf_counter()
    vc = check_wkv6_value_cols()
    slices = check_slice_kernel(TPZ_SLICE_CASES)
    _free()
    t_kernels = time.perf_counter() - t_phase
    store_dir = tempfile.mkdtemp(prefix="amp_tp_zoo_")
    worlds, seconds, ones = {}, {}, {}
    fns = {8: tpz_w8_rank, 4: tpz_w4_rank, 2: tpz_w2_rank, 16: tpz_w16_rank}

    def world(n: int, one: dict) -> list:
        try:
            return spawn_world(fns[n], n, backend="gloo", device=str(DEV),
                               store_path=os.path.join(store_dir, f"z{n}"),
                               args=(one,), timeout_s=600)
        except RuntimeError as e:
            raise RuntimeError(_first_rank_error(str(e))) from None

    # the worlds of 4 and 2 ranks at once (6 processes on the host's 8
    # cores), those of 8 and 16 alone
    for group in ((8,), (4, 2), (16,)):
        t0 = time.perf_counter()
        for n in group:
            cases = [((a, layers), _cut_cfg(a, layers), control)
                     for a, layers, control in (
                         [(TPZ_RWKV, TPZ_RWKV_LAYERS, True)] if n == 16
                         else sorted({(a, layers, False)
                                      for a, layers, _ in TPZ_F32_CASES[n]}))]
            ones[n] = world_of_one(cases, ShapeSpec(
                "tpz_f32", TPZ_F32_SEQ, TPZ_F32_BATCH, "train"),
                TrainStepConfig(), store_dir)
        seconds["worlds_of_one_" + "_".join(map(str, group))] = \
            time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(len(group)) as ex:
            futs = {n: ex.submit(world, n, ones[n]) for n in group}
            worlds.update({n: f.result() for n, f in futs.items()})
        for n in group:
            for rec in ones[n].values():
                os.remove(rec["path"])
        seconds["worlds_" + "_".join(map(str, group))] = \
            time.perf_counter() - t0
    ones = {key: rec for one in ones.values() for key, rec in one.items()}
    times = time_slice_kernel(TPZ_SLICE_TIMED, TPZ_SLICE_CASES)
    failed = []

    def check(ok, what, *detail):
        if not ok:
            failed.append([what, *detail])

    for row in vc["rows"]:
        check(row["ok"], "(d) K6 value-column form", row)
    for name, row in slices.items():
        check(row["ok"], "(f) K5 slice form", row)
    launches = collections.Counter()
    for n, key in ((4, "a"), (8, "b"), (2, "c")):
        lead = worlds[n][0][key]
        g = lead["gaps"]
        check(g["prefill"]["ok"] and g["decode"]["ok"], f"({key}) logits",
              g["prefill"], g["decode"])
        check(g["ids"]["equal"] or g["ids"]["near_ties"], f"({key}) ids",
              g["ids"])
        for r in worlds[n]:
            want = r[key]["k5_slice_expected"]
            got = r[key]["k5_slice_by_rows"]
            if not isinstance(want, dict):
                want = {r[key]["kv"][1]: want}
            check(all(got.get(rows, 0) == c for rows, c in want.items())
                  and sum(got.values()) == sum(want.values()),
                  f"({key}) K5 slice launches", got, want)
            check(r[key]["launches"].get("decode_attn", 0) == 0,
                  f"({key}) no one-device K5", r[key]["launches"])
            for rows, c in got.items():
                launches[(key, rows)] += c
    lead = worlds[16][0]
    one = ones[(TPZ_RWKV, TPZ_RWKV_LAYERS)]
    tr = {"loss": lead["train"]["loss"], "loss_one": one["loss"],
          "loss_rel": abs(lead["train"]["loss"] - one["loss"])
          / abs(one["loss"]),
          "grad_gap_of_scale": _merge_gaps([r["train"]["gaps"]
                                            for r in worlds[16]]),
          "jitter_control_gap_of_scale": one["control"]}
    check(tr["loss_rel"] <= TPZ_F32_TOL, "(d) train loss", tr["loss_rel"])
    for k_, gap in tr["grad_gap_of_scale"].items():
        lim = max(TPZ_F32_TOL,
                  TP_RWKV_CONTROL * tr["jitter_control_gap_of_scale"][k_])
        check(gap <= lim, "(d) train leaf", k_, gap, lim)
    dv = 64 // TPZ_RWKV_MESH[1]
    g = lead["serve"]["gaps"]
    check(g["prefill"]["gap_of_scale"] <= TPZ_F32_TOL
          and g["decode"]["gap_of_scale"] <= TPZ_F32_TOL, "(d) serve logits",
          g["prefill"], g["decode"])
    check(g["ids"]["equal"] or g["ids"]["near_ties"], "(d) serve ids",
          g["ids"])
    for r in worlds[16]:
        want = {f"wkv6 Dv{dv}": 2 * TPZ_RWKV_LAYERS,
                f"wkv6_bwd Dv{dv}": TPZ_RWKV_LAYERS}
        check(r["train_k6_by_value_cols"] == want, "(d) K6 train Dv",
              r["train_k6_by_value_cols"], want)
        got = r["serve"]["k6_by_value_cols"]
        check(set(got) == {f"wkv6 Dv{dv}"}
              and got[f"wkv6 Dv{dv}"] >= TPZ_RWKV_LAYERS, "(d) K6 serve Dv",
              got)
        for name, c in [*r["train_k6_by_value_cols"].items(), *got.items()]:
            launches[("d", name.split(" ")[0])] += c
    guards = {}
    for n in (8, 4, 2):
        for (arch, layers, strategy) in TPZ_F32_CASES[n]:
            case = f"{arch} {strategy}"
            one = ones[(arch, layers)]
            gaps = _merge_gaps([r["e"][case]["gaps"] for r in worlds[n]])
            worst = max(gaps, key=gaps.get)
            loss = worlds[n][0]["e"][case]["loss"]
            gd = guards[case] = {
                "layers": layers, "loss": loss, "loss_one": one["loss"],
                "loss_rel": abs(loss - one["loss"]) / abs(one["loss"]),
                "worst_leaf": worst, "grad_gap_of_scale": gaps}
            check(gd["loss_rel"] <= TPZ_F32_TOL, f"(e) {case} loss",
                  gd["loss_rel"])
            check(gaps[worst] <= TPZ_F32_TOL, f"(e) {case} leaves", worst,
                  gaps[worst])
    summary = lambda n, key: [{k_: v for k_, v in r[key].items()
                               if k_ != "gaps"} for r in worlds[n]]
    emit("tp_zoo", card=nvidia_smi_line(),
         note="gloo ranks sharing one card: times are oversubscription, "
              "not scaling",
         reduced=TPZ_REDUCED, failed=failed,
         recurrentgemma_2b=summary(4, "a"), gemma3_1b=summary(8, "b"),
         whisper_small=summary(2, "c"),
         gaps={key: worlds[n][0][key]["gaps"] for n, key in
               ((4, "a"), (8, "b"), (2, "c"))},
         rwkv6_3b_16={"train": tr,
                      "train_k6": [r["train_k6_by_value_cols"]
                                   for r in worlds[16]],
                      "serve": [{k_: v for k_, v in r["serve"].items()
                                 if k_ != "gaps"} for r in worlds[16]],
                      "serve_gaps": lead["serve"]["gaps"]},
         float32_guards=guards, k6_value_cols=vc,
         k5_slice_checks=slices, k5_slice_times=times,
         limits={"bf16_rtol": LM_RTOL, "bf16_atol": LM_ATOL,
                 "float32_of_scale": TPZ_F32_TOL,
                 "k6_value_cols_fwd_of_scale": TPZ_VC_FWD_TOL,
                 "k6_value_cols_bwd_of_scale": TPZ_VC_BWD_TOL,
                 "rwkv_train_leaf_of_control": TP_RWKV_CONTROL},
         seconds_kernel_checks=t_kernels, **seconds,
         seconds=time.perf_counter() - t_phase)
    assert not failed, failed
    rows = []
    errs = {"decode_attn_slice/rglru_window": ("rglru",),
            "decode_attn_slice/gemma3_m8": ("gemma3_m8",),
            "decode_attn_slice/whisper_self": ("whisper_self",),
            "decode_attn_slice/whisper_cross": ("whisper_cross",)}
    kv_rows = {"decode_attn_slice/rglru_window":
               ("a", (TPZ_RGLRU_PROMPT + TPZ_RGLRU_GEN) // TPZ_RGLRU_MESH[1]),
               "decode_attn_slice/gemma3_m8":
               ("b", (TPZ_GEMMA_PROMPT + TPZ_GEMMA_GEN) // TPZ_GEMMA_MESH[1]),
               "decode_attn_slice/whisper_self":
               ("c", (TPZ_WHISPER_PROMPT + TPZ_WHISPER_GEN)
                // TPZ_WHISPER_MESH[1]),
               "decode_attn_slice/whisper_cross":
               ("c", get_config(TPZ_WHISPER).n_audio_frames
                // TPZ_WHISPER_MESH[1])}
    for key, (case, rows_n) in kv_rows.items():
        tm, n = times[key], launches[(case, rows_n)]
        rows.append({
            "name": key, "route": "cuda", "source": SOURCES["decode_attn"],
            "replaces": REPLACES["decode_attn"], "launches": n,
            "max_abs_err": max(r["max_abs_err"] for c, r in slices.items()
                               if c.startswith(errs[key])),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})
        assert n > 0, (key, n)
    vc_err = {"wkv6": max(r["y_max_abs_err"] for r in vc["rows"]
                          if "y_max_abs_err" in r),
              "wkv6_bwd": max(r["max_abs_err"] for r in vc["rows"]
                              if "max_abs_err" in r)}
    for base in ("wkv6", "wkv6_bwd"):
        key = f"{base}/value_cols"
        tm, n = vc["times"][key], launches[("d", base)]
        rows.append({
            "name": key, "route": "cuda", "source": SOURCES["wkv6"],
            "replaces": REPLACES["wkv6" if base == "wkv6" else "wkv6_bwd"],
            "launches": n, "max_abs_err": vc_err[base], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None})
        assert n > 0, (key, n)
    return {"rows": rows}


def add_train_tp_launches(kernels: list, tp_ctx) -> None:
    """Each K4 and K6 row of the kernels line also carries its launches on
    the train_tp phase's paths (every rank and step), by shape, and its
    largest error against its plain version at those shapes."""
    for row in kernels:
        base = row["name"].split("/")[0]
        if base in TP_KERNELS:
            row["train_tp_launches"] = tp_ctx["launches"].get(base, 0)
            if base in tp_ctx["max_abs_err"]:
                row["train_tp_max_abs_err"] = tp_ctx["max_abs_err"][base]
            row["train_tp_launches_by_shape"] = {
                key: v for key, v in tp_ctx["by_shape"].items()
                if key.split(" ")[0] == base}


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
        par = ceng._col_prior_params(M)
        run = lambda e=ceng, s=sched_c, q=par: e._col_solve_core(
            a_cp, y_d, s, q, M, N)
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


def fuse_bound(b, p, n, keep: int = 0):
    """Least time of the fused call: the messages read once, the float32
    symbols, f and extra written once (and ``keep`` flags read, the
    erasure form); about 8 float32 operations an element (abs, max,
    divide, round, two clamps, multiply, add; the erasure form's keep
    product and rescale are 2 more an element of f_p and f)."""
    ops = 8.0 * b * p * n + (2.0 * b * p * n if keep else 0.0)
    return bound(4 * (2 * b * p * n + b * n + b + keep), ops)


COL_TIMED = [s for s in COL_SHAPES if s[0] in ("paper_P25", "wide_P20",
                                               "batch4_per_instance_A")]


def time_col_kernels() -> dict:
    table = {}
    for name, b, shared, p, m, np_ in COL_TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            a, x, x0, z, g = col_inputs(b, shared, p, m, np_, dtype, SEED)
            a32 = a.float()   # the library yardstick gets float32 A ready-made
            par = ref.col_params(float(m), *PRIOR_SCALARS, device=DEV)
            inner = lambda upd: (a, x, x0, z, g, None, par, upd)
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
    """The fused transport (K4) at its shapes: the row messages (P=30, N)
    and the column contributions (P=25, M), qmax 127, block 512. No single
    PyTorch call computes the block quantizer, so there is no library
    yardstick. The fused call is timed beside ``chain_fuse`` (``chain_ms``: the same
    function composed of the standalone kernels and PyTorch ops) and beside
    an empty kernel launched with its grid, threads and shared memory
    (``empty_launch_ms``), the floor under any one launch."""
    table = {}
    for name, r, n in Q_SHAPES[:2]:
        x = quant_inputs(r, n, SEED)
        x3 = x.reshape(1, r, n)
        keep = fuse_keep_rows(1, r, SEED + 8)["random_shared"]
        plan = kq.fuse_plan(1, r, n, 512, sms=k.sm_count(DEV))
        calls = {
            "block_quant_fuse": {
                "ms": lambda: kq.block_quant_fuse_cuda(x3, 127, 512),
                "plain_ms": lambda: block_quant_fuse_ref(x3, 127, 512),
                "chain_ms": lambda: chain_fuse(x3, 127, 512),
                "empty_launch_ms": lambda: kq.empty_launch_cuda(plan, DEV)},
            # the erasure form, in the same call as the drop-free one
            "block_quant_fuse_erasure": {
                "ms": lambda: kq.block_quant_fuse_cuda(x3, 127, 512,
                                                       keep=keep),
                "plain_ms": lambda: block_quant_fuse_ref(x3, 127, 512,
                                                         keep=keep)},
        }
        table[name] = _time_calls(calls, {"block_quant_fuse": fuse_bound(
                                              1, r, n),
                                          "block_quant_fuse_erasure":
                                              fuse_bound(1, r, n, keep=r)})
        table[name]["block_quant_fuse"]["plan"] = plan._asdict()
    table["fuse_scaling"] = time_fuse_scaling()
    return table


def wire_bounds(r, n, block):
    """Least times of the wire forms: K4a packed reads x and writes N / 2
    bytes a row and the scales (5 operations an element, 2 more to pack);
    K4b packed the reverse (3 an element: unpack, sign, scale); K4b's sum
    over R rows reads the R int8 (or packed) rows and scales once and
    writes one float32 row (2 operations an element of a row)."""
    scales = 2 * r * (-(-n // block))
    return {"quantize_blocks_packed": bound(4 * r * n + r * n // 2 + scales,
                                            7.0 * r * n),
            "dequantize_blocks_packed": bound(r * n // 2 + scales + 4 * r * n,
                                              3.0 * r * n),
            "dequantize_sum": bound(r * n + scales + 4 * n, 2.0 * r * n),
            "dequantize_sum_packed": bound(r * n // 2 + scales + 4 * n,
                                           3.0 * r * n)}


def time_wire_kernels() -> dict:
    """The wire forms, int8 and int4, at compressed_psum's chunks: the row
    message over D = 2 (two chunks of 5120) and over a world of one (one of
    10240: the kernels line's shape), the column one over D = 2 (two of
    2048), block 512. No single PyTorch call computes them: no library
    yardstick."""
    table = {}
    for name, r, n in WIRE_CASES[:3]:
        x = quant_inputs(r, n, SEED + 3)
        pk, sk = kq.quantize_cuda(x, 7, 512, packed=True)
        q8, s8 = kq.quantize_cuda(x, 127, 512)
        calls = {
            "quantize_blocks": {
                "ms": lambda: kq.quantize_cuda(x, 127, 512),
                "plain_ms": lambda: qops.quantize_plain(x, 127, 512)},
            "dequantize_blocks": {
                "ms": lambda: kq.dequantize_cuda(q8, s8, 512),
                "plain_ms": lambda: qops.dequantize_plain(q8, s8, 512)},
            "quantize_blocks_packed": {
                "ms": lambda: kq.quantize_cuda(x, 7, 512, packed=True),
                "plain_ms": lambda: qops.quantize_plain(x, 7, 512,
                                                        packed=True)},
            "dequantize_blocks_packed": {
                "ms": lambda: kq.dequantize_cuda(pk, sk, 512, packed=True),
                "plain_ms": lambda: qops.dequantize_plain(pk, sk, 512,
                                                          packed=True)},
            "dequantize_sum": {
                "ms": lambda: kq.dequantize_sum_cuda(q8, s8, 512),
                "plain_ms": lambda: qops.dequantize_sum_plain(q8, s8, 512)},
            "dequantize_sum_packed": {
                "ms": lambda: kq.dequantize_sum_cuda(pk, sk, 512,
                                                     packed=True),
                "plain_ms": lambda: qops.dequantize_sum_plain(
                    pk, sk, 512, packed=True)},
        }
        table[name] = _time_calls(calls, {**quant_bounds(r, n, 512),
                                          **wire_bounds(r, n, 512)})
    return table


# (B, P, L, block, blocks a cluster: None = the plan's)
FUSE_SCALING = [(1, P, N, 512, None), (1, P, N, 512, 1), (1, P, N, 512, 2),
                (1, P, N, 512, 8), (1, P, N, 256, None), (4, P, N, 512, None),
                (4, P, N, 512, 4), (1, P, N // 4, 512, None),
                (1, 8, N, 512, None), (1, 1, N, 512, None)]


def time_fuse_scaling() -> dict:
    """Where the fused call's time goes: its device time at the row shape
    with the plan's clusters and with others, against more blocks (block
    256, B=4), fewer (L / 4) and fewer warps a block (P = 8, 1), each
    beside an empty launch of its plan."""
    rows = []
    for b, p, n, block, cluster in FUSE_SCALING:
        x = fuse_inputs(b, p, n, SEED)
        plan = kq.fuse_plan(b, p, n, block, cluster, k.sm_count(DEV))
        rows.append({"B": b, "P": p, "L": n, "block": block,
                     "cluster": plan.cluster,
                     "blocks": plan.grid[0] * plan.grid[1],
                     "warps": plan.warps,
                     "ms": time_ms(lambda: kq.block_quant_fuse_cuda(
                         x, 127, block, cluster=cluster))["ms"],
                     "empty_launch_ms": time_ms(lambda: kq.empty_launch_cuda(
                         plan, DEV))["ms"]})
    return rows


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
        par = eng._col_prior_params(M)
        out[f"{name}_solve_ms"] = time_call_ms(
            lambda e=eng, s=sched, q=par: e._col_solve_core(a_cp, y_d, s, q,
                                                            M, N))
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
    # the LM zoo's decode shapes, one a model and layer kind
    # (zoo_k5_shapes; check_decode_attn_kernel fails if one is missing):
    # whisper-small's self-attention (G = 1, Dh 64) and its
    # cross-attention over the 1500 frames (pos 1499); recurrentgemma's
    # G = 10, Dh 256 with its window of 2048 past pos 2048; qwen3-moe's
    # G = 8, Dh 128; qwen2-vl's G = 7, Dh 128; gemma3-1b at B = 1 past its
    # prompt of 32768, global and local. And mixtral's window of 4096 past
    # S = 4096 (its smoke config alone runs on the card).
    ("whisper_self_G1_Dh64", 8, 12, 12, 64, 480, 479, 0, torch.bfloat16,
     torch.bfloat16, False),
    ("whisper_cross_S1500", 8, 12, 12, 64, 1500, 1499, 0, torch.bfloat16,
     torch.bfloat16, False),
    ("rgemma_G10_window2048", 4, 10, 1, 256, 3032, 3031, 2048, torch.bfloat16,
     torch.bfloat16, False),
    ("qwen3moe_G8", 8, 32, 4, 128, 1032, 1031, 0, torch.bfloat16, torch.bfloat16,
     False),
    ("qwen2vl_G7", 4, 28, 4, 128, 2080, 2079, 0, torch.bfloat16, torch.bfloat16,
     False),
    ("gemma3_B1_S32800", 1, 4, 1, 256, 32800, 32799, 0, torch.bfloat16,
     torch.bfloat16, False),
    ("gemma3_B1_local_S32800", 1, 4, 1, 256, 32800, 32799, 512, torch.bfloat16,
     torch.bfloat16, False),
    ("mixtral_window4096", 2, 32, 8, 128, 5000, 4999, 4096, torch.bfloat16,
     torch.bfloat16, False),
]
# two shapes of different plans, called in turns: each call must give the
# bits of its shape's first call (the last block of a group resets its
# counter; a counter left behind would change the next launch)
DA_ALTERNATE = ("gemma3_global", "b2_global")
DA_B2 = ("b2_global", 2, 4, 1, 256, 1032, 1031, 0, torch.bfloat16,
         torch.bfloat16, False)


def zoo_k5_shapes() -> list[tuple]:
    """K5's shapes on the LM zoo's decode paths, one a model and layer kind
    at the last decode step: (key, arch, B, H, KV, Dh, S, pos, window,
    launches a step). Whisper: its self-attention and its cross-attention
    over the encoder's frames (pos = frames - 1), each once a layer; the
    others: one a layer of each attention kind (``attn_kinds``)."""
    out = []
    for arch, batch, prompt in LM_ZOO:
        cfg = get_config(arch)
        s = prompt + LM_GEN
        if cfg.family == "whisper":
            shape = (batch, cfg.n_heads, cfg.n_heads, cfg.d_head)
            kinds = {"self": (s, 0, cfg.n_layers),
                     "cross": (cfg.n_audio_frames, 0, cfg.n_layers)}
        else:
            shape = (batch, cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
            kinds = {kind: (s, cfg.window if kind == "local" else 0,
                            cfg.attn_kinds.count(kind))
                     for kind in ("global", "local") if kind in cfg.attn_kinds}
        for kind, (rows, win, per_step) in kinds.items():
            out.append((f"{arch}/{kind}", arch, *shape, rows, rows - 1, win,
                        per_step))
    return out


def zoo_da_cases() -> dict:
    """{``zoo_k5_shapes`` key: the name of the ``DA_CASES`` case of that
    shape, bf16 as served}; fails if a shape has none."""
    cases = {(b, h, kv, dh, s, pos, win): name
             for name, b, h, kv, dh, s, pos, win, q_dt, c_dt, nan in DA_CASES
             if q_dt == c_dt == torch.bfloat16 and not nan}
    out = {key: cases.get((b, h, kv, dh, s, pos, win))
           for key, _, b, h, kv, dh, s, pos, win, _ in zoo_k5_shapes()}
    missing = [key for key, name in out.items() if name is None]
    assert not missing, f"zoo decode shapes without a DA_CASES case: {missing}"
    return out


def k5_shape_key(b, h, kv, dh, s, win) -> str:
    return f"B{b} H{h} KV{kv} Dh{dh} S{s} window{win}"


@contextlib.contextmanager
def k5_calls_by_shape():
    """Counts the decode-attention wrapper's calls by shape
    (``k5_shape_key``) while the block runs: the dispatch's binding of the
    wrapper is wrapped; nothing is read from the card."""
    tally = collections.Counter()
    wrapper = kd_ops.decode_attn_cuda

    def counting(q, k_cache, v_cache, pos, window=0):
        b, s, kv, dh = k_cache.shape
        tally[k5_shape_key(b, q.shape[1], kv, dh, s, window)] += 1
        return wrapper(q, k_cache, v_cache, pos, window)

    kd_ops.decode_attn_cuda = counting
    try:
        yield tally
    finally:
        kd_ops.decode_attn_cuda = wrapper


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
    zoo_da_cases()
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


def k5_per_step(cfg) -> int:
    """Decode-attention launches a decode step of ``cfg``'s family makes:
    one a layer (dense, moe), one a macro-block (rglru), two a decoder layer
    (whisper: self and cross), none (rwkv6)."""
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "rwkv6": 0,
            "rglru": cfg.n_layers // 3, "whisper": 2 * cfg.n_layers}[cfg.family]


def lm_launches(cfg, steps: int, prefills: int) -> dict:
    """The K5 and K6 launches of ``prefills`` prefills and ``steps`` decode
    steps (K6: one a layer of an rwkv6 prefill)."""
    return {"decode_attn": k5_per_step(cfg) * steps,
            "wkv6": cfg.n_layers * prefills if cfg.family == "rwkv6" else 0}


def teacher_forced_logits(model, prompts, fed):
    """Prefill ``prompts`` (with the stub inputs), then one decode step per
    column of ``fed``: float32 logits (B, steps, V) of every step."""
    (b, p), n = prompts.shape, fed.shape[1]
    state = serve.prefill(model, prompts, p + n, serve.stub_inputs(model, b, p))
    out = []
    for i in range(n):
        h, state = model.decode_step(fed[:, i:i + 1], state, p + i)
        out.append(model.logits(h)[:, -1])
    return torch.stack(out, 1)


LM_SMALL = (LM_DENSE, "granite-3-8b", LM_RWKV, "qwen3-moe-30b-a3b",
            "mixtral-8x7b", "recurrentgemma-2b", "qwen2-vl-7b", "whisper-small")


def check_lm_small() -> dict:
    """The smoke config of each family on the card (K5 / K6) against the CPU
    (plain versions), with the same weights: prefill hidden and 8
    teacher-forced decode steps' logits within 2 % of their scale. mixtral
    (93.4 GB in bf16, more than the card holds) runs here only."""
    out = {}
    for arch in LM_SMALL:
        cfg = get_config(arch).smoke_config()
        cpu = get_model(cfg, device="cpu", seed=SEED)
        gpu = get_model(cfg, state={n: p.detach() for n, p in
                                    cpu.named_parameters()})
        toks = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (2, 48)))
        prompts, fed = toks[:, :40], toks[:, 40:]
        reset_all_counts()
        h_g, _ = gpu(prompts.to(DEV), mode="prefill",
                     **serve.stub_inputs(gpu, 2, 40))
        l_g = teacher_forced_logits(gpu, prompts.to(DEV), fed.to(DEV))
        torch.cuda.synchronize()
        launches = all_counts()
        h_c, _ = cpu(prompts, mode="prefill", **serve.stub_inputs(cpu, 2, 40))
        l_c = teacher_forced_logits(cpu, prompts, fed)
        h_err = float((h_g.float().cpu() - h_c.float()).abs().max()
                      / h_c.float().abs().max())
        l_err = float((l_g.cpu() - l_c).abs().max() / l_c.abs().max())
        want = lm_launches(cfg, 8, 2)
        got = {key: launches[key] for key in want}
        out[arch] = {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                                "n_heads": cfg.n_heads,
                                "n_kv_heads": cfg.n_kv_heads,
                                "d_head": cfg.d_head, "vocab": cfg.vocab,
                                "n_experts": cfg.n_experts},
                     "hidden_err_of_scale": h_err,
                     "logits_err_of_scale": l_err, "launches": got}
        assert got == want, (arch, got, want)
        assert h_err <= LM_SMALL_TOL and l_err <= LM_SMALL_TOL, out[arch]
        del cpu, gpu
    emit("lm_small_card_vs_cpu", limit_of_scale=LM_SMALL_TOL, models=out)
    return out


def lm_decode_sync_sites(model, prompts) -> list:
    """``sync_sites`` over the greedy decode loop alone (prefill before)."""
    b, p = prompts.shape
    state = serve.prefill(model, prompts, p + LM_GEN,
                          serve.stub_inputs(model, b, p))
    run = lambda: (serve.decode(model, state, prompts[:, -1:], p,
                                LM_GEN).float(), None)
    run()                                           # warm: allocator, cuBLAS
    return sync_sites(run)


def lm_consistency(model, prompts) -> tuple:
    """``serve.generate`` with the logits kept, then one prefill over the
    prompt and the tokens the loop was fed (prompt[-1], then the generated
    ids but the last): the decode logits of every generated position
    against that prefill's. Returns (the generation, the kernel launches of
    the generate call alone, the comparison, the decode-attention calls of
    the generate call by shape)."""
    b, p = prompts.shape
    reset_all_counts()
    with k5_calls_by_shape() as by_shape:
        out = serve.generate(model, prompts, LM_GEN, keep_logits=True)
    launches = all_counts()                          # read just after the path
    p_dev = torch.as_tensor(prompts, device=DEV)
    ids = torch.as_tensor(out.tokens, device=DEV)
    seq = torch.cat([p_dev, p_dev[:, -1:], ids[:, :-1]], dim=1)
    with torch.inference_mode():
        h, _ = model(seq, mode="prefill",
                     **serve.stub_inputs(model, b, seq.shape[1]))
        want = model.logits(h[:, p:])
    dec, out.logits = out.logits, None
    err = (dec - want).abs()
    scale = float(want.abs().max())
    cmp = {"max_abs_err": float(err.max()), "logits_scale": scale,
           "err_of_scale": float(err.max()) / scale,
           "within_rtol_atol": bool((err <= LM_ATOL + LM_RTOL * want.abs()).all()),
           "argmax_agree": float((want.argmax(-1) == ids).float().mean()),
           "finite": bool(torch.isfinite(dec).all())}
    return out, launches, cmp, dict(by_shape)


def _no_drop(cfg):
    """An MoE config whose capacity no routing can exceed (cf = E/k)."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _in_first_layers(name: str, n_layers: int) -> bool:
    """Whether parameter ``name`` of a decoder-only model is outside its
    layers or in its first ``n_layers``."""
    return (not name.startswith("layers.")
            or int(name.split(".")[1]) < n_layers)


def _first_layers(params: dict, cfg):
    """A model of ``cfg`` on the tensors of ``params`` (named as a full
    model's parameters), keeping its first ``cfg.n_layers`` layers: no
    copy for tensors already on the card."""
    return get_model(cfg, state={n: p for n, p in params.items()
                                 if _in_first_layers(n, cfg.n_layers)})


def moe_prefill_drops(model, tokens) -> list:
    """One prefill of an MoE model with each layer's dispatch read: its
    (dropped, routed) slot counts, the slots its ``keep`` marks false, as
    device tensors (no host read inside the prefill)."""
    drops = []
    dispatch = lm_moe._dispatch_group

    def recording(*args):
        buf, dest, keep = dispatch(*args)
        drops.append(((~keep).sum(), keep.numel()))
        return buf, dest, keep

    lm_moe._dispatch_group = recording
    try:
        model(tokens, mode="prefill")
    finally:
        lm_moe._dispatch_group = dispatch
    return drops


def run_lm(arch: str, batch: int, prompt: int = LM_PROMPT,
           phase: str | None = None) -> dict:
    """``serve.generate`` at full width and depth (random init from SEED,
    the stub inputs of ones): the kernel launches of the path, zero host
    syncs inside the decode loop, warm prefill and decode times, peak
    memory, and decode against prefill (``lm_consistency``) — in bf16, the
    model as served, and again with the same weights in float32, where bf16
    rounding cannot hide a fault of the cache or state handoff. Models in
    ``LM_BF16_HELD`` are held to the reference's tolerance in bf16 too; the
    others' bf16 numbers are recorded only (ROADMAP Queue 3 for rwkv6-3b).
    An MoE model is compared on its no-drop copy (``_no_drop``: the same
    weights; its served prefill drops routed slots, its decode none, and
    the share dropped is recorded), and its float32 twin has
    ``LM_F32_LAYERS`` layers of the full width. The result is emitted as
    ``phase`` (default ``lm_<family>``) before it is checked."""
    cfg = get_config(arch)
    moe = cfg.family == "moe"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(cfg, seed=SEED)               # the default device: the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                   (batch, prompt))
    first, launches, cmp_served, k5_by_shape = lm_consistency(model, prompts)
    twin_cfg = _no_drop(cfg) if moe else cfg
    twin = (type(model)(twin_cfg, dict(model.named_parameters())) if moe
            else model)
    cmp16 = lm_consistency(twin, prompts)[2] if moe else cmp_served
    bf16_depth = {}
    if arch in LM_BF16_CUT:
        params = dict(model.named_parameters())
        for name, c in ([(f"L{n}", dataclasses.replace(cfg, n_layers=n))
                         for n in LM_BF16_LADDER]
                        + [(f"L{cfg.n_layers}_1d_positions",
                            dataclasses.replace(cfg, m_rope=False))]):
            bf16_depth[name] = lm_consistency(_first_layers(params, c),
                                              prompts)[2]
        del params
    p_dev = torch.as_tensor(prompts, device=DEV)
    with torch.inference_mode():
        drops = moe_prefill_drops(model, p_dev) if moe else []
        sites = lm_decode_sync_sites(model, p_dev)
    dropped = (float(sum(d for d, _ in drops) / sum(r for _, r in drops))
               if drops else None)
    dropped_by_layer = [float(d) / r for d, r in drops]
    warm = [serve.generate(model, prompts, LM_GEN) for _ in range(2)][-1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    f32_cfg = dataclasses.replace(twin_cfg, n_layers=min(
        cfg.n_layers, LM_F32_LAYERS.get(cfg.family, cfg.n_layers)))
    state32 = {n: p.detach().float() for n, p in model.named_parameters()
               if _in_first_layers(n, f32_cfg.n_layers)}
    del model, twin
    _free()
    model32 = _first_layers(state32, f32_cfg)
    del state32
    first32, launches32, cmp32, _ = lm_consistency(model32, prompts)
    del model32
    _free()

    want_launch = lm_launches(cfg, LM_GEN, 1)
    want32 = lm_launches(f32_cfg, LM_GEN, 1)
    got = {key: launches[key] for key in want_launch}
    got32 = {key: launches32[key] for key in want_launch}
    result = {
        "arch": arch, "family": cfg.family, "batch": batch, "prompt": prompt,
        "gen": LM_GEN, "seed": SEED, "n_params": n_params, "init_s": init_s,
        "first_ids": first.tokens[0].tolist(),
        "decode_vs_prefill_bf16": cmp16, "decode_vs_prefill_f32": cmp32,
        "decode_vs_prefill_bf16_by_depth": bf16_depth,
        "f32_layers": f32_cfg.n_layers,
        "launches": got, "launches_f32": got32,
        "decode_attn_calls_by_shape": k5_by_shape,
        "synchronizing_calls_in_decode_loop": len(sites),
        "ids_same_on_rerun": bool(np.array_equal(first.tokens, warm.tokens)),
        "first_call_prefill_s": first.prefill_s,
        "first_call_decode_s": first.decode_s,
        "prefill_ms": 1e3 * warm.prefill_s,
        "prefill_tok_per_s": batch * prompt / warm.prefill_s,
        "decode_ms_per_step": 1e3 * warm.decode_s / LM_GEN,
        "decode_tok_per_s": batch * LM_GEN / warm.decode_s,
        "peak_memory_gb_bf16": peak_gb,
    }
    if moe:
        result.update(capacity_factor=cfg.capacity_factor,
                      prefill_dropped_slot_share=dropped,
                      prefill_dropped_slot_share_by_layer=dropped_by_layer,
                      compared_capacity_factor=twin_cfg.capacity_factor,
                      decode_vs_prefill_bf16_served=cmp_served)
    emit(phase or f"lm_{cfg.family}",
         limits={"rtol": LM_RTOL, "atol": LM_ATOL,
                 "f32_err_of_scale": LM_F32_TOL,
                 "bf16_held": arch in LM_BF16_HELD}, **result)
    assert first.tokens.shape == (batch, LM_GEN), first.tokens.shape
    assert cmp16["finite"] and cmp32["finite"], result
    assert cmp32["within_rtol_atol"] and cmp32["err_of_scale"] <= LM_F32_TOL, result
    if arch in LM_BF16_HELD:
        assert cmp16["within_rtol_atol"], result
    if arch in LM_BF16_CUT:
        assert bf16_depth[f"L{LM_BF16_CUT[arch]}"]["within_rtol_atol"], result
    assert got == want_launch and got32 == want32, (got, got32, want_launch,
                                                    want32)
    assert sum(k5_by_shape.values()) == got["decode_attn"], (k5_by_shape, got)
    assert not sites, f"host syncs inside the decode loop: {sorted(set(sites))}"
    return result


def run_lm_zoo() -> dict:
    """Phase ``lm_zoo``: ``run_lm`` for every model of ``LM_ZOO``, one at a
    time (each freed before the next: qwen3-moe alone peaks near 72 GB),
    and K5 timed at each one's decode shapes (``time_decode_attn``'s
    method, L2-hot) beside its plain version, each shape with the calls
    its model's generate made at it (``launches``: a layer of that kind a
    step, and their sum the wrapper's count). Returns {"models": the
    ``run_lm`` results, "k5": the timings by ``zoo_k5_shapes`` key}."""
    t0 = time.perf_counter()
    models = {}
    for arch, batch, prompt in LM_ZOO:
        models[arch] = run_lm(arch, batch, prompt, phase=f"lm_zoo/{arch}")
        _free()
    k5 = time_zoo_decode_attn()
    for key, arch, b, h, kv, dh, s, _, win, per_step in zoo_k5_shapes():
        calls = models[arch]["decode_attn_calls_by_shape"]
        k5[key]["launches"] = calls.get(k5_shape_key(b, h, kv, dh, s, win), 0)
    keys = ("batch", "prompt", "n_params", "prefill_ms", "prefill_tok_per_s",
            "decode_ms_per_step", "decode_tok_per_s", "peak_memory_gb_bf16",
            "launches")
    emit("lm_zoo", card=nvidia_smi_line(),
         models={arch: {key: r[key] for key in keys}
                 for arch, r in models.items()},
         k5=k5, seconds=time.perf_counter() - t0)
    for key, arch, *_, per_step in zoo_k5_shapes():
        assert k5[key]["launches"] == per_step * LM_GEN, (key, k5[key])
    return {"models": models, "k5": k5}


def decode_attn_bound(b, h, kv, dh, rows, dtype) -> dict:
    """K5's least time: q read and the output written once, and K and V of
    the rows the position attends to (the only ones needed) read once; two
    float32 FMAs per head, row and channel (scores and PV) plus ~5
    operations per head and row for the softmax."""
    e = 2 if dtype == torch.bfloat16 else 4
    nbytes = 2 * b * h * dh * e + 2 * rows * b * kv * dh * e
    return bound(nbytes, 4.0 * b * h * dh * rows + 5.0 * b * h * rows)


def wkv6_bound(b, t, h, dh, dtype, state, dv=None) -> dict:
    """K6's least time: r, k, v, logw, u and the initial state read once, y
    and the final state written once; the operations of the chunked form
    over the T real steps, the four products (per chunk of c steps and head:
    r'k'^T and its product with v over the lower triangle, r'S, the state
    update) at the dense TF32 tensor-core rate, the rest (u-bonus,
    rebasing, decay of S) at the float32 CUDA-core rate. The ragged last
    chunk counts its real steps, not the padded ones.
    ``bound_ms_cuda_cores`` keeps the earlier figure, every operation at
    the CUDA-core rate. ``dv``: the value columns (the value-column form;
    Dh unless given)."""
    dv = dh if dv is None else dv
    e = 2 if dtype == torch.bfloat16 else 4
    n, nv = b * t * h * dh, b * t * h * dv
    st = b * h * dh * dv * 4
    nbytes = (2 * n * e + nv * e + 4 * n + 4 * h * dh + (st if state else 0)
              + 4 * nv + st)

    def products(c):
        return (c * (c - 1) * (dh + dv)              # A and A v, lower triangle
                + 2 * c * dh * dv                    # r' S
                + 2 * dh * dv * c)                   # (k' e^{l_tot})^T v

    def rest_ops(c):
        return (2 * c * dv                           # diag v
                + 3 * c * dh + 4 * c * dh            # u-bonus, rebasing
                + c * dh                             # k' scaled by e^{l_tot}
                + 2 * dh * dv)                       # decay of S, and the sum
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


def _time_k5(b, h, kv, dh, s, pos, win, copies=1, dtype=torch.bfloat16):
    """K5, its plain version and ``scaled_dot_product_attention`` (GQA, the
    boolean mask over the whole cache) at one shape, each over ``copies``
    sets of caches in turns (``time_ms``), beside the bound."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_idx = torch.arange(s, device=DEV)
    mask = t_idx <= pos
    if win:
        mask &= t_idx > pos - win
    mask = mask[None, None, None]
    ours, lib = [], []
    for i in range(copies):
        q, kc_, vc_ = da_inputs(b, h, kv, dh, s, dtype, dtype, SEED + i)
        ours.append((q, kc_, vc_, pos, win))
        lib.append((q[:, :, None], kc_.transpose(1, 2).contiguous(),
                    vc_.transpose(1, 2).contiguous()))
    calls = {"decode_attn": {
        "ms": _rotating(kd.decode_attn_cuda, ours),
        "plain_ms": _rotating(decode_attn_ref, ours),
        "library_ms": _rotating(lambda q4, k_t, v_t: sdpa(
            q4, k_t, v_t, attn_mask=mask, enable_gqa=True), lib)}}
    lo, hi = valid_rows(s, pos, win)
    bounds = {"decode_attn": decode_attn_bound(b, h, kv, dh, hi - lo + 1,
                                               dtype)}
    row = _time_calls(calls, bounds)["decode_attn"]
    row.update(B=b, H=h, KV=kv, Dh=dh, S=s, pos=pos, window=win,
               rows_read=hi - lo + 1, cache_copies=copies,
               plan=da_plan(b, h, kv, dh, lo, hi, dtype))
    return row


def time_decode_attn() -> dict:
    """K5 at gemma3-1b's decode shapes (a global and a local layer at the
    path's last step), L2-hot (one set of caches, as ``time_ms`` leaves
    them) and L2-cold (``DA_COLD_COPIES`` sets in turns), and one layer at
    B=8, S=32768 (268 MB: cold by itself). Library yardstick:
    ``scaled_dot_product_attention`` with GQA and the boolean mask over the
    whole cache, timed the same way."""
    pos = LM_PROMPT + LM_GEN - 1
    shape = (LM_DENSE_BATCH, 4, 1, 256)
    table = {}
    for name, s, p_, win, copies in (
            ("gemma3_global", LM_PROMPT + LM_GEN, pos, 0, 1),
            ("gemma3_local", LM_PROMPT + LM_GEN, pos, 512, 1),
            ("gemma3_global_cold", LM_PROMPT + LM_GEN, pos, 0, DA_COLD_COPIES),
            ("gemma3_local_cold", LM_PROMPT + LM_GEN, pos, 512, DA_COLD_COPIES),
            ("long_B8_S32768", 32768, 32767, 0, 1)):
        table[name] = _time_k5(*shape, s, p_, win, copies)
    return table


def time_zoo_decode_attn() -> dict:
    """K5 at every ``zoo_k5_shapes`` shape (the last decode step of each
    ``LM_ZOO`` model, every layer kind it has), L2-hot."""
    return {key: _time_k5(b, h, kv, dh, s, pos, win)
            for key, _, b, h, kv, dh, s, pos, win, _ in zoo_k5_shapes()}


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
    only.add_argument("--k4-only", action="store_true",
                      help="build the block-quantize kernels, check them "
                           "(kernel_check_quantize, "
                           "kernel_check_block_quant_fuse) and time them "
                           "(timing_k4), and stop: no other phase; the last "
                           "line as in a full run")
    only.add_argument("--zoo-only", action="store_true",
                      help="build the decode-attention kernel, check it "
                           "(kernel_check_decode_attn), run the lm_zoo "
                           "phase (every LM family at its published width) "
                           "and stop: the last line as in a full run")
    only.add_argument("--train-only", action="store_true",
                      help="build the block-quantize kernels, check the wire "
                           "forms, run the train phase (gemma3-1b at full "
                           "width, K4 at the gradients' sizes, two gloo "
                           "ranks, the Trainer resumed) and stop: its "
                           "kernels rows and the last line as in a full run")
    only.add_argument("--train-zoo-only", action="store_true",
                      help="build the WKV6 and block-quantize kernels, run "
                           "the train_zoo phase (K6's backward checked and "
                           "timed, rwkv6-3b at full width exact and int8, "
                           "the other families' smoke configs card vs CPU "
                           "and int8) and stop: its kernels rows and the "
                           "last line as in a full run")
    only.add_argument("--train-tp-only", action="store_true",
                      help="build the WKV6 and block-quantize kernels, run "
                           "the train_tp phase (tensor parallelism over "
                           "'model' on gloo ranks sharing the card) and "
                           "stop: the card's line and the last line as in "
                           "a full run")
    only.add_argument("--serve-tp-only", action="store_true",
                      help="build the decode-attention and WKV6 kernels, "
                           "run the serve_tp phase (sharded serving over "
                           "'model' on gloo ranks sharing the card, K5's "
                           "slice form checked and timed, the dry-run's "
                           "cells on meta) and stop: its kernels rows, the "
                           "card's line and the last line as in a full run")
    only.add_argument("--tp-zoo-only", action="store_true",
                      help="build the decode-attention and WKV6 kernels, "
                           "run the tp_zoo phase (the 'model' axis across "
                           "the zoo: the head_dim fallback, recurrentgemma "
                           "and whisper, K6's value-column form, on gloo "
                           "ranks sharing the card) and stop: its kernels "
                           "rows, the card's line and the last line as in "
                           "a full run")
    only.add_argument("--examples-only", action="store_true",
                      help="build the AMP and block-quantize kernels, run "
                           "the examples phase (the six twins of "
                           "examples/*.py on the card, their launches and "
                           "their kernels against the plain versions) and "
                           "stop: the card's line and the last line as in "
                           "a full run")
    only.add_argument("--sharded-only", action="store_true",
                      help="build every kernel, check the wire forms, run "
                           "the sharded phase and time the wire forms "
                           "(kernel_check_wire, sharded, timing_wire), and "
                           "stop: the last line as in a full run")
    parser.add_argument("--k3-parent", metavar="DIR",
                        help="a checkout of the parent tree: time its K3 "
                             "(prior as host numbers) in turns with this "
                             "one's (k3_operands phase)")
    args = parser.parse_args()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", nvidia_smi_name_power_limit=smi,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    names = (["wkv6"] if args.k6_only
             else ["decode_attn"] if args.k5_only or args.zoo_only
             else ["quantize"] if args.k4_only or args.train_only
             else ["wkv6", "quantize"] if (args.train_zoo_only
                                           or args.train_tp_only)
             else ["decode_attn", "wkv6"] if (args.serve_tp_only
                                              or args.tp_zoo_only)
             else ["amp_local", "amp_col", "quantize"] if args.examples_only
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
    if args.zoo_only:
        check_decode_attn_kernel()
        run_lm_zoo()
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(RESULT, fh, indent=1)
        print(smi, flush=True)
        print_last_line()
        return
    if args.train_only:
        check_wire_kernels()
        rows = train_kernel_rows(run_train())
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump({**RESULT, "kernels": rows}, fh, indent=1)
        print(smi, flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        print_last_line()
        return
    if args.train_zoo_only:
        rows = train_zoo_kernel_rows(run_train_zoo())
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump({**RESULT, "kernels": rows}, fh, indent=1)
        print(smi, flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        print_last_line()
        return
    if args.examples_only:
        run_examples()
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(RESULT, fh, indent=1)
        print(smi, flush=True)
        print_last_line()
        return
    if args.train_tp_only:
        run_train_tp()
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(RESULT, fh, indent=1)
        print(smi, flush=True)
        print_last_line()
        return
    if args.tp_zoo_only:
        rows = run_tp_zoo()["rows"]
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump({**RESULT, "kernels": rows}, fh, indent=1)
        print(smi, flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        print_last_line()
        return
    if args.serve_tp_only or not any(
            (args.k6_only, args.k5_only, args.k4_only, args.zoo_only,
             args.train_only, args.train_zoo_only, args.train_tp_only,
             args.sharded_only, args.examples_only)):
        start_dryrun()
    if args.serve_tp_only:
        rows = run_serve_tp()["rows"]
        finish_dryrun()
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump({**RESULT, "kernels": rows}, fh, indent=1)
        print(smi, flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        print_last_line()
        return
    if args.sharded_only:
        check_wire_kernels()
        run_sharded()
        emit("timing_wire", card=smi, kernels=time_wire_kernels())
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(RESULT, fh, indent=1)
        print(smi, flush=True)
        print_last_line()
        return
    if args.k6_only or args.k5_only or args.k4_only:
        if args.k6_only:
            check_wkv6_kernel()
            emit("timing_wkv6", card=smi, kernels=time_wkv6())
        elif args.k5_only:
            check_decode_attn_kernel()
            emit("timing_k5", card=smi, kernels=time_decode_attn())
        else:
            check_quantize_kernels()
            check_wire_kernels()
            check_block_quant_fuse()
            emit("timing_k4", card=smi, kernels=time_quantize_kernels(),
                 wire=time_wire_kernels())
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as fh:
                json.dump(RESULT, fh, indent=1)
        if not args.k6_only:
            print(smi, flush=True)
            print_last_line()
        return

    check_clusters()
    errs = check_kernels()
    errs_col = check_col_kernels()
    check_k3_per_instance()
    check_quantize_kernels()
    errs_wire = check_wire_kernels()
    errs_fuse = check_block_quant_fuse()
    check_against_cpu_reference()
    ctx = run_main_path()
    col_ctx = run_col_path(ctx)
    bq_ctx = run_block_quant_row(ctx)
    check_no_host_sync(ctx, col_ctx)
    serve_ctx = run_serve()
    erasure_ctx = run_erasure(ctx, col_ctx)
    cluster_ctx = run_cluster()
    sharded_ctx = run_sharded()
    ex_ctx = run_examples()
    errs_da = check_decode_attn_kernel()
    errs_wkv = check_wkv6_kernel()
    check_lm_small()
    lm_dense = run_lm(LM_DENSE, LM_DENSE_BATCH)
    lm_rwkv = run_lm(LM_RWKV, LM_RWKV_BATCH)

    kernel_times = time_kernels()
    col_times = time_col_kernels()
    quant_times = time_quantize_kernels()
    wire_times = time_wire_kernels()
    solve_times = time_solves(ctx)
    col_solve_times = time_col_solves(ctx, col_ctx)
    emit("k3_operands", card=smi, **time_k3_operands(args.k3_parent))
    emit("timing", card=smi,
         method="CUDA events, warm, median; kernels queued behind a busy "
                "device (device time), solves on an idle one (host pace "
                "included)",
         lc_step=kernel_times, col_kernels=col_times,
         quantize_kernels=quant_times, wire_kernels=wire_times,
         solve=solve_times,
         col_solve=col_solve_times, serve=serve_ctx["timing"])
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
    row_launches = ctx["launches"]
    col_launches, bq_launches = col_ctx["launches"], bq_ctx["launches"]
    # the serve, erasure and cluster phases' launches, each read just after
    # its own path
    sv_launches = {key: serve_ctx["launches"].get(key, 0)
                   + erasure_ctx["launches"].get(key, 0)
                   + cluster_ctx["launches"].get(key, 0)
                   for key in serve_ctx["launches"]}
    sh_launches = sharded_ctx["launches"]
    # training and then the LM zoo last, with the solve phases' operands
    # freed: a gemma3-1b train step peaks near 34 GB, qwen3-moe near 72
    del ctx, col_ctx, bq_ctx, serve_ctx, erasure_ctx, cluster_ctx, sharded_ctx
    _BUSY.clear()
    _free()
    train_ctx = run_train()
    _free()
    train_zoo_ctx = run_train_zoo()
    _free()
    train_tp_ctx = run_train_tp()
    _free()
    serve_tp_ctx = run_serve_tp()
    _free()
    tp_zoo_ctx = run_tp_zoo()
    _free()
    lm_zoo = run_lm_zoo()
    finish_dryrun()
    wire_err = max(r["max_abs_err"] for r in errs_wire.values())
    wire_row = lambda name: (wire_times["row_D1"][name],
                             sh_launches[name], wire_err)
    fuse_err = max(r["f_max_abs_err"] for r in errs_fuse.values())
    paper_col = errs_col[("paper_P25", "float32")]
    lc_err = lambda case: max(errs[(case, "float32")]["z_max_abs_err"],
                              errs[(case, "float32")]["f_max_abs_err"])
    rows = {
        "amp_local": (kernel_times["paper_P30/float32"]["amp_local"],
                      row_launches["amp_local"] + sv_launches["amp_local"],
                      lc_err("paper_P30")),
        # no driven path takes it any more (N <= 131072 everywhere); timed
        # and checked past the cluster's reach
        "amp_local_two_pass": (
            kernel_times[f"{TWO_PASS_CASE}/float32"]["amp_local_two_pass"],
            row_launches["amp_local_two_pass"]
            + col_launches["amp_local_two_pass"]
            + bq_launches["amp_local_two_pass"]
            + sv_launches["amp_local_two_pass"], lc_err(TWO_PASS_CASE)),
        "col_residual": (col_times["paper_P25/float32"]["col_residual"],
                         col_launches["col_residual"]
                         + sv_launches["col_residual"],
                         paper_col["r_max_abs_err"]),
        "col_inner": (col_times["paper_P25/float32"]["col_inner_final"],
                      col_launches["col_inner"] + sv_launches["col_inner"],
                      max(paper_col["x_max_abs_err_final"],
                          paper_col["x_max_abs_err_upd"],
                          paper_col["z_max_abs_err_upd"])),
        # compressed_psum's wire forms (the sharded phase, counts set to 0
        # just before its driven solves), timed at the paper's row message
        # over a world of one (one chunk of 10240), the shape that run
        # gives them
        "quantize_blocks": wire_row("quantize_blocks"),
        "dequantize_blocks": wire_row("dequantize_blocks"),
        "quantize_blocks_packed": wire_row("quantize_blocks_packed"),
        "dequantize_blocks_packed": wire_row("dequantize_blocks_packed"),
        "dequantize_sum": wire_row("dequantize_sum"),
        "dequantize_sum_packed": wire_row("dequantize_sum_packed"),
        "block_quant_fuse": (quant_times["row_messages"]["block_quant_fuse"],
                             col_launches["block_quant_fuse"]
                             + bq_launches["block_quant_fuse"]
                             + sv_launches["block_quant_fuse"], fuse_err),
        # gemma3-1b's serve path (B=8), read just after its generate
        "decode_attn": (lm_times["gemma3_global"],
                        lm_dense["launches"]["decode_attn"],
                        errs_da["gemma3_global"]["max_abs_err"]),
        "wkv6": (lm_times["rwkv6_3b_prefill"], lm_rwkv["launches"]["wkv6"],
                 max(errs_wkv["rwkv6_3b_prefill"]["y_max_abs_err"],
                     errs_wkv["rwkv6_3b_state0"]["y_max_abs_err"])),
    }
    kernels = []
    for name, (tm, launches, err) in rows.items():
        assert launches > 0 or name in UNDRIVEN, (name, launches)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})
    # K4 at the train path's gradient sizes (phase train)
    kernels += train_kernel_rows(train_ctx)
    # K6's backward and K6 at rwkv6-3b's training shape (phase train_zoo)
    kernels += train_zoo_kernel_rows(train_zoo_ctx)
    # every K4 and K6 row: its launches on the train_tp phase's paths
    add_train_tp_launches(kernels, train_tp_ctx)
    # K1, K2, K3 and K4's wire forms: their launches on the twins' paths
    add_examples_launches(kernels, ex_ctx)
    # K5's slice form on the serve_tp phase's paths, (a) and (c)
    kernels += serve_tp_ctx["rows"]
    # K5's slice form at the tp_zoo phase's shapes, K6's value-column form
    # and its backward on (d)'s path
    kernels += tp_zoo_ctx["rows"]
    # K5 on the zoo's paths: a row a model and layer kind, timed at that
    # shape, with the calls its model's generate made there
    zoo_case = zoo_da_cases()
    for key, *_ in zoo_k5_shapes():
        tm = lm_zoo["k5"][key]
        assert tm["launches"] > 0, (key, tm)
        kernels.append({
            "name": f"decode_attn/{key}", "route": "cuda",
            "source": SOURCES["decode_attn"],
            "replaces": REPLACES["decode_attn"], "launches": tm["launches"],
            "max_abs_err": errs_da[zoo_case[key]]["max_abs_err"],
            "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": tm["library_ms"]})

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
