"""The port's dry run (``launch/dryrun.py``): one rank's count of a cell on
a counting mesh, its step run once on ``meta`` tensors.

  * ``memory.argument_bytes`` equals the reference's
    ``compiled.memory_analysis().argument_size_in_bytes`` exactly, for the
    prefill and decode steps of gemma3-1b, rwkv6 and qwen3-moe smoke
    configs at (data 1, model 2) and (2, 2) and their 'tp' train steps at
    (1, 2), and at (1, 2) a head_dim-fallback decode (gemma3-1b with 3
    heads), recurrentgemma's prefill and whisper's decode: the reference's
    ``build_serve_step`` / ``build_train_step`` jitted with their shardings
    in subprocesses of 2 and 4 host devices;
  * the counted collectives (every axis group's calls and bytes by dtype)
    equal ``Mesh.stats`` of a live gloo world running the same prefill and
    decode steps (bf16 weights) at (1, 2) and (2, 2), rank by rank;
  * the dense smoke prefill's FLOPs (a world of one) equal a closed form of
    its matrix products, and a decode cell counts K5's slice form only on
    the layers whose window reaches the rank's rows;
  * ``--all --mesh both`` (``--bytes-only``: the production configs on
    the production meshes, no trace) writes a record for every (arch x
    shape x mesh) cell: ok, or skipped (long_500k outside ``LONG_OK``);
    ``--bytes-only`` gives the traced run's bytes.
"""
import concurrent.futures
import dataclasses
import json
import os

import pytest

from conftest import run_multidev

from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_count_mesh

import torch_serve_tp as S
import torch_spmd
import torch_train_tp as TT

ARCHS = ("gemma3-1b", "rwkv6-3b", "qwen3-moe-30b-a3b")
SEQ, BATCH, GROUPS = 64, 4, 16
CELLS = [(a, k, m) for a in ARCHS for k in ("prefill", "decode")
         for m in ((1, 2), (2, 2))] + [(a, "train", (1, 2)) for a in ARCHS]
# the head_dim fallback (3 heads on a "model" axis of 2), recurrentgemma's
# LRU columns and whisper's heads over "model"
CELLS += [("gemma3-1b/h3", "decode", (1, 2)),
          ("recurrentgemma-2b", "prefill", (1, 2)),
          ("whisper-small", "decode", (1, 2))]
IDS = [f"{a}-{k}-{m[0]}x{m[1]}" for a, k, m in CELLS]

REFERENCE = r'''
import sys, json, dataclasses
import jax
from repro.compat import make_mesh
from repro.configs import get_config
from repro.configs.base import ShapeSpec
from repro.launch.steps import (build_serve_step, build_train_step,
                                TrainStepConfig)
out_path, seq, batch, groups = sys.argv[1], *map(int, sys.argv[2:5])
cells = json.loads(sys.argv[5])
out = {}
for case, kind, ms in cells:
    arch, _, variant = case.partition("/")
    cfg = get_config(arch).smoke_config()
    if variant == "h3":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1)
    mesh = make_mesh(tuple(ms), ("data", "model"))
    shape = ShapeSpec("x", seq, batch, kind)
    if kind == "train":
        fn, sh, ab = build_train_step(cfg, mesh, shape, TrainStepConfig(
            microbatches=1, moe_groups=groups))
        keys = ("params", "opt_state", "tokens", "labels", "aux")
    else:
        fn, sh, ab = build_serve_step(cfg, mesh, shape)
        keys = (("params", "tokens", "aux") if kind == "prefill"
                else ("params", "tokens", "state", "pos"))
    c = jax.jit(fn, in_shardings=tuple(sh[k] for k in keys)).lower(
        *(ab[k] for k in keys)).compile()
    out[f"{case} {kind} {ms}"] = int(c.memory_analysis().argument_size_in_bytes)
json.dump(out, open(out_path, "w"))
print("ok")
'''


def _reference(path, n_dev):
    cells = json.dumps([[a, k, list(m)] for a, k, m in CELLS
                        if m[0] * m[1] == n_dev])
    code = ("import sys; sys.argv = ['ref', %r, '%d', '%d', '%d', %r]\n"
            % (path, SEQ, BATCH, GROUPS, cells)) + REFERENCE
    run_multidev(code, n_dev, timeout=300)
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocesses (2 and 4 host devices) and the two live
    gloo worlds, all at once."""
    tmp = tmp_path_factory.mktemp("dry")
    params = {c: S.full_params(c) for c in ARCHS}
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        ref = [ex.submit(_reference, os.path.join(str(tmp), f"ref{n}.json"),
                         n) for n in (2, 4)]
        live = {}
        for ms in ((1, 2), (2, 2)):
            path = tmp / f"w{ms[0]}{ms[1]}"
            path.mkdir()
            live[ms] = ex.submit(torch_spmd.run_world, S.stats_cases,
                                 ms[0] * ms[1], path, ms, ("data", "model"),
                                 ARCHS, params, BATCH, SEQ)
        return {"reference": {**ref[0].result(timeout=330),
                              **ref[1].result(timeout=330)},
                "live": {ms: f.result(timeout=torch_spmd.TIMEOUT_S + 30)
                         for ms, f in live.items()}}


def _count(arch, kind, ms, rank=0):
    cfg = TT.config(arch)
    shape = ShapeSpec("x", SEQ, BATCH, kind)
    tcfg = (dataclasses.replace(dryrun.cell_config(cfg, shape),
                                microbatches=1, moe_groups=GROUPS)
            if kind == "train" else None)
    mesh = make_count_mesh(ms, ("data", "model"), rank)
    return dryrun.count_cell(cfg, shape, mesh, tcfg), mesh


@pytest.mark.parametrize("arch,kind,ms", CELLS, ids=IDS)
def test_argument_bytes_equal_reference(runs, arch, kind, ms):
    got = _count(arch, kind, ms)[0]["memory"]["argument_bytes"]
    assert got == runs["reference"][f"{arch} {kind} {list(ms)}"]


@pytest.mark.parametrize("ms", ((1, 2), (2, 2)), ids=("1x2", "2x2"))
@pytest.mark.parametrize("arch", ARCHS)
def test_counted_collectives_equal_live_world(runs, arch, ms):
    for rank, got in enumerate(runs["live"][ms]):
        for kind in ("prefill", "decode"):
            _, mesh = _count(arch, kind, ms, rank)
            want = got[(arch, kind)]
            counted = {"+".join(axes): {k: m.stats.snapshot()[k]
                                        for k in ("calls", "bytes")}
                       for axes, m in mesh.meshes.items()}
            assert counted == want, (rank, kind)
            assert any(v["calls"] for v in want.values())


def test_dense_prefill_flops_closed_form():
    """gemma3-1b smoke, B=4 x 64, a world of one: per layer the q / k / v
    / o projections, the scores and PV over all 64 x 64 positions (the
    scores are materialised up to 2048 positions) and the three MLP
    products; then the last 64 positions' logits over the padded vocab."""
    cfg = get_config("gemma3-1b").smoke_config()
    b, s, d, f = BATCH, SEQ, cfg.d_model, cfg.d_ff
    h, kv, dh, v = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.vocab_padded
    layer = (2 * b * s * d * (h + 2 * kv) * dh + 2 * b * s * h * dh * d
             + 2 * 2 * b * h * s * s * dh + 3 * 2 * b * s * d * f)
    want = cfg.n_layers * layer + 2 * b * 64 * d * v
    mesh = make_count_mesh((1, 1), ("data", "model"))
    got = dryrun.count_cell(cfg, ShapeSpec("x", s, b, "prefill"), mesh)
    assert got["flops_matmul_per_device"] == want
    assert got["kernels"] == {} and got["collectives"] == {}


def test_decode_counts_k5_slice_only_where_the_window_reaches():
    """At (1, 2) a decode cell's position is 63, the last row; rank 0 holds
    rows 0..31, which gemma3's local window (32: rows 32..63) misses: it
    counts K5's slice form on its one global layer only, rank 1 on all
    six."""
    cfg = get_config("gemma3-1b").smoke_config()
    calls = [_count("gemma3-1b", "decode", (1, 2), r)[0]["kernels"]
             ["decode_attn_slice"]["calls"] for r in (0, 1)]
    assert calls == [cfg.attn_kinds.count("global"), cfg.n_layers]


def test_all_cells_recorded(tmp_path):
    records = dryrun.main(["--all", "--mesh", "both", "--bytes-only",
                           "--out", str(tmp_path)])
    assert len(records) == len(list_archs()) * len(SHAPES) * 2
    assert len(os.listdir(tmp_path)) == len(records)
    for rec in records:
        if rec.get("skipped"):
            assert rec["shape"] == "long_500k"
            assert rec["arch"] not in dryrun.LONG_OK
        else:
            # every cell runs on a "model" axis of 16 (the head_dim
            # fallback, rglru and whisper among them)
            assert rec["ok"], rec.get("error")


def test_train_cells_count_the_kernels_meta_forms():
    """rwkv6's train step on meta counts K6 and its backward (one a layer,
    the forward again in the recompute); gemma3's at (pod 2, data 1, model
    2) with int8 over "pod" counts K4a twice, K4b-sum and K4b once a leaf,
    its wire over "pod" cross-pod."""
    cfg = get_config("rwkv6-3b").smoke_config()
    shape = ShapeSpec("x", SEQ, BATCH, "train")
    tcfg = dataclasses.replace(dryrun.cell_config(cfg, shape),
                               microbatches=1, moe_groups=GROUPS)
    got = dryrun.count_cell(cfg, shape, make_count_mesh(
        (1, 2), ("data", "model")), tcfg)["kernels"]
    assert got["wkv6"]["calls"] == 2 * cfg.n_layers
    assert got["wkv6_bwd"]["calls"] == cfg.n_layers
    cfg = get_config("gemma3-1b").smoke_config()
    tcfg = dataclasses.replace(tcfg, compression_bits=8)
    mesh = make_count_mesh((2, 1, 2), ("pod", "data", "model"))
    rec = dryrun.count_cell(cfg, shape, mesh, tcfg)
    leaves = len(S.full_params("gemma3-1b"))
    assert rec["kernels"]["quantize_blocks"]["calls"] == 2 * leaves
    assert rec["kernels"]["dequantize_sum"]["calls"] == leaves
    assert rec["kernels"]["dequantize_blocks"]["calls"] == leaves
    assert 0 < rec["wire_bytes_crosspod"] < rec["wire_bytes_per_device"]
    assert rec["collectives"]["all-to-all"]["count"] == 2 * leaves


@pytest.mark.parametrize("arch,kind,ms", CELLS[:4], ids=IDS[:4])
def test_bytes_only_gives_the_traced_bytes(arch, kind, ms):
    cfg = get_config(arch).smoke_config()
    shape = ShapeSpec("x", SEQ, BATCH, kind)
    mesh = make_count_mesh(ms, ("data", "model"))
    got = dryrun.count_cell(cfg, shape, mesh, trace=False)
    assert got["memory"] == {k: v for k, v in _count(arch, kind, ms)[0][
        "memory"].items() if k != "output_bytes"}
