"""Multi-pod dry run: one rank's count of every (arch x shape x mesh) cell,
the port of the JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder host devices
and reads XLA's per-device memory, FLOPs and the collectives of the
partitioned HLO. Here nothing is compiled, no process group is made and no
card is touched: rank 0 of the cell's mesh (pod1 = (data 16, model 16),
pod2 = (pod 2, data 16, model 16)) is a counting mesh
(``launch/mesh.py::make_count_mesh``), and the cell's step (the train step,
or the prefill or decode step of ``build_serve_step``) runs once on
``meta`` tensors of the rank's shapes. Per cell:

  * ``memory.argument_bytes``: the step's arguments on this rank by the
    rules' slices (parameters, AdamW's master / m / v under ZeRO-1 and its
    step, the decode state, the tokens, labels, pos and stub inputs), what
    the reference's ``memory_analysis().argument_size_in_bytes`` gives;
    ``memory.output_bytes``: the step's outputs on this rank;
  * ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode`` over
    the step (its matrix products) plus the hand-written kernels' own
    operation counts (``kernels/meta.py``, by kernel under ``kernels``);
  * ``collectives`` ({kind: count, result_bytes, wire_bytes}),
    ``wire_bytes_per_device`` and ``wire_bytes_crosspod`` (collectives over
    a group that spans "pod"), with the reference's ring factors
    (``parse_collectives``: all-reduce 2(n-1)/n, all-gather / reduce-scatter
    / all-to-all (n-1)/n, a point-to-point 1);
  * ``n_devices``.

A cell that raises is recorded ``ok: false`` with its error, as the
reference records a FAIL.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh pod1
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, get_config, list_archs
from ..configs.base import ModelConfig, ShapeSpec
from ..kernels import meta
from ..models.model_api import aux_abstract
from .mesh import make_count_mesh
from .steps import TrainStepConfig, build_serve_step, build_train_step

__all__ = ["LONG_OK", "cell_config", "run_cell", "count_cell", "count_mesh",
           "serve_argument_bytes", "train_argument_bytes", "wire_summary",
           "padded_heads", "main"]

# long_500k runs only for sub-quadratic-attention families (DESIGN.md §5)
LONG_OK = {"rwkv6-3b", "recurrentgemma-2b", "gemma3-1b", "mixtral-8x7b"}

# the port's collectives -> the reference's HLO kinds and ring factors
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "send": "collective-permute", "recv": "collective-permute"}


def cell_config(cfg: ModelConfig, shape: ShapeSpec) -> TrainStepConfig:
    mb = 8 if shape.kind == "train" else 1
    return TrainStepConfig(microbatches=mb, moe_groups=64)


def padded_heads(cfg: ModelConfig, multiple: int) -> ModelConfig:
    """The reference's head-padding transform (``ModelConfig.
    padded_heads``): q heads rounded up to ``multiple``, kv too where the
    grouping needs it; padded heads are masked after PV."""
    up = lambda n: -(-n // multiple) * multiple
    g_real = cfg.n_heads // cfg.n_kv_heads
    hp = up(cfg.n_heads)
    kvp = cfg.n_kv_heads
    if hp % cfg.n_kv_heads:
        kvp = up(cfg.n_kv_heads)
        hp = kvp * g_real
    return dataclasses.replace(cfg, n_heads_padded=hp, n_kv_heads_padded=kvp)


def count_mesh(mesh_kind: str):
    """Rank 0's counting view of the production mesh ``mesh_kind``."""
    if mesh_kind == "pod2":
        return make_count_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_count_mesh((16, 16), ("data", "model"))


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _unread(step, group: str, key: str | None = None) -> bool:
    """Whether the step never reads this argument (``jax.jit`` drops it):
    rwkv6's decode position; whisper's encoder and cross-attention K/V
    weights in a decode step (its cross K/V are in the state)."""
    if not step.decode:
        return False
    if group == "pos":
        return step.cfg.family == "rwkv6"
    return (group == "params" and step.cfg.family == "whisper"
            and (key.startswith(("enc/", "enc_final_norm/"))
                 or key in ("dec/cross/wk", "dec/cross/wv")))


def serve_argument_bytes(step) -> dict:
    """A ``ServeStep``'s arguments on its rank by the rules' slices, by
    group (params, tokens, aux or state and pos). An argument the step
    never reads counts nothing, as ``jax.jit`` drops it (``_unread``)."""
    out = {}
    for group, ab in step.abstract.items():
        loc = step.local_shapes[group]
        if isinstance(ab, dict):
            out[group] = sum(_nbytes(loc[k], t.dtype) for k, t in ab.items()
                             if not _unread(step, group, k))
        else:
            out[group] = 0 if _unread(step, group) else _nbytes(loc,
                                                                ab.dtype)
    return out


def train_argument_bytes(step) -> dict:
    """A ``TrainStep``'s arguments on its rank: bf16 parameters by their
    "model" slices, AdamW's float32 master / m / v by their ZeRO-1 slices of
    those and its int32 step, int32 tokens and labels and bf16 stub inputs
    of the rank's rows."""
    m = step.mesh.shape.get("model", 1)
    z = step._zsize()
    par = opt = 0
    for k, shape in step.param_shapes.items():
        n = 1
        for d in shape:
            n *= d
        n //= m if step.model_dims[k] is not None else 1
        par += 2 * n
        opt += 3 * 4 * (n // (z if step.zero_dims[k] is not None else 1))
    rows, seq = step.rows, step.shape.seq_len
    aux = sum(_nbytes((rows,) + tuple(t.shape[1:]), t.dtype) for t in
              _train_aux(step).values())
    return {"params": par, "opt_state": opt + 4, "tokens": 4 * rows * seq,
            "labels": 4 * rows * seq, "aux": aux}


def _train_aux(step) -> dict:
    return aux_abstract(step.cfg, step.shape.global_batch)


def _meta_like(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _out_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_out_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_out_bytes(v) for v in tree)
    return 0


def wire_summary(meshes) -> tuple[dict, float, float]:
    """(collectives by the reference's kind, wire bytes a device, of which
    over groups that span "pod") from the counting meshes' stats."""
    coll: dict = {}
    wire = cross = 0.0
    seen = set()
    for mesh in meshes:
        if id(mesh.stats) in seen:
            continue
        seen.add(id(mesh.stats))
        for key, rec in mesh.stats.snapshot()["groups"].items():
            op, axes, n = key.split(" ")
            n = int(n)
            eff = (n - 1) / n if n > 1 else 1.0
            b = float(rec["bytes"])
            kind = _KINDS[op]
            if op == "all_reduce":
                res, w = b, 2.0 * b * eff
            elif op == "all_gather":
                res, w = b * n, b * n * eff
            elif op in ("reduce_scatter", "all_to_all"):
                res, w = (b / n if op == "reduce_scatter" else b), b * eff
            else:
                res, w = b, b
            d = coll.setdefault(kind, {"count": 0, "result_bytes": 0.0,
                                       "wire_bytes": 0.0})
            d["count"] += rec["calls"]
            d["result_bytes"] += res
            d["wire_bytes"] += w
            wire += w
            if "pod" in axes.split("+"):
                cross += w
    return coll, wire, cross


def _run_serve(cfg, mesh, shape, trace: bool = True):
    step = build_serve_step(cfg, mesh, shape)
    if not trace:
        return serve_argument_bytes(step), None
    params = {k: _meta_like(step.local_shapes["params"][k], torch.bfloat16)
              for k in step.abstract["params"]}
    tokens = _meta_like(step.local_shapes["tokens"], torch.int32)
    if shape.kind == "prefill":
        out = step(params, tokens, step.abstract["aux"])
    else:
        out = step(params, tokens, step.init_state(), shape.seq_len - 1)
    return serve_argument_bytes(step), out


def _run_train(cfg, mesh, shape, tcfg, trace: bool = True):
    step = build_train_step(cfg, mesh, shape, tcfg)
    if not trace:
        return train_argument_bytes(step), None
    params = {}
    for k, full in step.param_shapes.items():
        d = step.model_dims[k]
        loc = list(full)
        if d is not None:
            loc[d] //= mesh.shape.get("model", 1)
        params[k] = _meta_like(loc, torch.bfloat16)
    opt = step.init_opt_state(params)
    tok = _meta_like((step.rows, shape.seq_len), torch.int32)
    out = step(params, opt, tok, tok.clone(), _train_aux(step))
    return train_argument_bytes(step), out


def count_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               tcfg: TrainStepConfig | None = None,
               trace: bool = True) -> dict:
    """The counts of one step of ``cfg`` for ``shape`` on the counting
    ``mesh`` (``make_count_mesh``; ``tcfg`` for a train shape): trace_s,
    flops (matrix products and the kernels'), kernels, memory and the
    collectives (the module docstring's keys). Without ``trace`` the step
    is built but not run: the argument bytes alone (the meta trace of a
    long prefill or a train step takes minutes: its attention streams
    over hundreds of chunk pairs a layer, each a few dozen meta ops)."""
    t0 = time.time()
    if not trace:
        run = _run_train if shape.kind == "train" else _run_serve
        args, _ = run(cfg, mesh, shape, *((tcfg,) if tcfg else ()),
                      trace=False)
        return {"memory": {"argument_bytes": int(sum(args.values())),
                           "argument_bytes_by_group": args}}
    with meta.tally() as kernels, FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            args, out = _run_train(cfg, mesh, shape, tcfg)
        else:
            args, out = _run_serve(cfg, mesh, shape)
    matmul = float(fc.get_total_flops())
    coll, wire, cross = wire_summary(mesh.meshes.values())
    return {"trace_s": round(time.time() - t0, 1),
            "flops_matmul_per_device": matmul, "kernels": kernels,
            "flops_per_device": matmul + sum(v["flops"] for v in
                                             kernels.values()),
            "memory": {"argument_bytes": int(sum(args.values())),
                       "argument_bytes_by_group": args,
                       "output_bytes": int(_out_bytes(out))},
            "collectives": coll, "wire_bytes_per_device": wire,
            "wire_bytes_crosspod": cross}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             compression: str = "default", pad_heads: int = 0,
             scores_bf16: bool = False, strategy: str = "tp",
             microbatches: int | None = None, q_chunk: int = 0,
             bytes_only: bool = False) -> dict:
    """One cell's record (the reference's keys where they are defined);
    ``bytes_only``: the argument bytes without the step's trace
    (``count_cell``)."""
    cfg = get_config(arch)
    if pad_heads:
        cfg = padded_heads(cfg, pad_heads)
    if scores_bf16:
        cfg = dataclasses.replace(cfg, scores_bf16=True)
    if q_chunk:
        cfg = dataclasses.replace(cfg, attn_q_chunk=q_chunk)
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "compression": compression, "pad_heads": pad_heads,
                 "scores_bf16": scores_bf16, "strategy": strategy,
                 "bytes_only": bytes_only, "ok": False}
    if shape_name == "long_500k" and arch not in LONG_OK:
        rec.update(skipped=True,
                   reason="full-attention arch; long_500k skipped per "
                          "DESIGN.md §5")
        return rec
    multi = mesh_kind == "pod2"
    n_dev = 512 if multi else 256
    t0 = time.time()
    try:
        tcfg = None
        if shape.kind == "train":
            bits = {"default": 8 if multi else None, "none": None,
                    "int8": 8, "int4": 4}[compression]
            tcfg = cell_config(cfg, shape)
            mb = microbatches
            if mb is None:
                mb = 1 if (strategy == "fsdp" or multi) else tcfg.microbatches
            tcfg = dataclasses.replace(tcfg, compression_bits=bits,
                                       strategy=strategy, microbatches=mb)
        rec.update(count_cell(cfg, shape, count_mesh(mesh_kind), tcfg,
                              trace=not bytes_only))
        rec["n_devices"] = n_dev
        rec["ok"] = True
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="pod1",
                    choices=["pod1", "pod2", "both"])
    ap.add_argument("--compression", type=str, default="default",
                    choices=["default", "none", "int8", "int4"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun")
    ap.add_argument("--pad-heads", type=int, default=0)
    ap.add_argument("--scores-bf16", action="store_true")
    ap.add_argument("--strategy", type=str, default="tp",
                    choices=["tp", "tp_sp", "fsdp"])
    ap.add_argument("--tag", type=str, default="")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--q-chunk", type=int, default=0)
    ap.add_argument("--bytes-only", action="store_true",
                    help="argument bytes by the rules, no trace")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    else:
        cells = [(args.arch, args.shape)]
    records = []
    for arch, shape in cells:
        for mk in meshes:
            rec = run_cell(arch, shape, mk, args.compression,
                           pad_heads=args.pad_heads,
                           scores_bf16=args.scores_bf16,
                           strategy=args.strategy,
                           microbatches=args.microbatches,
                           q_chunk=args.q_chunk, bytes_only=args.bytes_only)
            tag = f"{arch}_{shape}_{mk}" + (
                f"_{args.compression}" if args.compression != "default"
                else "") + (f"_{args.tag}" if args.tag else "")
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            status = ("SKIP" if rec.get("skipped")
                      else "OK" if rec["ok"] else "FAIL")
            print(f"[{status}] {tag} ({rec.get('total_s', 0)}s) "
                  f"flops/dev={rec.get('flops_per_device', 0):.3g} "
                  f"wire/dev={rec.get('wire_bytes_per_device', 0):.3g}",
                  flush=True)
            if not rec["ok"] and not rec.get("skipped"):
                print(rec.get("error", ""), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
