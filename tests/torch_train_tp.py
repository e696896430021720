"""What the ranks of the gloo worlds of ``test_torch_train_tp.py`` run (the
port's train step on a "model" axis, ``tensor_parallel.py``), and the world
of one it is held to.

Imports the port only (no ``jax``, nothing of ``repro``): the spawned ranks
import it. Results go back as numpy arrays and Python numbers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core.collectives import all_gather
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.steps import TrainStepConfig, build_train_step
from repro_torch.models import model_api, moe
from repro_torch.models.model_api import train_forward
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig

# the smoke configs of every family with a "model" form: gemma3-1b's one
# KV head (the GQA mapping by global head index), qwen3-moe's experts over
# "model", qwen2-vl's M-RoPE and vision stub, rwkv6's heads
ARCHS = ("granite-3-8b", "gemma3-1b", "qwen3-moe-30b-a3b", "qwen2-vl-7b",
         "rwkv6-3b")
# mixtral with 3 experts: "experts" does not divide 2, so "expert_mlp"
# (each expert's d_ff) takes "model"
E3 = "mixtral-8x7b/e3"
# qwen3-moe with whole experts under 'tp_sp' (test_torch_moe_tp_sp.py)
MOE_WHOLE = ("qwen3-moe-30b-a3b/whole", "qwen3-moe-30b-a3b/whole_cf1")
SEQ, BATCH, MOE_GROUPS = 32, 8, 2
CONVERGE_ARCH, CONVERGE_STEPS, CONVERGE_LR = "granite-3-8b", 12, 2e-3


def config(case: str):
    """The smoke config of ``arch[/variant]``: "e3" 3 experts; "h3" 3 heads
    (one K/V head; rwkv6 a d_model of 3 heads), which "model" = 2 does not
    divide: the rules' head_dim fallback; "ff129" a d_ff of 129, which it
    does not divide either: the MLP's weights whole on every rank; "whole"
    3 experts of a d_ff of 129, neither of which "model" = 2 divides: whole
    experts on every rank ("whole_cf1" at a capacity factor of 1, where
    slots are dropped)."""
    arch, _, variant = case.partition("/")
    cfg = get_config(arch).smoke_config()
    if variant == "e3":
        cfg = dataclasses.replace(cfg, n_experts=3)
    elif variant in ("whole", "whole_cf1"):
        cfg = dataclasses.replace(cfg, n_experts=3, d_ff=129)
        if variant == "whole_cf1":
            cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    elif variant == "h3":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=1)
        if cfg.family == "rwkv6":
            cfg = dataclasses.replace(cfg, d_model=3 * cfg.d_head)
    elif variant == "ff129":
        cfg = dataclasses.replace(cfg, d_ff=129)
    return cfg


def aux_inputs(cfg) -> dict:
    """The stub inputs of the global batch, float32 from a numpy seed (the
    same on every rank): qwen2-vl's vision embeddings, whisper's frames."""
    n = (cfg.n_audio_frames if cfg.family == "whisper"
         else cfg.n_vision_tokens)
    if not n:
        return {}
    rng = np.random.default_rng(2)
    a = rng.normal(size=(BATCH, n, cfg.d_model))
    key = "frames" if cfg.family == "whisper" else "vision_embeds"
    return {key: torch.from_numpy(a.astype(np.float32))}


def _np(tree) -> dict:
    return {k: v.detach().float().numpy().copy() for k, v in tree.items()}


def _nbytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values())


def _same_on_model_ranks(t, mesh) -> bool:
    """Whether every "model" rank holds the same bits of ``t``."""
    g = all_gather(t.detach().contiguous(), mesh.axis("model"))
    return all(torch.equal(g[0], x) for x in g[1:])


def step_case(mesh, case: str, strategy: str, microbatches: int = 1) -> dict:
    """One step of ``case`` on ``mesh`` from the seed-0 init cast to
    float32, on the seed-1 batch 0: the fused gradients (whole leaves), the
    metrics, the updated parameters (whole) and this rank's bytes."""
    cfg = config(case)
    step = build_train_step(cfg, mesh, ShapeSpec("tp", SEQ, BATCH, "train"),
                            TrainStepConfig(strategy=strategy,
                                            microbatches=microbatches,
                                            moe_groups=MOE_GROUPS))
    params = {k: v.float() for k, v in step.init_params(0).items()}
    opt = step.init_opt_state(params)
    tok, lab = SyntheticLMData(cfg.vocab, SEQ, BATCH, seed=1).global_arrays(
        0, mesh, step.batch_axes)
    aux = aux_inputs(cfg)
    loss, grads = step._grads(params, tok, lab, step._aux_rows(aux))
    with torch.no_grad():
        loss, grads, _ = step._fuse(loss, grads)
    out = {"loss_fused": float(loss),
           "grads": _np(step.gather_params(grads)),
           "bytes": {"params": _nbytes(params),
                     "opt": sum(_nbytes(opt[k]) for k in ("master", "m",
                                                          "v"))}}
    whole_before = step.gather_params(params)
    new_p, _, m = step(params, opt, tok, lab, aux)
    out.update({k: float(v) for k, v in m.items()})
    out["params"] = _np(step.gather_params(new_p))
    out["moved"] = any(not torch.equal(whole_before[k], v)
                       for k, v in step.gather_params(new_p).items())
    if step.tp is not None:
        out["replicas_identical"] = all(
            _same_on_model_ranks(new_p[k], mesh)
            for k in sorted(new_p) if step.model_dims[k] is None)
        if strategy == "tp":
            with torch.no_grad():
                hidden = train_forward(params, tok, cfg, True, MOE_GROUPS,
                                       step.tp, **step._aux_rows(aux))
            out["hidden_identical"] = _same_on_model_ranks(hidden, mesh)
    return out


@contextlib.contextmanager
def float32_head():
    """The loss's LM head fed the float32 hidden state instead of its bf16
    rounding (``model_api._chunk_logits``' cast) while the block runs."""
    saved = model_api._chunk_logits
    model_api._chunk_logits = lambda hc, table: torch.matmul(
        hc.float(), table.float().T)
    try:
        yield
    finally:
        model_api._chunk_logits = saved


def tp_cases(_serve_mesh, shape: tuple, names: tuple, cases: list) -> dict:
    """Every (case, strategy) of ``cases`` on this rank of a world laid out
    as ``shape`` over ``names``; and on a pod mesh the two reference reds'
    intent (12 steps exact and int8 over "pod", 'tp'). The LM head takes
    the float32 hidden state (``float32_head``), as in the world of one:
    its bf16 rounding would flip with the summation order."""
    mesh = make_mesh(shape, names, device="cpu")
    with float32_head():
        out = {"coords": mesh.coords,
               "cases": {(c, s): step_case(mesh, c, s) for c, s in cases}}
    if "pod" in mesh.shape:
        out["converge"] = converge(mesh)
    return out


def converge(mesh) -> dict:
    cfg = get_config(CONVERGE_ARCH).smoke_config()
    shape = ShapeSpec("c", SEQ, BATCH, "train")
    data = SyntheticLMData(cfg.vocab, SEQ, BATCH, seed=1)
    out = {}
    for bits in (None, 8):
        step = build_train_step(cfg, mesh, shape, TrainStepConfig(
            compression_bits=bits, adamw=AdamWConfig(lr=CONVERGE_LR)))
        params = step.init_params(0)
        opt = step.init_opt_state(params)
        mesh.axis("pod").stats.reset()
        losses = []
        for i in range(CONVERGE_STEPS):
            tok, lab = data.global_arrays(i, mesh, step.batch_axes)
            params, opt, m = step(params, opt, tok, lab, donate=True)
            losses.append(float(m["loss"]))
        out[bits] = {"losses": losses,
                     "pod": mesh.axis("pod").stats.snapshot()}
    return out


def moe_whole_cases(_serve_mesh, shape: tuple, names: tuple,
                    strategy: str) -> dict:
    """``step_case`` of each whole-expert MoE of ``MOE_WHOLE`` on this rank
    of a world laid out as ``shape`` over ``names`` (() : the world of
    one), the LM head fed the float32 hidden state, with every dispatch's
    ``keep``."""
    mesh = (make_mesh(shape, names, device="cpu") if shape
            else make_host_mesh(model=1, device="cpu"))
    out = {}
    for case in MOE_WHOLE:
        with float32_head(), moe.recorded_keeps() as keeps:
            out[case] = step_case(mesh, case, strategy)
        out[case]["keeps"] = [k.numpy() for k in keeps]
    return out


def one_cases(_serve_mesh, runs: list) -> dict:
    """The world of one: each (case, microbatches) of ``runs``, the LM head
    fed the float32 hidden state (``float32_head``)."""
    mesh = make_host_mesh(model=1, device="cpu")
    with float32_head():
        return {(c, mb): step_case(mesh, c, "tp", mb) for c, mb in runs}


# -- checkpoints across "model" sizes -----------------------------------------

CKPT_ARCH, CKPT_STEPS, CKPT_EVERY, CKPT_FAIL = "granite-3-8b", 6, 3, 4


def _trainer(mesh, path: str, **kw) -> Trainer:
    cfg = get_config(CKPT_ARCH).smoke_config()
    return Trainer(cfg, ShapeSpec("ck", SEQ, BATCH, "train"), mesh,
                   TrainerConfig(total_steps=CKPT_STEPS,
                                 ckpt_every=CKPT_EVERY, log_every=0,
                                 ckpt_dir=path, **kw))


def ckpt_cases(_serve_mesh, tmp: str) -> dict:
    """A model = 2 Trainer ('tp') run whole, and preempted at step 4 and
    resumed from its step-3 checkpoint; then its final checkpoint (whole
    leaves) restored at model = 2 and gathered back whole."""
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    full_dir = os.path.join(tmp, "full")
    _, _, full = _trainer(mesh, full_dir).run(resume=False)
    try:
        _trainer(mesh, os.path.join(tmp, "resumed"),
                 fail_at_step=CKPT_FAIL).run(resume=False)
        preempted = False
    except RuntimeError:
        preempted = True
    _, _, resumed = _trainer(mesh, os.path.join(tmp, "resumed")).run(
        resume=True)
    t2 = _trainer(mesh, full_dir)
    params, opt, step0 = t2.restore_or_init()
    out = {"full": full, "resumed": resumed, "preempted": preempted,
           "restored_step": step0,
           "whole": _np(t2.step_fn.gather_params(params)),
           "opt_whole": {k: _np(v) for k, v in t2.step_fn.gather_opt_state(
               opt).items() if k != "step"}}
    return out


def ckpt_one(_serve_mesh, tmp: str) -> dict:
    """The model = 2 run's final checkpoint restored by a model = 1
    Trainer: its whole leaves."""
    mesh = make_host_mesh(model=1, device="cpu")
    t = _trainer(mesh, os.path.join(tmp, "full"))
    params, opt, step0 = t.restore_or_init()
    return {"restored_step": step0, "whole": _np(params),
            "opt_whole": {k: _np(v) for k, v in opt.items() if k != "step"}}


# -- against the JAX package's step (test_torch_train_tp_ref.py) --------------

REF_ARCH = "granite-3-8b"


def ref_cases(_serve_mesh, params: dict, strategies: tuple,
              case: str = REF_ARCH) -> dict:
    """One step of each strategy at (data=1, model=2) from the whole
    float32 ``params`` (numpy, the reference's init) of ``case`` on the
    seed-1 batch 0 (with ``aux_inputs``' stub inputs): the metrics and the
    updated whole parameters."""
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    cfg = config(case)
    out = {}
    for strategy in strategies:
        step = build_train_step(cfg, mesh, ShapeSpec("r", SEQ, BATCH,
                                                     "train"),
                                TrainStepConfig(strategy=strategy,
                                                moe_groups=MOE_GROUPS))
        p = step.shard_params({k: torch.from_numpy(v.copy())
                               for k, v in params.items()})
        opt = step.init_opt_state(p)
        tok, lab = SyntheticLMData(cfg.vocab, SEQ, BATCH,
                                   seed=1).global_arrays(0, mesh,
                                                         step.batch_axes)
        new_p, _, m = step(p, opt, tok, lab, aux_inputs(cfg))
        out[strategy] = {"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "params": _np(step.gather_params(new_p))}
    return out
