"""The LM train step over a mesh (the port of the JAX package's
``launch/steps.py::build_train_step``), explicit SPMD over
``torch.distributed``: every rank runs the same step on its rows of the
global batch.

One step, on each rank:
  1. loss and gradients of its rows, microbatch by microbatch (bf16
     gradients accumulated in float32, divided by the microbatch count);
  2. gradient fusion: exact (an all-reduce) over "data", and over "pod"
     too unless ``compression_bits`` is set; then the paper's lossy
     compressed sum over "pod" (``core/compression.py::compressed_psum``,
     its two phases on the block quantizer K4a, K4b's summing form and
     K4b on the card), leaf by leaf in sorted order, divided by the pods,
     with each leaf's noise account summed into ``quant_noise``; the loss
     is averaged the same way, exactly;
  3. AdamW (``optim/adamw.py``) with ZeRO-1 (``zero1``): each rank of the
     data axes keeps only its slice of master, m and v along the dimension
     ``opt_state_specs`` chooses, the global gradient norm comes from one
     all-reduce of the slices' sums of squares, and the new bf16 slices are
     all-gathered into every rank's parameters.
Nothing in the step reads a value on the host.

A step is functional by default (new parameters and state); with
``donate=True`` it updates the ones it was given in place
(``adamw_update_``), the counterpart of the reference Trainer's donated
buffers: at rwkv6-3b the functional step would hold two copies of the
37 GB float32 state. A donated step whose loss or gradient norm is not
finite leaves every tensor as it was.

Every family trains (``model_api.train_forward``); MoE layers cut a
microbatch's tokens into ``moe_groups`` groups, and the stub inputs
(``aux``: whisper's ``frames``, qwen2-vl's ``vision_embeds``, (global
batch, ...) each) are cut into this rank's rows and the microbatches as the
tokens are.

Parameters are the flat dict of the schema's paths (stacked layers on a
leading axis), bf16, whole on every rank. The "model" axis (tensor
parallelism) and the 'tp_sp' / 'fsdp' strategies are not ported (ROADMAP
Queue 1 item 8(h)); nor is ``build_serve_step`` (item 8(i)): serving runs
through ``launch/serve.py``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..core.collectives import all_gather, psum
from ..core.compression import QuantConfig, compressed_psum
from ..data.pipeline import batch_rows
from ..models.layers import init_from_schema
from ..models.model_api import chunked_xent_loss, schema_for, train_forward
from ..optim import (AdamWConfig, adamw_init, adamw_update, adamw_update_,
                     opt_state_specs, zero_dims)
from ..sharding import make_rules
from .mesh import DATA_AXES

__all__ = ["TrainStepConfig", "TrainStep", "build_train_step", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    compression_bits: int | None = None   # None = exact fusion over pod
    remat: bool = True
    zero1: bool = True
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    moe_groups: int = 16
    strategy: str = "tp"                  # only 'tp' (no "model" axis) here


def loss_fn(params: dict, tokens, labels, cfg: ModelConfig,
            remat: bool = True, n_groups: int = 16, aux: dict | None = None):
    """Mean next-token cross-entropy of the flat ``params`` on (tokens,
    labels) (B, S), with the stub inputs ``aux`` of those rows."""
    hidden = train_forward(params, tokens, cfg, remat, n_groups,
                           **(aux or {}))
    return chunked_xent_loss(params, hidden, labels, cfg)


def _value_and_grad(params: dict, tokens, labels, cfg, tcfg, aux: dict):
    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    loss = loss_fn(dict(zip(keys, leaves)), tokens, labels, cfg, tcfg.remat,
                   tcfg.moe_groups, aux)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(keys, grads))


def _mean_over(x, mesh):
    """The exact mean of ``x`` over ``mesh`` (itself on a mesh of one)."""
    return x if mesh.size == 1 else psum(x, mesh) / mesh.size


class TrainStep:
    """The train step of ``cfg`` on ``mesh`` (``launch/mesh.py::GridMesh``):
    ``step(params, opt_state, tokens, labels, aux=None, donate=False)`` ->
    (new params, new opt_state, metrics), with ``tokens``/``labels`` this
    rank's rows (``data.batch_rows``) on its device, ``aux`` the stub
    inputs of the global batch (this rank's rows are taken here) and
    ``opt_state`` this rank's ZeRO-1 slices (``init_opt_state`` /
    ``shard_opt_state``). With ``donate`` the given params and opt_state
    are updated in place and returned. Metrics are 0-dim float32 tensors:
    ``loss``, ``grad_norm``, ``clip``, ``quant_noise``."""

    def __init__(self, cfg: ModelConfig, mesh, shape: ShapeSpec,
                 tcfg: TrainStepConfig = TrainStepConfig()):
        if mesh.shape.get("model", 1) > 1 or tcfg.strategy != "tp":
            raise NotImplementedError(
                f"model={mesh.shape.get('model', 1)}, strategy="
                f"{tcfg.strategy!r}: tensor parallelism and the 'tp_sp' / "
                "'fsdp' strategies are not ported (ROADMAP.md Queue 1 item "
                "8(h)); use a mesh with model=1 and strategy='tp'")
        if tcfg.compression_bits not in (None, 8, 4):
            raise ValueError(f"compression_bits={tcfg.compression_bits}: "
                             "None, 8 or 4")
        self.cfg, self.mesh, self.shape, self.tcfg = cfg, mesh, shape, tcfg
        self.schema = schema_for(cfg)
        self.param_shapes = {k: ps.shape for k, ps in self.schema.items()}
        rules = make_rules(cfg, mesh.shape, "train", strategy=tcfg.strategy)
        specs = opt_state_specs({k: ps.axes for k, ps in self.schema.items()},
                                mesh.shape, self.param_shapes, rules,
                                tcfg.zero1)
        self.zero_dims = zero_dims(specs)
        self.data_axes = tuple(a for a in DATA_AXES if a in mesh.shape)
        self.zmesh = mesh.axes(self.data_axes) if self.data_axes else None
        self.compressed = ("pod" in mesh.shape
                           and tcfg.compression_bits is not None)
        lo, hi = batch_rows(shape.global_batch, mesh)
        self.row0, self.rows = lo, hi - lo
        if self.rows % tcfg.microbatches:
            raise ValueError(f"{self.rows} rows a rank do not split into "
                             f"{tcfg.microbatches} microbatches")

    # -- state ---------------------------------------------------------------

    def init_params(self, seed: int = 0) -> dict:
        """A random init of the schema from a ``torch.Generator`` seeded
        with ``seed`` on the mesh's device: the same on every rank."""
        gen = torch.Generator(device=self.mesh.device).manual_seed(seed)
        return init_from_schema(self.schema, gen, self.mesh.device)

    def _slice(self, k: str, t):
        d, n = self.zero_dims[k], self._zsize()
        if d is None or n == 1:
            return t
        w = t.shape[d] // n
        return t.narrow(d, self.zmesh.rank * w, w)

    def _zsize(self) -> int:
        return 1 if self.zmesh is None else self.zmesh.size

    def shard_opt_state(self, full: dict) -> dict:
        """This rank's ZeRO-1 slices of a whole optimizer state (slices are
        copies, so the whole state can be freed; whole leaves are
        shared)."""
        sl = lambda tree: {k: (v if self._slice(k, v) is v
                               else self._slice(k, v).clone())
                           for k, v in tree.items()}
        return {"master": sl(full["master"]), "m": sl(full["m"]),
                "v": sl(full["v"]), "step": full["step"].clone()}

    def init_opt_state(self, params: dict) -> dict:
        return self.shard_opt_state(adamw_init(params))

    def _gather(self, k: str, t):
        d = self.zero_dims[k]
        if d is None or self._zsize() == 1:
            return t
        g = all_gather(t.contiguous(), self.zmesh)
        return g.movedim(0, d).flatten(d, d + 1).contiguous()

    def gather_opt_state(self, opt: dict) -> dict:
        """The whole optimizer state from every rank's slices (a collective:
        every rank of the data axes calls it)."""
        gather = lambda tree: {k: self._gather(k, tree[k])
                               for k in sorted(tree)}
        return {"master": gather(opt["master"]), "m": gather(opt["m"]),
                "v": gather(opt["v"]), "step": opt["step"]}

    # -- the step ------------------------------------------------------------

    def _aux_rows(self, aux: dict | None) -> dict:
        """This rank's rows of each stub input (global batch first)."""
        out = {}
        for k, v in (aux or {}).items():
            if v.shape[0] != self.shape.global_batch:
                raise ValueError(f"aux {k!r} {tuple(v.shape)}: need the "
                                 f"global batch ({self.shape.global_batch}) "
                                 "first")
            out[k] = v.narrow(0, self.row0, self.rows)
        return out

    def _grads(self, params, tokens, labels, aux: dict):
        mb, tcfg = self.tcfg.microbatches, self.tcfg
        if tokens.shape[0] != self.rows:
            raise ValueError(f"tokens {tuple(tokens.shape)}: this rank "
                             f"holds {self.rows} rows of the global batch")
        if mb == 1:
            loss, grads = _value_and_grad(params, tokens, labels, self.cfg,
                                          tcfg, aux)
            return loss, {k: g.to(torch.float32) for k, g in grads.items()}
        tok = tokens.reshape(mb, self.rows // mb, -1)
        lab = labels.reshape(mb, self.rows // mb, -1)
        aux_mb = {k: v.reshape(mb, self.rows // mb, *v.shape[1:])
                  for k, v in aux.items()}
        acc, loss_sum = None, None
        for i in range(mb):
            loss, grads = _value_and_grad(params, tok[i], lab[i], self.cfg,
                                          tcfg, {k: v[i] for k, v in
                                                 aux_mb.items()})
            if acc is None:
                acc = {k: g.to(torch.float32) for k, g in grads.items()}
                loss_sum = loss
            else:
                for k, g in grads.items():
                    acc[k].add_(g)
                loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / mb
        for g in acc.values():
            g.mul_(inv)
        return loss_sum * inv, acc

    def _fuse(self, loss, grads):
        mesh, noise = self.mesh, None
        if self.compressed:
            if "data" in mesh.shape:
                data = mesh.axis("data")
                loss = _mean_over(loss, data)
                grads = {k: _mean_over(g, data) for k, g in grads.items()}
            pod = mesh.axis("pod")
            qc = QuantConfig(bits=self.tcfg.compression_bits)
            for k in sorted(grads):
                fused, nv = compressed_psum(grads[k], pod, qc)
                grads[k] = fused.div_(pod.size)
                noise = nv if noise is None else noise + nv
            loss = _mean_over(loss, pod)
        elif self.zmesh is not None:
            loss = _mean_over(loss, self.zmesh)
            grads = {k: _mean_over(g, self.zmesh) for k, g in grads.items()}
        if noise is None:
            noise = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, grads, noise

    def __call__(self, params: dict, opt_state: dict, tokens, labels,
                 aux: dict | None = None, donate: bool = False):
        loss, grads = self._grads(params, tokens, labels,
                                  self._aux_rows(aux))
        with torch.no_grad():
            loss, grads, noise = self._fuse(loss, grads)
            nz = self._zsize()
            g_s = {k: self._slice(k, g) for k, g in grads.items()}
            p_s = {k: self._slice(k, p) for k, p in params.items()}
            norm_sq = None
            if nz > 1:
                # every sharded leaf's slice once; a whole leaf on rank 0 only
                owner = self.zmesh.rank == 0
                norm_sq = torch.stack([
                    g_s[k].square().sum()
                    if self.zero_dims[k] is not None or owner
                    else torch.zeros((), dtype=torch.float32,
                                     device=g_s[k].device)
                    for k in sorted(g_s)])
                norm_sq = psum(norm_sq, self.zmesh)
            if donate:
                metrics = adamw_update_(p_s, g_s, opt_state, self.tcfg.adamw,
                                        norm_sq=norm_sq, loss=loss)
                del grads, g_s
                for k in sorted(p_s):
                    full = self._gather(k, p_s[k])
                    if full is not p_s[k]:
                        params[k].copy_(full)
                    del full
                new_params, new_opt = params, opt_state
            else:
                new_p, new_opt, metrics = adamw_update(
                    p_s, g_s, opt_state, self.tcfg.adamw, norm_sq=norm_sq)
                del grads, g_s
                new_params = {k: self._gather(k, new_p[k])
                              for k in sorted(new_p)}
        metrics = dict(metrics, loss=loss, quant_noise=noise)
        return new_params, new_opt, metrics


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
                     tcfg: TrainStepConfig = TrainStepConfig()) -> TrainStep:
    """The train step of ``cfg`` on ``mesh`` for batches of ``shape``."""
    return TrainStep(cfg, mesh, shape, tcfg)
