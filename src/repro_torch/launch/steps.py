"""The LM train step over a mesh (the port of the JAX package's
``launch/steps.py::build_train_step``), explicit SPMD over
``torch.distributed``: every rank runs the same step on its rows of the
global batch.

One step, on each rank:
  1. loss and gradients of its rows, microbatch by microbatch (bf16
     gradients accumulated in float32, divided by the microbatch count),
     on its "model" slices where the mesh has a "model" axis;
  2. gradient fusion: under 'fsdp' the whole leaves' gradients summed
     over "model"; exact (an all-reduce) over "data", and over "pod"
     too unless ``compression_bits`` is set; then the paper's lossy
     compressed sum over "pod" (``core/compression.py::compressed_psum``,
     its two phases on the block quantizer K4a, K4b's summing form and
     K4b on the card), leaf by leaf in sorted order, divided by the pods,
     with each leaf's noise account summed into ``quant_noise``; the loss
     is averaged the same way, exactly;
  3. AdamW (``optim/adamw.py``) with ZeRO-1 (``zero1``): each rank of the
     rules' "zero" axes keeps only its slice of master, m and v along the
     dimension ``opt_state_specs`` chooses, the global gradient norm comes
     from one all-reduce of the sums of squares of every distinct piece
     (each "model" slice once, each whole leaf once: the model = 1 clip),
     and the new bf16 slices are all-gathered into every rank's
     parameters.
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
leading axis), bf16. A "model" axis of m > 1 ranks is tensor parallelism
(``tensor_parallel.py``) for every family, under the reference's three
strategies (``sharding.make_rules``):
  * 'tp': each rank holds the "model" slices the rules give (heads, mlp
    columns, experts, vocab rows; ``sharding.model_dims``) and the same
    rows of the batch as the other "model" ranks of its data coordinate;
  * 'tp_sp': the same slices, the residual between blocks the rank's rows
    of the sequence;
  * 'fsdp': every weight whole but the vocab-parallel embedding and head,
    the batch split over every axis, ZeRO-1 over the whole mesh; the
    gradients of the whole leaves are summed over "model" before the
    fusion.
Gradients of "model"-sliced leaves are the rank's own; ZeRO-1 slices the
rank's slice along a dimension the "model" axis leaves whole, over the
rules' "zero" axes (the reference's ``_rules_with_zero``). Where the heads
do not divide the axis the rules slice the head_dim, and so do the
parameters here. MoE with whole experts (neither "experts" nor
"expert_mlp" divides "model") runs on every rank's whole token set under
'tp_sp', as the reference's does (``transformer.moe_whole_tp``); nothing
is replicated where the rules slice.

``build_serve_step`` (``ServeStep``) is the LM serving step over the same
meshes: prefill under the 'tp' rules (the logits of the last 64 positions,
this rank's vocab columns, and the caches of its K/V heads), or one decode
step under the decode rules, whose cache is sharded along its sequence
over "kv_seq" ("model", or the data axes and "model" where the batch
cannot take the data axes): see ``models/transformer.py`` and
``tensor_parallel.fold_attention``. With it go the rank's slices
(``specs``, ``local_shapes``) and the global shapes (``abstract``), the
counterparts of the reference's ``(fn, shardings, abstract)``, and
``to_decode_state``, which places a prefill's caches into the decode
step's layout (what the reference's ``jax.jit(in_shardings=)`` does when
prefill's caches feed decode). Every family serves on a "model" axis;
rwkv6's ``wkv`` and rglru's recurrent states are held as the rules hold
them and cut to the heads, value columns or LRU columns a rank computes
on for the step (``_held_to_compute``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..core.collectives import all_gather, psum
from ..core.compression import QuantConfig, compressed_psum
from ..data.pipeline import batch_rows
from ..models.layers import init_from_schema
from ..models import rglru, rwkv6, transformer, whisper
from ..models.model_api import (aux_abstract, chunked_xent_loss, schema_for,
                                serve_decode_step, serve_forward,
                                serve_logits, train_forward)
from ..optim import (AdamWConfig, adamw_init, adamw_update, adamw_update_,
                     opt_state_specs, zero_dims)
from ..sharding import (flat_tree, gather_params, local_shape, local_slice,
                        logical_spec, make_rules, model_dims, nest_tree,
                        shard_params, state_specs)
from ..tensor_parallel import (STRATEGIES, KVSlice, TensorParallel,
                               gather_dim, greedy_ids)
from .mesh import DATA_AXES

__all__ = ["TrainStepConfig", "TrainStep", "build_train_step", "loss_fn",
           "ServeStep", "build_serve_step", "PREFILL_LOGITS"]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    compression_bits: int | None = None   # None = exact fusion over pod
    remat: bool = True
    zero1: bool = True
    adamw: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    moe_groups: int = 16
    strategy: str = "tp"                  # 'tp' | 'tp_sp' | 'fsdp' (make_rules)


def loss_fn(params: dict, tokens, labels, cfg: ModelConfig,
            remat: bool = True, n_groups: int = 16, aux: dict | None = None,
            tp: TensorParallel | None = None):
    """Mean next-token cross-entropy of the flat ``params`` on (tokens,
    labels) (B, S), with the stub inputs ``aux`` of those rows; ``tp``: the
    "model" axis, ``params`` this rank's slices (under 'fsdp' the mean over
    the "model" group's rows)."""
    hidden = train_forward(params, tokens, cfg, remat, n_groups, tp,
                           **(aux or {}))
    return chunked_xent_loss(params, hidden, labels, cfg, tp=tp)


def _value_and_grad(params: dict, tokens, labels, cfg, tcfg, aux: dict,
                    tp=None):
    keys = sorted(params)
    leaves = [params[k].detach().requires_grad_(True) for k in keys]
    loss = loss_fn(dict(zip(keys, leaves)), tokens, labels, cfg, tcfg.remat,
                   tcfg.moe_groups, aux, tp)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(keys, grads))


def layer_leaves(cfg: ModelConfig) -> list[str]:
    """The leaves the "model" axis must slice for the family's layers to
    run on it: the attention's or the WKV's heads (or head_dim), rwkv6's
    channel-mix width, recurrentgemma's LRU width."""
    return {"rwkv6": ["layers/wr", "layers/cmix_wk"],
            "rglru": ["macro/attn/wq", "macro/rec0/w_in"],
            "whisper": ["dec/self/wq"]}.get(cfg.family, ["layers/wq"])


def _need_sliced(cfg, dims: dict, need: list, m: int) -> None:
    for k in need:
        if dims[k] is None:
            raise ValueError(f"{cfg.name}: {k} whole on a 'model' axis of "
                             f"{m}: the rules slice none of its dims there")


def _mean_over(x, mesh):
    """The exact mean of ``x`` over ``mesh`` (itself on a mesh of one)."""
    return x if mesh.size == 1 else psum(x, mesh) / mesh.size


class TrainStep:
    """The train step of ``cfg`` on ``mesh`` (``launch/mesh.py::GridMesh``):
    ``step(params, opt_state, tokens, labels, aux=None, donate=False)`` ->
    (new params, new opt_state, metrics), with ``params`` this rank's
    "model" slices (``init_params`` / ``shard_params``; whole leaves on a
    "model" axis of one), ``tokens``/``labels`` this rank's rows
    (``data.batch_rows`` over ``batch_axes``) on its device, ``aux`` the
    stub inputs of the global batch (this rank's rows are taken here) and
    ``opt_state`` this rank's ZeRO-1 slices of its "model" slices
    (``init_opt_state`` / ``shard_opt_state``). With ``donate`` the given
    params and opt_state are updated in place and returned. Metrics are
    0-dim float32 tensors: ``loss``, ``grad_norm``, ``clip``,
    ``quant_noise``; every one is the model = 1 step's, up to float32
    summation order."""

    def __init__(self, cfg: ModelConfig, mesh, shape: ShapeSpec,
                 tcfg: TrainStepConfig = TrainStepConfig()):
        if tcfg.strategy not in STRATEGIES:
            raise ValueError(f"strategy={tcfg.strategy!r}: one of "
                             f"{STRATEGIES}")
        m = mesh.shape.get("model", 1)
        if tcfg.compression_bits not in (None, 8, 4):
            raise ValueError(f"compression_bits={tcfg.compression_bits}: "
                             "None, 8 or 4")
        self.cfg, self.mesh, self.shape, self.tcfg = cfg, mesh, shape, tcfg
        self.schema = schema_for(cfg)
        self.param_shapes = {k: ps.shape for k, ps in self.schema.items()}
        axes = {k: ps.axes for k, ps in self.schema.items()}
        rules = make_rules(cfg, mesh.shape, "train", strategy=tcfg.strategy)
        fsdp = tcfg.strategy == "fsdp"
        self.data_axes = tuple(a for a in DATA_AXES if a in mesh.shape)
        self.zero_axes = self.data_axes + (("model",) if fsdp and
                                           "model" in mesh.shape else ())
        rules["zero"] = self.zero_axes or None
        self.rules = rules
        self.model_dims = model_dims(axes, self.param_shapes, mesh.shape,
                                     rules)
        if m > 1:
            self._check_model_axis()
        specs = opt_state_specs(axes, mesh.shape, self.param_shapes, rules,
                                tcfg.zero1)
        self.zero_dims = zero_dims(specs, self.param_shapes, mesh.shape,
                                   rules)
        batch = rules["batch"]
        self.batch_axes = tuple(batch) if isinstance(batch, (tuple, list)) \
            else ((batch,) if batch else ())
        lo, hi = batch_rows(shape.global_batch, mesh, self.batch_axes)
        self.row0, self.rows = lo, hi - lo
        if fsdp and m > 1 and self.rows == shape.global_batch:
            raise ValueError(f"'fsdp': a global batch of "
                             f"{shape.global_batch} does not split over "
                             f"{self.batch_axes}")
        if tcfg.strategy == "tp_sp" and m > 1 and shape.seq_len % m:
            raise ValueError(f"'tp_sp': a sequence of {shape.seq_len} does "
                             f"not split over {m} 'model' ranks")
        if self.rows % tcfg.microbatches:
            raise ValueError(f"{self.rows} rows a rank do not split into "
                             f"{tcfg.microbatches} microbatches")
        self.dmesh = mesh.axes(self.data_axes) if self.data_axes else None
        self.zmesh = mesh.axes(self.zero_axes) if self.zero_axes else None
        self.tp = (TensorParallel(mesh.axis("model"), tcfg.strategy,
                                  self.model_dims) if m > 1 else None)
        self.world = mesh.axes(tuple(mesh.shape)) if m > 1 else self.zmesh
        self.compressed = ("pod" in mesh.shape
                           and tcfg.compression_bits is not None)
        self._owner = {k: self._owns(k) for k in self.param_shapes}

    def _check_model_axis(self) -> None:
        """The slices the forward needs under the rules: the vocab rows,
        and (but under 'fsdp') the layers' (``layer_leaves``)."""
        need = ["embed/table"]
        if self.tcfg.strategy != "fsdp":
            need += layer_leaves(self.cfg)
        _need_sliced(self.cfg, self.model_dims, need,
                     self.mesh.shape["model"])

    def _owns(self, k: str) -> bool:
        """Whether this rank's piece of leaf ``k`` counts in the gradient
        norm: pieces are distinct along the axes that slice the leaf
        ("model" if it has a "model" dimension, the "zero" axes if its
        state is ZeRO-sliced) and copies along the others, of which the
        rank at coordinate 0 counts."""
        split = set()
        if self.model_dims[k] is not None:
            split.add("model")
        if self.zero_dims[k] is not None:
            split.update(self.zero_axes)
        return all(self.mesh.coords[a] == 0 for a in self.mesh.shape
                   if a not in split)

    # -- state ---------------------------------------------------------------

    def init_params(self, seed: int = 0) -> dict:
        """A random init of the schema's whole leaves from a
        ``torch.Generator`` seeded with ``seed`` on the mesh's device (the
        same on every rank), and this rank's "model" slices of them."""
        gen = torch.Generator(device=self.mesh.device).manual_seed(seed)
        return self.shard_params(init_from_schema(self.schema, gen,
                                                  self.mesh.device))

    def shard_params(self, full: dict) -> dict:
        """This rank's "model" slices of whole leaves (``sharding.
        shard_params``; whole leaves are shared)."""
        return shard_params(full, self.model_dims, self.mesh)

    def gather_params(self, params: dict) -> dict:
        """The whole leaves from every "model" rank's slices (a collective
        over "model")."""
        return gather_params(params, self.model_dims, self.mesh)

    def _slice(self, k: str, t):
        d, n = self.zero_dims[k], self._zsize()
        if d is None or n == 1:
            return t
        w = t.shape[d] // n
        return t.narrow(d, self.zmesh.rank * w, w)

    def _zsize(self) -> int:
        return 1 if self.zmesh is None else self.zmesh.size

    def _zero_slices(self, state: dict) -> dict:
        sl = lambda tree: {k: (v if self._slice(k, v) is v
                               else self._slice(k, v).clone())
                           for k, v in tree.items()}
        return {"master": sl(state["master"]), "m": sl(state["m"]),
                "v": sl(state["v"]), "step": state["step"].clone()}

    def shard_opt_state(self, full: dict) -> dict:
        """This rank's slices of a whole optimizer state (a checkpoint's):
        its "model" slices, then their ZeRO-1 slices (copies, so the whole
        state can be freed; whole leaves are shared)."""
        cut = lambda tree: self.shard_params(tree)
        return self._zero_slices({"master": cut(full["master"]),
                                  "m": cut(full["m"]), "v": cut(full["v"]),
                                  "step": full["step"]})

    def init_opt_state(self, params: dict) -> dict:
        """The ZeRO-1 slices of AdamW's initial state of this rank's
        ``params``."""
        return self._zero_slices(adamw_init(params))

    def _gather(self, k: str, t):
        d = self.zero_dims[k]
        if d is None or self._zsize() == 1:
            return t
        g = all_gather(t.contiguous(), self.zmesh)
        return g.movedim(0, d).flatten(d, d + 1).contiguous()

    def gather_opt_state(self, opt: dict) -> dict:
        """The whole optimizer state from every rank's slices (a collective:
        every rank calls it)."""
        gather = lambda tree: self.gather_params(
            {k: self._gather(k, tree[k]) for k in sorted(tree)})
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
                                          tcfg, aux, self.tp)
            return loss, {k: g.to(torch.float32) for k, g in grads.items()}
        tok = tokens.reshape(mb, self.rows // mb, -1)
        lab = labels.reshape(mb, self.rows // mb, -1)
        aux_mb = {k: v.reshape(mb, self.rows // mb, *v.shape[1:])
                  for k, v in aux.items()}
        acc, loss_sum = None, None
        for i in range(mb):
            loss, grads = _value_and_grad(params, tok[i], lab[i], self.cfg,
                                          tcfg, {k: v[i] for k, v in
                                                 aux_mb.items()}, self.tp)
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
        if self.tp is not None and self.tp.strategy == "fsdp":
            # the loss is the "model" group's mean: the whole leaves'
            # gradients are each rank's rows' share of it
            grads = {k: (psum(g, self.tp.mesh) if self.model_dims[k] is None
                         else g) for k, g in grads.items()}
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
        elif self.dmesh is not None:
            loss = _mean_over(loss, self.dmesh)
            grads = {k: _mean_over(g, self.dmesh) for k, g in grads.items()}
        if noise is None:
            noise = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, grads, noise

    def __call__(self, params: dict, opt_state: dict, tokens, labels,
                 aux: dict | None = None, donate: bool = False):
        loss, grads = self._grads(params, tokens, labels,
                                  self._aux_rows(aux))
        with torch.no_grad():
            loss, grads, noise = self._fuse(loss, grads)
            g_s = {k: self._slice(k, g) for k, g in grads.items()}
            p_s = {k: self._slice(k, p) for k, p in params.items()}
            norm_sq = None
            if self.world is not None and self.world.size > 1:
                # every distinct piece of a leaf once (``_owns``)
                norm_sq = torch.stack([
                    g_s[k].square().sum() if self._owner[k]
                    else torch.zeros((), dtype=torch.float32,
                                     device=g_s[k].device)
                    for k in sorted(g_s)])
                norm_sq = psum(norm_sq, self.world)
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


# -- serving ------------------------------------------------------------------

PREFILL_LOGITS = 64      # prefill's logits: the last 64 positions


def _axes_of(phys) -> tuple:
    return () if phys is None else (tuple(phys) if isinstance(phys, tuple)
                                    else (phys,))


def _state_abstract(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode state's leaves (flat paths) as meta tensors, the
    reference's ``init_state(cfg, batch, max_len)``."""
    meta = torch.device("meta")
    if cfg.family in ("dense", "moe"):
        st = transformer.init_cache(cfg, batch, max_len, device=meta)
    elif cfg.family == "rwkv6":
        st = rwkv6.rwkv6_init_state(cfg, batch, meta)
    elif cfg.family == "rglru":
        st = rglru.rglru_init_state(cfg, batch, max_len, meta)
    else:
        st = whisper.whisper_init_cache(cfg, batch, max_len, device=meta)
    return flat_tree(st)


class ServeStep:
    """The serving step of ``cfg`` on ``mesh`` (``launch/mesh.py::
    GridMesh``) for ``shape`` (``kind`` "prefill" or "decode"), the port of
    the reference's ``build_serve_step``:

      prefill: ``step(params, tokens, aux=None)`` -> (logits (B_r, 64,
        V/m) float32 of the last 64 positions on this rank's vocab columns,
        caches of its K/V heads (rwkv6: its state, ``wkv`` of its heads));
      decode: ``step(params, tokens, state, pos)`` -> (logits (B_r, 1,
        V/m), the state, updated in place),

    ``params`` this rank's "model" slices (``init_params`` /
    ``shard_params``), ``tokens`` its rows (B_r, S) or (B_r, 1) of the
    global batch (``row0``, ``rows``), ``aux`` the stub inputs of the
    global batch, ``state`` its slices of the decode state
    (``init_state`` / ``to_decode_state``), ``pos`` a Python int.
    ``greedy`` and ``gather_logits`` read the vocab slices of every
    "model" rank. ``specs`` / ``local_shapes`` / ``abstract``: each
    argument's mesh axes per dimension, this rank's shape and the global
    shape and dtype (meta tensors). Nothing reads a value on the host."""

    def __init__(self, cfg: ModelConfig, mesh, shape: ShapeSpec,
                 moe_groups: int = 16):
        if shape.kind not in ("prefill", "decode"):
            raise ValueError(f"shape.kind={shape.kind!r}: 'prefill' or "
                             "'decode'")
        m = mesh.shape.get("model", 1)
        self.cfg, self.mesh, self.shape = cfg, mesh, shape
        self.decode = shape.kind == "decode"
        b, s = shape.global_batch, shape.seq_len
        self.rules = make_rules(cfg, mesh.shape,
                                "decode" if self.decode else "prefill",
                                decode_batch=b if self.decode else None)
        self.schema = schema_for(cfg)
        shapes = {k: ps.shape for k, ps in self.schema.items()}
        axes = {k: ps.axes for k, ps in self.schema.items()}
        self.model_dims = model_dims(axes, shapes, mesh.shape, self.rules)
        if m > 1:
            _need_sliced(cfg, self.model_dims,
                         ["embed/table", *layer_leaves(cfg)], m)
        self.tp = (TensorParallel(mesh.axis("model"), "tp", self.model_dims)
                   if m > 1 else None)
        batch = self.rules["batch"]
        self.batch_axes = _axes_of(batch)
        lo, hi = batch_rows(b, mesh, self.batch_axes)
        self.row0, self.rows = lo, hi - lo
        # MoE token groups: the reference's ``moe_groups`` cut the global
        # batch's tokens, its groups sharded with the batch's rows
        self.rank_groups = max(moe_groups * self.rows // b, 1)
        tok_len = 1 if self.decode else s
        ab = {"params": {k: torch.empty(v, dtype=torch.bfloat16,
                                        device="meta")
                         for k, v in shapes.items()},
              "tokens": torch.empty((b, tok_len), dtype=torch.int32,
                                    device="meta")}
        sp = {"params": {k: logical_spec(axes[k], v, mesh.shape, self.rules)
                         for k, v in shapes.items()},
              "tokens": logical_spec(("batch", "seq"), (b, tok_len),
                                     mesh.shape, self.rules)}
        if self.decode:
            ab["state"] = _state_abstract(cfg, b, s)
            ab["pos"] = torch.empty((), dtype=torch.int32, device="meta")
            sp["state"] = state_specs({k: v.shape for k, v in
                                       ab["state"].items()}, mesh.shape,
                                      self.rules)
            sp["pos"] = ()
        else:
            aux = aux_abstract(cfg, b)
            ab["aux"] = aux
            sp["aux"] = {k: logical_spec(("batch", None, None), v.shape,
                                         mesh.shape, self.rules)
                         for k, v in aux.items()}
        self.abstract, self.specs = ab, sp
        self.local_shapes = {
            group: ({k: local_shape(ab[group][k].shape, sp[group][k],
                                    mesh.shape) for k in ab[group]}
                    if isinstance(ab[group], dict)
                    else local_shape(ab[group].shape, sp[group], mesh.shape))
            for group in ab}
        self.kv = self.kv_cross = None
        if self.decode:
            self.kv = self._kv_slice("wkv" if cfg.family == "rwkv6"
                                     else "k")
            if cfg.family == "whisper":
                self.kv_cross = self._kv_slice("ck")
        self._compute = self._compute_dims() if self.decode else {}

    # -- layout -------------------------------------------------------------

    def _kv_slice(self, key: str) -> KVSlice:
        spec = self.specs["state"][key]
        n = self.abstract["state"][key].shape[2]
        start, rows = local_slice(self.abstract["state"][key].shape, spec,
                                  self.mesh)[2]
        mesh = self._rows_mesh(key)
        return KVSlice(mesh, start, rows if mesh is not None else n)

    def _rows_mesh(self, key: str):
        """The mesh over which a decode-state leaf's third dimension (a
        cache's rows, rwkv6's heads, a conv buffer's steps) is sliced, or
        None."""
        names = _axes_of(self.specs["state"][key][2])
        return (self.mesh.axes(names)
                if names and self.mesh.axes_size(names) > 1 else None)

    def _compute_dims(self) -> dict:
        """The decode-state leaves that a step computes on in another
        layout than the rules hold them in: leaf -> the dimension of which
        each "model" rank computes its block (rwkv6's ``wkv``: its heads,
        or under the head_dim fallback its value columns; rglru's conv
        buffers and h: its LRU columns)."""
        if self.tp is None:
            return {}
        if self.cfg.family == "rwkv6":
            return {"wkv": 4 if self.model_dims["layers/wr"] == 3 else 2}
        if self.cfg.family == "rglru":
            return {k: len(v.shape) - 1 for k, v in
                    self.abstract["state"].items()
                    if k.endswith(("/conv", "/h"))}
        return {}

    def _held_to_compute(self, state: dict) -> dict:
        """The decode state as the rules hold it -> as the step computes on
        it (``_compute_dims``): the leaf's third dimension gathered over
        its rows' mesh, the rank's block of the computed dimension kept."""
        if not self._compute:
            return state
        flat = flat_tree(state)
        for k, dim in self._compute.items():
            rows = self._rows_mesh(k)
            if dim == 2 and rows is not None and rows.axes == ("model",):
                continue                  # held as computed
            t = gather_dim(flat[k], rows, 2)
            w = t.shape[dim] // self.tp.size
            flat[k] = t.narrow(dim, self.tp.rank * w, w).contiguous()
        return nest_tree(flat)

    def _compute_to_held(self, state: dict) -> dict:
        """The inverse of ``_held_to_compute``: every "model" rank's block
        gathered, the rules' slice of the third dimension kept."""
        if not self._compute:
            return state
        flat = flat_tree(state)
        for k, dim in self._compute.items():
            rows = self._rows_mesh(k)
            if dim == 2 and rows is not None and rows.axes == ("model",):
                continue
            t = gather_dim(flat[k], self.tp.mesh, dim)
            a, n = local_slice(self.abstract["state"][k].shape,
                               self.specs["state"][k], self.mesh)[2]
            flat[k] = t.narrow(2, a, n).contiguous()
        return nest_tree(flat)

    # -- parameters and state -------------------------------------------------

    def init_params(self, seed: int = 0) -> dict:
        """A random init of the schema's whole leaves from a
        ``torch.Generator`` seeded with ``seed`` on the mesh's device (the
        same on every rank), and this rank's "model" slices of them."""
        gen = torch.Generator(device=self.mesh.device).manual_seed(seed)
        return self.shard_params(init_from_schema(self.schema, gen,
                                                  self.mesh.device))

    def shard_params(self, full: dict) -> dict:
        return shard_params(full, self.model_dims, self.mesh)

    def init_state(self, dtype=torch.bfloat16) -> dict:
        """This rank's slices of the zero decode state (bf16 leaves in
        ``dtype``: float32 for a float32 model)."""
        out = {}
        for k, t in self.abstract["state"].items():
            dt = dtype if t.dtype == torch.bfloat16 else t.dtype
            out[k] = torch.zeros(self.local_shapes["state"][k], dtype=dt,
                                 device=self.mesh.device)
        return nest_tree(out)

    def gather_caches(self, caches):
        """A prefill step's caches in the world of one's layout: every
        "model" rank's K/V heads or head_dim columns, rwkv6's ``wkv``
        heads or value columns, rglru's LRU columns (a collective where
        "model" slices them; the caches themselves on a mesh of one)."""
        if self.tp is None:
            return caches
        cfg, mesh = self.cfg, self.tp.mesh

        def whole(t, dims: dict):
            for d, n in dims.items():
                if t.shape[d] != n:
                    t = gather_dim(t, mesh, d)
            return t

        kvd = {3: cfg.h_eff if cfg.family == "whisper" else cfg.kv_eff,
               4: cfg.d_head}
        if isinstance(caches, tuple):
            return tuple(whole(t, kvd) for t in caches)
        out = {}
        for k, t in flat_tree(caches).items():
            leaf = k.split("/")[-1]
            dims = (kvd if leaf in ("k", "v", "ck", "cv") else
                    {2: cfg.n_heads, 4: cfg.d_head} if leaf == "wkv" else
                    {t.ndim - 1: cfg.lru_width} if leaf in ("conv", "h")
                    else {})
            out[k] = whole(t, dims)
        return nest_tree(out)

    def to_decode_state(self, caches, dtype=torch.bfloat16) -> dict:
        """The decode state of this step's layout from a prefill step's
        caches on the same mesh (its prompt of P <= seq_len tokens): the
        caches gathered whole over "model" (``gather_caches``), each rank
        keeping the rules' slice of every leaf's third dimension (a K/V
        cache's rows of ``seq_len``, rwkv6's ``wkv`` heads). A collective
        where "model" slices the caches."""
        if not self.decode:
            raise ValueError("to_decode_state: a decode step's")
        whole = self.gather_caches(caches)
        whole = (dict(zip(("k", "v"), whole)) if isinstance(whole, tuple)
                 else flat_tree(whole))
        state = flat_tree(self.init_state(dtype))
        for k, t in whole.items():
            a, n = local_slice(self.abstract["state"][k].shape,
                               self.specs["state"][k], self.mesh)[2]
            e = min(a + n, t.shape[2])
            if a < e:
                state[k][:, :, :e - a] = t[:, :, a:e]
        return nest_tree(state)

    # -- the step --------------------------------------------------------------

    def _aux_rows(self, aux: dict | None) -> dict:
        return {k: v.narrow(0, self.row0, self.rows)
                for k, v in (aux or {}).items()}

    def __call__(self, params: dict, tokens, *args):
        if not self.decode:
            aux = args[0] if args else None
            hidden, caches = serve_forward(params, tokens, self.cfg, self.tp,
                                           self.rank_groups,
                                           **self._aux_rows(aux))
            return serve_logits(params, hidden[:, -PREFILL_LOGITS:]), caches
        state, pos = args
        hidden, state = serve_decode_step(params, tokens,
                                          self._held_to_compute(state),
                                          int(pos), self.cfg, self.tp,
                                          self.kv, self.rank_groups,
                                          self.kv_cross)
        return serve_logits(params, hidden), self._compute_to_held(state)

    def greedy(self, logits):
        """The greedy token of each row over every "model" rank's vocab
        columns (int64): ``torch.argmax`` of the whole row."""
        if self.tp is None:
            return greedy_ids(logits, None, 0)
        return greedy_ids(logits, self.tp.mesh,
                          self.tp.rank * logits.shape[-1])

    def gather_logits(self, logits):
        """The whole vocab's logits from every "model" rank's columns."""
        return gather_dim(logits, None if self.tp is None else self.tp.mesh,
                          logits.ndim - 1)


def build_serve_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
                     moe_groups: int = 16) -> ServeStep:
    """The prefill or decode step (per ``shape.kind``) of ``cfg`` on
    ``mesh``."""
    return ServeStep(cfg, mesh, shape, moe_groups)
