"""AdamW over flat parameter dicts, with mixed precision and ZeRO-1 (the
port of the JAX package's ``optim/adamw.py``).

Parameters live in bf16; the optimizer keeps float32 master weights and
moments. ``opt_state_specs`` gives each parameter's optimizer state the
logical axis "zero" on its largest dimension that no mesh axis shards and
that the data axes' size divides: under ZeRO-1 each rank of those axes
keeps one slice of master, m and v along it (``zero_dims``), which at 34B
parameters is the difference between 17 GB and ~1 GB of optimizer bytes a
rank. The train step (``launch/steps.py``) updates its slice and
all-gathers the bf16 parameters; ``adamw_update`` itself is the same
arithmetic on whole leaves or on slices, given the global gradient norm.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from ..sharding import AxisRules, logical_spec

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm_sq",
           "opt_state_specs", "zero_dims"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: dict) -> dict:
    """Float32 master copies and zero moments of ``params``, and the step
    (an int32 0-dim tensor on their device)."""
    dev = next(iter(params.values())).device
    f32 = {k: p.detach().to(torch.float32, copy=True)
           for k, p in params.items()}
    return {"master": f32,
            "m": {k: torch.zeros_like(v) for k, v in f32.items()},
            "v": {k: torch.zeros_like(v) for k, v in f32.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm_sq(grads: dict) -> torch.Tensor:
    """The sum of squares of each leaf of ``grads``, in sorted key order
    (the reference's leaf order): float32 (n_leaves,)."""
    return torch.stack([grads[k].to(torch.float32).square().sum()
                        for k in sorted(grads)])


def _sum_in_order(v: torch.Tensor) -> torch.Tensor:
    """v[0] + v[1] + ... left to right, as the reference's Python ``sum``
    over the leaves adds them."""
    total = v[0]
    for x in v[1:]:
        total = total + x
    return total


def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                 lr_scale: float = 1.0, norm_sq: torch.Tensor | None = None):
    """One AdamW step. Returns (new params in each param's dtype, new
    state, metrics ``{"grad_norm", "clip"}``).

    ``norm_sq`` (``global_norm_sq``'s vector, summed over the ranks that
    hold slices) gives the global gradient norm when ``grads`` and the
    state are ZeRO-1 slices; without it the norm is ``grads``' own. The
    clip, bias corrections and update are the reference's, element for
    element; nothing is read on the host."""
    if norm_sq is None:
        norm_sq = global_norm_sq(grads)
    gnorm = torch.sqrt(_sum_in_order(norm_sq))
    # a Python number over a tensor is a reciprocal times the number in
    # PyTorch: divide two tensors, as the reference divides
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9),
                       max=1.0)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr * lr_scale

    new_master, new_m, new_v, new_p = {}, {}, {}, {}
    for k in params:
        g = grads[k].to(torch.float32) * clip
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        master = state["master"][k] * (1.0 - lr * cfg.weight_decay) - lr * upd
        new_master[k], new_m[k], new_v[k] = master, m, v
        new_p[k] = master.to(params[k].dtype)
    new_state = {"master": new_master, "m": new_m, "v": new_v, "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "clip": clip}


def opt_state_specs(param_specs: dict, mesh_shape: Mapping[str, int],
                    param_shapes: dict, rules: AxisRules,
                    zero1: bool = True) -> dict:
    """Logical-axis specs of the optimizer state (ZeRO-1 over the data
    axes "pod" x "data"): each parameter's axes with "zero" on its largest
    dimension that resolves to no mesh axis under ``rules`` and that the
    data axes' size divides (unchanged if there is none, or without
    ``zero1``). A dimension is eligible when its logical name *resolves*
    to no mesh axis, not when it has no logical name."""
    data_size = 1
    for a in ("pod", "data"):
        if a in mesh_shape:
            data_size *= mesh_shape[a]

    def extend(path, axes):
        if not zero1:
            return axes
        shape = param_shapes[path]
        resolved = logical_spec(axes, shape, mesh_shape, rules)
        best, best_dim = None, 0
        for i, dim in enumerate(shape):
            phys = resolved[i] if i < len(resolved) else None
            if phys is None and dim % data_size == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is None:
            return axes
        out = list(axes)
        out[best] = "zero"
        return tuple(out)

    per_param = {k: extend(k, v) for k, v in param_specs.items()}
    return {"master": per_param, "m": per_param, "v": per_param,
            "step": ()}


def zero_dims(specs: dict) -> dict:
    """The ZeRO-1 dimension of each parameter (the index of "zero" in its
    optimizer-state axes), None where its state stays whole."""
    return {k: (axes.index("zero") if "zero" in axes else None)
            for k, axes in specs["master"].items()}
