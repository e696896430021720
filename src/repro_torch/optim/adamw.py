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

``adamw_update_`` is the same step in place (the counterpart of the
reference's donated buffers): master, m, v and the parameters are
overwritten piece by piece, with temporaries the size of one piece, and a
step whose loss or gradient norm is not finite leaves every tensor as it
was, bit for bit, through a device flag (no host read).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from ..sharding import AxisRules, logical_spec

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "global_norm_sq", "opt_state_specs", "zero_dims"]

PIECE = 1 << 26      # elements a piece of an in-place update reaches for


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


def _scalars(norm_sq: torch.Tensor, step0: torch.Tensor, cfg: AdamWConfig):
    """The step's 0-dim device scalars: global gradient norm, clip factor,
    new step count and the two bias corrections."""
    gnorm = torch.sqrt(_sum_in_order(norm_sq))
    # a Python number over a tensor is a reciprocal times the number in
    # PyTorch: divide two tensors, as the reference divides
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9),
                       max=1.0)
    step = step0 + 1
    t = step.to(torch.float32)
    return gnorm, clip, step, 1.0 - torch.pow(cfg.b1, t), \
        1.0 - torch.pow(cfg.b2, t)


def _update(g, m0, v0, master0, clip, bc1, bc2, lr, cfg: AdamWConfig):
    """New (m, v, master) of one leaf or piece: the reference's arithmetic,
    element for element."""
    g = g.to(torch.float32) * clip
    m = cfg.b1 * m0 + (1 - cfg.b1) * g
    v = cfg.b2 * v0 + (1 - cfg.b2) * g * g
    upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    return m, v, master0 * (1.0 - lr * cfg.weight_decay) - lr * upd


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
    gnorm, clip, step, bc1, bc2 = _scalars(norm_sq, state["step"], cfg)
    lr = cfg.lr * lr_scale
    new_master, new_m, new_v, new_p = {}, {}, {}, {}
    for k in params:
        m, v, master = _update(grads[k], state["m"][k], state["v"][k],
                               state["master"][k], clip, bc1, bc2, lr, cfg)
        new_master[k], new_m[k], new_v[k] = master, m, v
        new_p[k] = master.to(params[k].dtype)
    new_state = {"master": new_master, "m": new_m, "v": new_v, "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "clip": clip}


def _pieces(n_rows: int, row: int) -> list[tuple[int, int]]:
    """(start, length) runs of ``n_rows`` rows of ``row`` elements, each
    at most ``PIECE`` elements (at least one row)."""
    step = max(PIECE // max(row, 1), 1)
    return [(i, min(step, n_rows - i)) for i in range(0, n_rows, step)]


def adamw_update_(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                  lr_scale: float = 1.0, norm_sq: torch.Tensor | None = None,
                  loss: torch.Tensor | None = None) -> dict:
    """``adamw_update`` in place: ``params`` and ``state`` (master, m, v,
    step) take the new values, the same bits as ``adamw_update``'s.
    Returns the metrics ``{"grad_norm", "clip"}``.

    Unless the gradient norm (and ``loss``, if given) is finite, every
    tensor keeps its bits: each piece's new values pass through
    ``torch.where`` on a 0-dim device flag. A leaf is updated in runs of
    its leading rows of at most ``PIECE`` elements, so the temporaries are
    the size of a piece, not of the largest leaf."""
    if norm_sq is None:
        norm_sq = global_norm_sq(grads)
    gnorm, clip, step, bc1, bc2 = _scalars(norm_sq, state["step"], cfg)
    ok = torch.isfinite(gnorm)
    if loss is not None:
        ok = ok & torch.isfinite(loss)
    lr = cfg.lr * lr_scale
    for k, p in params.items():
        rows = p.shape[0] if p.ndim else 1
        for i0, n in _pieces(rows, p.numel() // max(rows, 1)):
            cut = (lambda x: x.narrow(0, i0, n)) if p.ndim else (lambda x: x)
            old = [cut(x) for x in (state["m"][k], state["v"][k],
                                    state["master"][k])]
            new = _update(cut(grads[k]), *old, clip, bc1, bc2, lr, cfg)
            cut(p).copy_(torch.where(ok, new[2].to(p.dtype), cut(p)))
            for x0, x in zip(old, new):
                x0.copy_(torch.where(ok, x, x0))
    state["step"].copy_(torch.where(ok, step, state["step"]))
    return {"grad_norm": gnorm, "clip": clip}


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
