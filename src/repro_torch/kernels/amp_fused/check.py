"""K1, K2 and K3 held against their plain versions at the shapes a run gives
them: ``captured_inputs`` keeps the arguments the kernels were called with
while a block runs, ``check_captured`` calls each kernel once more on them
and compares it with its plain version on the same inputs."""
from __future__ import annotations

import collections
import contextlib

import torch

from . import amp_fused, col, ops, ref

__all__ = ["captured_inputs", "check_captured"]

_WRAPPERS = ("amp_local_cuda_grid", "col_residual_cuda", "col_inner_cuda")


@contextlib.contextmanager
def captured_inputs():
    """The arguments of the second call of each kernel at each shape (of
    the first where there is no second; copied before the call) while the
    block runs: a solve's first call meets x = 0, its second the first
    estimate. The dispatch's bindings of the wrappers are wrapped; nothing
    is read from the card."""
    seen, calls = {}, collections.Counter()
    wrapped = {name: getattr(ops, name) for name in _WRAPPERS}

    def recorder(name):
        def call(*args):
            key = (name,) + tuple(tuple(a.shape) + (str(a.dtype),)
                                  for a in args if torch.is_tensor(a))
            calls[key] += 1
            if calls[key] <= 2:
                seen[key] = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args)
            return wrapped[name](*args)
        return call

    for name in wrapped:
        setattr(ops, name, recorder(name))
    try:
        yield seen
    finally:
        for name, fn in wrapped.items():
            setattr(ops, name, fn)


def _rel(got, want) -> float:
    """max |got - want| / max |want|; an all-zero ``want`` (K2 on x = 0)
    must be met exactly."""
    if bool(want.abs().max() > 0):
        return float((got - want).abs().max() / want.abs().max())
    return 0.0 if torch.equal(got, want) else float("inf")


def check_captured(seen: dict) -> list:
    """Each call of ``seen`` once more through its kernel against its plain
    version: a row per call with the kernel's launch-count key, the operand
    shapes and each output's relative and largest absolute error. The
    launches made here are counted as any other."""
    rows = []
    for key, args in seen.items():
        name, shapes = key[0], key[1:]
        if name == "amp_local_cuda_grid":
            got = amp_fused.amp_local_cuda_grid(*args)
            want = ref.amp_local_ref_grid(*args)
            parts = ("z", "f", "ss")
            kernel = ("amp_local" if amp_fused.single_read(
                args[0].shape[-1], args[0].dtype) else "amp_local_two_pass")
        elif name == "col_residual_cuda":
            got, want = ((col.col_residual_cuda(*args),),
                         (ref.col_residual_ref(*args),))
            parts, kernel = ("r",), "col_residual"
        else:
            got = col.col_inner_cuda(*args)
            want = ref.col_inner_step_ref(*args)
            parts, kernel = ("x", "c", "z"), "col_inner"
        torch.cuda.synchronize()
        row = {"kernel": kernel, "shapes": [list(s) for s in shapes]}
        for part, g, w in zip(parts, got, want):
            row[f"{part}_rel_err"] = _rel(g, w)
            row[f"{part}_max_abs_err"] = float((g - w).abs().max())
        rows.append(row)
    return rows
