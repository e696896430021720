"""State carried across from the JAX package to this one.

What the two packages must share to be compared is, for the solver, the
problem and the controller state and, for the LM models, the parameters
(a random init, no weights are on disk). These functions take the JAX
package's objects **as numpy arrays and plain Python values** — the caller
does the ``np.asarray``; nothing here imports or sees a jax type — and
build this package's objects from them:

    problem_to_torch     (a_mat, y)            -> tensors on a device
    shards_to_torch      pre-split (a_p, y_p)  -> tensors on a device, A in a_dtype
    schedule_from_deltas a Fixed/DP schedule's ``deltas`` (+ rates, sigma2_d)
    col_dp_schedule_from_arrays  a ColDPSchedule's ``deltas``, ``rates``, ``d_traj``
    bt_tables_from_arrays      the 16 arrays of a BTTables tuple -> BTTables
    col_bt_tables_from_arrays  the 14 arrays of a ColBTTables tuple -> ColBTTables
    prior_from_fields / problem_from_fields   dataclasses by their fields
    lm_params_from_arrays  an LM's flat parameter dict -> the module state
"""
from __future__ import annotations

import numpy as np
import torch

from .core.denoisers import BernoulliGauss
from .core.engine import (BTTables, ColBTTables, ColDPSchedule, DPSchedule,
                          EngineConfig, FixedSchedule)
from .core.engine import to_f32 as _f32
from .core.state_evolution import CSProblem
from .models.model_api import state_from_flat

__all__ = ["problem_to_torch", "shards_to_torch", "schedule_from_deltas",
           "col_dp_schedule_from_arrays", "bt_tables_from_arrays",
           "col_bt_tables_from_arrays", "prior_from_fields",
           "problem_from_fields", "lm_params_from_arrays"]


def problem_to_torch(a_mat, y, device="cuda"):
    """(A (M, N), y (M,)) as float32 tensors on ``device``."""
    return _f32(a_mat, device), _f32(y, device)


def shards_to_torch(a_p, y_p, device="cuda", a_dtype: str = "float32"):
    """Pre-split row shards (a_p (P, Mp, N), y_p (P, Mp)) as the engine's
    operands: A stored in ``a_dtype``, y in float32."""
    a_tdtype = EngineConfig(a_dtype=a_dtype).a_tdtype
    return _f32(a_p, device).to(a_tdtype).contiguous(), _f32(y_p, device)


def schedule_from_deltas(deltas, rates=None, sigma2_d=None):
    """A ``FixedSchedule`` from its bin sizes, or a ``DPSchedule`` when the
    DP's ``rates`` and ``sigma2_d`` come along."""
    if rates is None:
        return FixedSchedule(np.asarray(deltas))
    return DPSchedule.from_arrays(np.asarray(deltas), rates, sigma2_d)


def col_dp_schedule_from_arrays(deltas, rates, d_traj) -> ColDPSchedule:
    """A ``ColDPSchedule`` from its bin sizes, the DP's rates and its
    predicted block-MSE trajectory."""
    return ColDPSchedule.from_arrays(np.asarray(deltas), rates, d_traj)


def _tables_from_arrays(cls, fields, device):
    if isinstance(fields, dict):
        fields = [fields[name] for name in cls._fields]
    fields = list(fields)
    assert len(fields) == len(cls._fields), \
        f"need {len(cls._fields)} arrays, got {len(fields)}"
    return cls(*(_f32(v, device) for v in fields))


def bt_tables_from_arrays(fields, device="cpu") -> BTTables:
    """``BTTables`` from the reference tuple's 16 arrays, given in field
    order or as a mapping by field name."""
    return _tables_from_arrays(BTTables, fields, device)


def col_bt_tables_from_arrays(fields, device="cpu") -> ColBTTables:
    """``ColBTTables`` from the reference tuple's 14 arrays, given in field
    order or as a mapping by field name."""
    return _tables_from_arrays(ColBTTables, fields, device)


def prior_from_fields(eps: float, mu_s: float, sigma_s: float) -> BernoulliGauss:
    return BernoulliGauss(float(eps), float(mu_s), float(sigma_s))


def problem_from_fields(n: int, m: int, eps: float, mu_s: float,
                        sigma_s: float, snr_db: float) -> CSProblem:
    return CSProblem(n=int(n), m=int(m),
                     prior=prior_from_fields(eps, mu_s, sigma_s),
                     snr_db=float(snr_db))


def _array_to_torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bf16 included: an array of
    the ``ml_dtypes`` "bfloat16" dtype (what ``np.asarray`` gives of a jax
    bf16 array) is taken by its bits, since ``torch.from_numpy`` rejects
    that dtype — without importing ``ml_dtypes``."""
    a = np.array(a, copy=True, order="C")   # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def lm_params_from_arrays(params: dict, cfg, device="cpu") -> dict:
    """The port's module state of an LM from the reference's flat parameter
    dict (path -> numpy array, per-layer weights stacked on a leading
    ``layers`` axis): give it to ``models.get_model(cfg, device,
    state=...)``. Values and dtypes are kept bit for bit; stacked arrays are
    split per layer."""
    return state_from_flat({path: _array_to_torch(a, device)
                            for path, a in params.items()}, cfg)
