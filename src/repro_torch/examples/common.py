"""What the example twins share: the device check, the problem draw and
the SDR of an MSE."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.amp import sample_problem
from ..core.engine import EngineConfig
from ..core.state_evolution import CSProblem

__all__ = ["check_device", "draw_problem", "sdr_db", "to_numpy"]


def check_device(device: str) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device where no
    card is available (``EngineConfig.device``'s rule)."""
    return EngineConfig(device=device).torch_device


def to_numpy(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def draw_problem(seed: int, prob: CSProblem, device: str, problem=None):
    """(s0 as numpy, A, y): ``problem`` (arrays or tensors) as given, or a
    draw of ``prob``'s model from ``seed`` on ``device`` (A and y stay
    there)."""
    if problem is not None:
        s0, a, y = problem
        return to_numpy(s0), a, y
    s0, a, y = sample_problem(seed, prob.n, prob.m, prob.prior, prob.sigma_e2,
                              device=device)
    return to_numpy(s0), a, y


def sdr_db(prior, mse: float) -> float:
    """Signal-to-distortion ratio in dB of an MSE against the prior's
    second moment."""
    return 10 * math.log10(prior.second_moment / mse)

