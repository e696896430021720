"""LR schedules: pure functions of the step counter (a tensor), computed on
its device in float32 as the reference's ``optim/schedules.py`` does."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def cosine_schedule(step, total_steps: int, final_frac: float = 0.1):
    t = torch.clamp(step.to(torch.float32) / max(total_steps, 1), 0.0, 1.0)
    return final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    return warm * cosine_schedule(torch.clamp(s - warmup, min=0.0),
                                  max(total_steps - warmup, 1), final_frac)
