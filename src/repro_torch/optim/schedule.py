"""Learning-rate schedules: pure functions of the step, in float32 as the
reference computes them (torch counterpart of repro/optim/schedule.py).
``step`` is an int or a tensor; the value is a float32 0-d tensor (on the
step's device when it is a tensor)."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, total_steps: int, min_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
    return min_frac + (1.0 - min_frac) * 0.5 * (1.0 + torch.cos(math.pi * t))


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         min_frac: float = 0.1) -> torch.Tensor:
    warm = torch.clamp(_f32(step) / max(warmup, 1), max=1.0)
    return warm * cosine_schedule(step, total_steps, min_frac)
