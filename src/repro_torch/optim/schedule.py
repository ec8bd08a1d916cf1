"""Learning-rate schedules as functions of the step: an int or an int
tensor (on any device), giving a float32 tensor there; the reference's
``optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_steps(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(peak: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(peak, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = _steps(step)
        w = torch.clamp(s / max(warmup, 1), max=1.0)
        return torch.where(s < warmup, peak * w, cos(s - warmup))
    return fn
