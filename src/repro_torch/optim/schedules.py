"""Learning-rate schedules: functions of an int step tensor, returning f32.

The counterparts of ``repro.optim.schedules``, with the same arithmetic in
f32 on the step's device.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "linear_warmup", "cosine_with_warmup"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return peak * torch.clamp_max(s / max(warmup_steps, 1), 1.0)

    return fn


def cosine_with_warmup(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def fn(step):
        s = _f32(step)
        warm = peak * torch.clamp_max(s / max(warmup_steps, 1), 1.0)
        frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, cos)

    return fn
