"""LR schedules: mirror of :mod:`repro.optim.schedule`.

A schedule maps the step (an int or an integer tensor) to the rate as a
0-d float32 tensor on the host, in the reference's float32 arithmetic.
"""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor_frac: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).cpu().to(torch.float32)
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup, warm, cos)
    return f
