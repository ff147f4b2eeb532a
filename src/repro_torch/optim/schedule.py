"""Learning-rate schedules (callable: step -> lr), as in the JAX package.

A Python step gives a Python float; a tensor step gives a 0-d float32
tensor on the step's device, so a schedule inside a step loop never
copies a value to the host.
"""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def f(step):
        if isinstance(step, torch.Tensor):
            return torch.full((), lr, dtype=torch.float32,
                              device=step.device)
        return float(lr)
    return f


def cosine_warmup(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.0):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor`` at ``total``."""
    def f(step):
        if isinstance(step, torch.Tensor):
            step = step.to(torch.float32)
            warm = peak_lr * step / max(warmup, 1)
            t = torch.clamp((step - warmup) / max(total - warmup, 1),
                            0.0, 1.0)
            cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(
                math.pi * t))
            return torch.where(step < warmup, warm, cos)
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return floor + (peak_lr - floor) * 0.5 * (1 + math.cos(math.pi * t))
    return f
