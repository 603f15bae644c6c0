"""Learning-rate schedules (callables: step -> float32 0-d tensor), each
evaluated in float32 in the reference's order of operations."""
from __future__ import annotations

import math

import torch


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def constant(lr):
    return lambda step: _f32(lr)


def linear_decay(peak, total_steps, end_frac=0.1):
    def f(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return peak * (1.0 - (1.0 - end_frac) * frac)
    return f


def warmup_cosine(peak, warmup_steps, total_steps, end_frac=0.0):
    def f(step):
        s = _f32(step)
        warm = peak * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = end_frac * peak + (1 - end_frac) * peak \
            * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)
    return f
