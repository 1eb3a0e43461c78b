"""Learning-rate schedules as step -> lr callables (``repro.optim.schedules``).

``step`` is a host number or a tensor; the result is an f32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr):
    return lambda step: _f32(lr)


def cosine(lr, total_steps, final_frac=0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return fn


def warmup_cosine(lr, warmup_steps, total_steps, final_frac=0.1):
    cos = cosine(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return fn
