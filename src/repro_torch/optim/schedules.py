"""Learning-rate schedules (pure functions of the step counter), after the
JAX package's ``optim/schedules.py``: each returns a float32 scalar tensor on
the step's device (the CPU for a Python int step), computed in float32 as
the reference computes it."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine", "warmup_cosine", "linear_decay"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=torch.as_tensor(step).device)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = torch.as_tensor(step)
        warm = lr * _f32(step) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn


def linear_decay(lr: float, total_steps: int):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return lr * (1 - t)

    return fn
