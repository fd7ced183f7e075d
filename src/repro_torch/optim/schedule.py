"""Learning-rate schedules (warmup + cosine or linear decay) — port of
``repro.optim.schedule``.  Each schedule maps a step (an int or an integer
tensor) to the rate as a 0-d f32 tensor on the step's device, computed in
f32 in the JAX package's order of operations."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "warmup_linear"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def _progress(step, warmup_steps: int, total_steps: int):
    """(the step in f32, the share of the decay done, in [0, 1])."""
    step = _f32(step)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    return step, prog


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac`` of it at ``total_steps``."""
    def fn(step):
        step, prog = _progress(step, warmup_steps, total_steps)
        warm = peak_lr * step / max(warmup_steps, 1)
        cos = peak_lr * (final_frac + (1 - final_frac) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a linear
    decay to 0 at ``total_steps``."""
    def fn(step):
        step, prog = _progress(step, warmup_steps, total_steps)
        warm = peak_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, peak_lr * (1 - prog))
    return fn
