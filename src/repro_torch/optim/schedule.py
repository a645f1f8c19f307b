"""LR schedules as functions of the step counter: the counterpart of
``repro.optim.schedule``.

The arithmetic is float32 on tensors, as the reference's jnp arithmetic on
weak-typed Python numbers is, and a device step counter gives the learning
rate on that device with no read back to the host.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(step, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``final_frac * peak_lr`` at ``total_steps``; a 0-d f32 tensor."""
    step = _f32(step)
    warm = peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * progress))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def constant(step, lr: float) -> torch.Tensor:
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.full((), lr, dtype=torch.float32, device=device)
