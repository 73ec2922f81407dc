"""Learning-rate schedules (port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1, device=None) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine to ``final_frac`` of it,
    as a float32 0-d tensor on ``device`` (default: ``step``'s, or the CPU).
    Computed in float32 with JAX's order of operations."""
    if device is None and isinstance(step, torch.Tensor):
        device = step.device
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm, cos)
