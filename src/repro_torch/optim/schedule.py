"""LR schedule (counterpart of ``repro.optim.schedule``), in float32."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr`` then cosine decay to ``min_ratio``;
    returns a float32 0-d CPU tensor."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
