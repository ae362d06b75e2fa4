"""Learning-rate schedules (functions of the step), as the reference's
``repro/optim/schedule.py``; float32 arithmetic on the host."""
from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to `floor` of the peak. Returns the
    LR *scale* in [0, 1] as a 0-d float32 tensor: multiply by the
    optimizer's peak lr."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return warm * cos
