"""Learning-rate schedules as step -> scale functions (the port of
``repro/optim/schedule.py``; ``step`` a number or a tensor)."""
from __future__ import annotations

import math

import torch


def linear_warmup(step, warmup_steps: int):
    step = torch.as_tensor(step, dtype=torch.float32)
    return torch.clamp((step + 1.0) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1):
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = linear_warmup(step, warmup_steps)
    prog = torch.clamp((step - warmup_steps)
                       / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
