"""LR schedules."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """step → lr, a 0-d fp32 tensor (on the CPU): linear warm-up over
    ``warmup`` steps, then a cosine from ``base_lr`` down to
    ``min_frac·base_lr`` at ``total``; the reference's fp32 ops in its
    order."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr
