"""Learning-rate schedules (mirrors ``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def _recip(n: int) -> torch.Tensor:
    return 1.0 / torch.tensor(float(n), dtype=torch.float32)


def cosine_warmup(step, *, base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine decay to
    ``min_ratio * base_lr`` at ``total_steps``. ``step`` is an integer
    tensor (or a number); the arithmetic runs in float32, as in the
    reference, and the result is a 0-d float32 tensor on step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    # the divisors are constants, which the compiled reference multiplies
    # by their float32 reciprocals: so does this
    warm = base_lr * torch.clamp_max(
        (step + 1) * _recip(max(warmup_steps, 1)), 1.0)
    frac = torch.clamp((step - warmup_steps)
                       * _recip(max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, base_lr * cos)
