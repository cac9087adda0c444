"""Learning-rate schedules: functions of a step tensor that return a 0-d
f32 tensor on the step's device (counterpart of the reference package's
``optim/schedules.py``), so that the trainer never reads the step on the
host."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, base_lr, total_steps, final_frac=0.1):
    """``base_lr`` decayed along a half cosine from 1 to ``final_frac``
    over ``total_steps`` (an int or a tensor), flat after it."""
    t = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return base_lr * (final_frac + (1 - final_frac) * cos)


def linear_warmup_cosine(step, *, base_lr, warmup_steps, total_steps,
                         final_frac=0.1):
    """A linear ramp from 0 to ``base_lr`` over ``warmup_steps``, then
    :func:`cosine_schedule` over the remaining steps."""
    s = step.to(torch.float32)
    warm = base_lr * s / max(warmup_steps, 1)
    after = cosine_schedule(step - warmup_steps, base_lr=base_lr,
                            total_steps=max(total_steps - warmup_steps, 1),
                            final_frac=final_frac)
    return torch.where(s < warmup_steps, warm, after)
