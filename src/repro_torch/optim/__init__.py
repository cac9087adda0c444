"""Optimizers and learning-rate schedules (counterpart of the reference
package's ``optim``)."""

from .optimizers import (
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    sgdm_init,
    sgdm_update,
)
from .schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "sgdm_init", "sgdm_update",
           "cosine_schedule", "linear_warmup_cosine"]
