"""Optimizers of the port (``repro.optim``): plain functions on dicts of
tensors keyed by parameter name."""
from .optimizers import (
    OptState,
    Optimizer,
    adafactor_apply,
    adafactor_init,
    adafactor_update,
    adamw_apply,
    adamw_init,
    adamw_update,
    apply_updates,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    make_optimizer,
)

__all__ = [
    "OptState",
    "Optimizer",
    "adafactor_apply",
    "adafactor_init",
    "adafactor_update",
    "adamw_apply",
    "adamw_init",
    "adamw_update",
    "apply_updates",
    "clip_by_global_norm",
    "cosine_schedule",
    "global_norm",
    "make_optimizer",
]
