"""Optimizers, LR schedules and gradient compression, as in the JAX
package's ``repro.optim``."""

from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedule import make_schedule

__all__ = ["adamw_init", "adamw_update", "make_schedule"]
