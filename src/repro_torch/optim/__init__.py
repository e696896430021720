"""Optimizer of the LM trainer: AdamW with float32 master weights and
moments over bf16 parameters, its ZeRO-1 layout, and the learning-rate
schedules (the port of the JAX package's ``optim``)."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, adamw_update_,
                    global_norm_sq, opt_state_specs, zero_dims)
from .schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "global_norm_sq",
           "opt_state_specs", "zero_dims", "cosine_schedule",
           "linear_warmup_cosine"]
