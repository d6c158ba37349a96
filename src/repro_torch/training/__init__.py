"""Training substrate: optimizer, train steps (even/uneven), compression."""

from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state, lr_at
from .train_step import (
    make_train_step,
    microbatch_grads,
    local_accum,
    weighted_combine,
    uneven_data_parallel_step,
)
from . import grad_compress

__all__ = [
    "AdamWConfig", "OptState", "adamw_update", "init_opt_state", "lr_at",
    "make_train_step", "microbatch_grads", "local_accum",
    "weighted_combine", "uneven_data_parallel_step", "grad_compress",
]
