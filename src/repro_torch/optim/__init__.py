"""Optimizer, learning-rate schedules and gradient compression (torch
counterpart of repro/optim)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_init_sharded,
    adamw_update,
    adamw_update_sharded,
    optimizer_specs,
)
from repro_torch.optim.compression import (  # noqa: F401
    ErrorFeedbackState,
    compress_grads_int8,
    decompress_grads_int8,
    ef_init,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine  # noqa: F401
