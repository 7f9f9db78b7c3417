"""Optimizers and learning-rate schedules (mirrors ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState, adamw, clip_by_global_norm, global_norm, init_opt_state,
    opt_update, sgd, sgd_momentum)
from repro_torch.optim.schedules import cosine_warmup  # noqa: F401
