"""Self-contained optimizers + schedules (no ``torch.optim``)."""
from .optimizers import OptState, adamw, sgd_momentum, clip_by_global_norm, apply_updates
from .schedules import constant, cosine_with_warmup, linear_warmup

__all__ = [
    "OptState",
    "adamw",
    "sgd_momentum",
    "clip_by_global_norm",
    "apply_updates",
    "constant",
    "cosine_with_warmup",
    "linear_warmup",
]
