from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_reset_,
    adamw_update,
    adamw_update_,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup
from repro_torch.optim.sgd import sgd_init, sgd_update

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_reset_",
    "adamw_update",
    "adamw_update_",
    "sgd_init",
    "sgd_update",
    "cosine_schedule",
    "linear_warmup",
]
