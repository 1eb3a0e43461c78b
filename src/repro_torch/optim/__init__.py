from repro_torch.optim.sgd import sgd_init, sgd_update, sgd_update_
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedules import constant, cosine, warmup_cosine

__all__ = [
    "sgd_init", "sgd_update", "sgd_update_",
    "adamw_init", "adamw_update",
    "constant", "cosine", "warmup_cosine",
]
