"""Training: AdamW with float32 master copies, the train step."""
from .optimizer import OptConfig, adamw_update, init_opt_state, lr_schedule
from .train_loop import make_train_state, make_train_step

__all__ = ["OptConfig", "adamw_update", "init_opt_state", "lr_schedule",
           "make_train_state", "make_train_step"]
