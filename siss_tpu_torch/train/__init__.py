from siss_tpu_torch.train.ema import EMAState, ema_decay, ema_update
from siss_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from siss_tpu_torch.train.state import TrainState
from siss_tpu_torch.train.step import (
    DeletionStepConfig,
    build_deletion_train_step,
    clip_by_global_norm,
    global_norm,
    unet_eps_apply,
)

__all__ = [
    "EMAState",
    "ema_decay",
    "ema_update",
    "build_lr_schedule",
    "build_optimizer",
    "TrainState",
    "DeletionStepConfig",
    "build_deletion_train_step",
    "clip_by_global_norm",
    "global_norm",
    "unet_eps_apply",
]
