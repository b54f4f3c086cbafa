"""Training, on one device or over a process group: the optimizers, the LR schedules, the
train step, the freeze modes of a fine-tune, the checkpoints, and the CLI (``python -m
multimodal_tpu_torch.train.run``)."""

from multimodal_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_tpu_torch.train.engine import TrainState, make_loss_fn, make_train_step
from multimodal_tpu_torch.train.freeze import finetune_mask, freeze_optimizer, lock_mask
from multimodal_tpu_torch.train.optimizer import (
    ChainOptimizer,
    FusedAdamW,
    make_optimizer,
    wd_mask,
)
from multimodal_tpu_torch.train.schedules import make_schedule

__all__ = ["ChainOptimizer", "CheckpointManager", "FusedAdamW", "TrainState", "finetune_mask",
           "freeze_optimizer", "lock_mask", "make_loss_fn", "make_optimizer", "make_schedule",
           "make_train_step", "wd_mask"]
