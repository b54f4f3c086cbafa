"""Training on one device: the fused AdamW, the LR schedules, the train step and the freeze
modes of a fine-tune."""

from multimodal_tpu_torch.train.engine import TrainState, make_loss_fn, make_train_step
from multimodal_tpu_torch.train.freeze import finetune_mask, freeze_optimizer
from multimodal_tpu_torch.train.optimizer import FusedAdamW, make_optimizer, wd_mask
from multimodal_tpu_torch.train.schedules import make_schedule

__all__ = ["FusedAdamW", "TrainState", "finetune_mask", "freeze_optimizer", "make_loss_fn",
           "make_optimizer", "make_schedule", "make_train_step", "wd_mask"]
