"""Training on one device: the fused AdamW, the LR schedules and the train step."""

from multimodal_tpu_torch.train.engine import TrainState, make_loss_fn, make_train_step
from multimodal_tpu_torch.train.optimizer import FusedAdamW, make_optimizer, wd_mask
from multimodal_tpu_torch.train.schedules import make_schedule

__all__ = ["FusedAdamW", "TrainState", "make_loss_fn", "make_optimizer", "make_schedule",
           "make_train_step", "wd_mask"]
