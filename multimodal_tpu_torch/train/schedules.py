"""Step-wise LR schedules: linear warmup + {cosine, const, const-cooldown} (port of
``multimodal_tpu/train/schedules.py``).

Each schedule maps a step (a Python number or a tensor, on any device) to the LR as a
float32 tensor on the step's device, computed in float32 as the JAX versions compute it;
a step tensor on the card keeps the optimizer free of host syncs.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _warmup(base_lr, step, warmup_steps):
    return base_lr * (step + 1) / max(warmup_steps, 1)


def const_lr(base_lr: float, warmup_steps: int):
    def schedule(step):
        step = _step(step)
        return torch.where(step < warmup_steps, _warmup(base_lr, step, warmup_steps),
                           torch.full_like(step, base_lr))

    return schedule


def const_lr_cooldown(base_lr: float, warmup_steps: int, total_steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0):
    """Const after warmup, polynomial decay over the final ``cooldown_steps``."""
    start_cooldown = total_steps - cooldown_steps

    def schedule(step):
        step = _step(step)
        decay_progress = torch.clamp((step - start_cooldown) / max(cooldown_steps, 1),
                                     0.0, 1.0)
        decay = (1.0 - decay_progress) ** cooldown_power
        cooled = decay * (base_lr - cooldown_end_lr) + cooldown_end_lr
        main = torch.where(step < start_cooldown, torch.full_like(step, base_lr), cooled)
        return torch.where(step < warmup_steps, _warmup(base_lr, step, warmup_steps), main)

    return schedule


def cosine_lr(base_lr: float, warmup_steps: int, total_steps: int):
    """Cosine decay to 0 after linear warmup."""

    def schedule(step):
        step = _step(step)
        progress = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        decayed = 0.5 * (1.0 + torch.cos(math.pi * progress)) * base_lr
        return torch.where(step < warmup_steps, _warmup(base_lr, step, warmup_steps), decayed)

    return schedule


def make_schedule(name: str, base_lr: float, warmup_steps: int, total_steps: int,
                  cooldown_steps: int = 0, cooldown_power: float = 1.0,
                  cooldown_end_lr: float = 0.0):
    if name == "cosine":
        return cosine_lr(base_lr, warmup_steps, total_steps)
    if name == "const":
        return const_lr(base_lr, warmup_steps)
    if name == "const-cooldown":
        return const_lr_cooldown(base_lr, warmup_steps, total_steps, cooldown_steps,
                                 cooldown_power, cooldown_end_lr)
    raise ValueError(f"unknown scheduler {name!r}")
