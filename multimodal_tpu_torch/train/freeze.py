"""Fine-tuning with part of the model frozen (port of ``multimodal_tpu/train/run.py``:
``_finetune_mask`` as ``finetune_mask`` and ``freeze_optimizer``).

The reference runs its optimizer under ``optax.masked`` on the trainable leaves and zeroes
the rest. The torch form: the frozen parameters get ``requires_grad_(False)`` (no gradient
is formed for them), and the fused AdamW is built over the trainable named parameters
alone, so its global-norm clip, its non-finite skip and the reported grad norm see only
their gradients, no moments are allocated for the frozen ones, and weight decay follows
``wd_mask`` over the trainable leaves (the adapters, ndim 2, decay).
"""

from __future__ import annotations

from typing import Iterable

import torch

from multimodal_tpu_torch.train.optimizer import FusedAdamW, make_optimizer

# substrings of the trainable parameters' names in each mode
FINETUNE_TAGS = {
    # the output projections and the logit scale (the reference's freeze_for_finetuning)
    "projections": ("projection", "logit_scale"),
    # what a VariationalCLIP adds on a pretrained backbone: mean and variance heads, the
    # concentration tokens and offsets, the final norms, the logit scale (freeze_backbone)
    "heads": ("projection", "logit_scale", "log_concentration", "extra_embedding", "ln_post",
              "ln_final"),
    # the LoRA adapter pairs and the logit scale (--lora-rank)
    "lora": ("lora_a", "lora_b", "logit_scale"),
}


def finetune_mask(named_params: Iterable[tuple[str, torch.Tensor]], mode: str) -> dict[str, bool]:
    """name -> trainable, for the freeze ``mode``: "projections", "heads" or "lora"."""
    if mode not in FINETUNE_TAGS:
        raise ValueError(f"unknown freeze mode {mode!r} ({' | '.join(FINETUNE_TAGS)})")
    tags = FINETUNE_TAGS[mode]
    return {name: any(t in name for t in tags) for name, _ in named_params}


def freeze_optimizer(model: torch.nn.Module, mask: dict[str, bool], schedule,
                     **optimizer_kwargs) -> FusedAdamW:
    """Freeze every parameter of ``model`` that ``mask`` marks False (``requires_grad_``) and
    return ``make_optimizer`` (the fused AdamW, ``optimizer_kwargs`` as there) over the
    trainable ones only. ``mask`` must name every parameter."""
    named = dict(model.named_parameters())
    if set(mask) != set(named):
        raise ValueError(f"the mask does not name the model's parameters: missing "
                         f"{sorted(set(named) - set(mask))[:5]}, extra "
                         f"{sorted(set(mask) - set(named))[:5]}")
    if not any(mask.values()):
        raise ValueError("the mask leaves no parameter trainable")
    for name, p in named.items():
        p.requires_grad_(bool(mask[name]))
    return make_optimizer(((n, p) for n, p in named.items() if mask[n]), schedule,
                          **optimizer_kwargs)
