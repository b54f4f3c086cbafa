"""Fine-tuning with part of the model frozen (port of ``multimodal_tpu/train/run.py``:
``_finetune_mask`` as ``finetune_mask``, ``_freeze_mask`` as ``lock_mask`` and
``freeze_optimizer``).

The reference runs its optimizer under ``optax.masked`` on the trainable leaves and zeroes
the rest. The torch form: the frozen parameters get ``requires_grad_(False)`` (no gradient
is formed for them), and the fused AdamW is built over the trainable named parameters
alone, so its global-norm clip, its non-finite skip and the reported grad norm see only
their gradients, no moments are allocated for the frozen ones, and weight decay follows
``wd_mask`` over the trainable leaves (the adapters, ndim 2, decay).
"""

from __future__ import annotations

import re
from typing import Iterable

import torch

from multimodal_tpu_torch.train.optimizer import make_optimizer

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


def lock_mask(named_params: Iterable[tuple[str, torch.Tensor]], lock_image: bool,
              lock_text: bool, unlocked_image_groups: int = 0, unlocked_text_layers: int = 0,
              freeze_layer_norm: bool = False) -> dict[str, bool]:
    """name -> trainable for locked towers (``--lock-image`` / ``--lock-text``), as the
    reference's ``_freeze_mask`` decides it by name: a locked tower's parameters are frozen
    but for its last ``unlocked_image_groups`` / ``unlocked_text_layers`` blocks and, when
    some are unlocked, the parameters outside the blocks named ``ln_post``, ``ln_final`` or
    ``projection``; ``freeze_layer_norm`` keeps ``ln_1`` / ``ln_2`` frozen inside the
    unlocked blocks. A parameter is the image tower's when its name holds ``visual``, the
    text tower's when it holds ``text`` (not ``logit``), so ``ln_post``, ``ln_final`` and the
    logit scale belong to neither and stay trainable."""
    names = [name for name, _ in named_params]

    def tower_depth(tag: str) -> int:
        idxs = [int(m.group(1)) for n in names if tag in n
                for m in re.finditer(r"resblocks\.(\d+)", n)]
        return max(idxs) + 1 if idxs else 0

    depth = {"visual": tower_depth("visual"), "text": tower_depth("text")}

    def unlocked(name: str, tag: str, n_unlocked: int) -> bool:
        if n_unlocked <= 0:
            return False
        m = re.search(r"resblocks\.(\d+)", name)
        if m is not None:
            in_tail = int(m.group(1)) >= depth[tag] - n_unlocked
            if in_tail and freeze_layer_norm and ("ln_1" in name or "ln_2" in name):
                return False
            return in_tail
        return any(t in name for t in ("ln_post", "ln_final", "projection"))

    def keep(name: str) -> bool:
        if lock_image and "visual" in name:
            return unlocked(name, "visual", unlocked_image_groups)
        if lock_text and "text" in name and "logit" not in name:
            return unlocked(name, "text", unlocked_text_layers)
        return True

    return {name: keep(name) for name in names}


def freeze_optimizer(model: torch.nn.Module, mask: dict[str, bool], schedule,
                     **optimizer_kwargs) -> torch.optim.Optimizer:
    """Freeze every parameter of ``model`` that ``mask`` marks False (``requires_grad_``) and
    return ``make_optimizer`` (``optimizer_kwargs`` as there) over the trainable ones only.
    ``mask`` must name every parameter."""
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
