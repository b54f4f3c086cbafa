"""Optimizer-state host offload: the fused AdamW's moments live in pinned host memory, not
in device memory (port of ``multimodal_tpu/parallel/offload.py``, ``--opt-state-offload``).

Between steps the moments ``mu`` and ``nu`` are pinned host tensors; ``FusedAdamW.step``
copies them to the device for the update and the new moments back, both non-blocking on the
step's stream, so the copies queue behind the backward's kernels and the host never waits.
The card's device memory then holds no moment between steps, which is what lets a model whose
optimizer state prices it out of its best batch train at that batch.

Pinned host memory that the card copies from asynchronously is a CUDA thing: on the CPU this
raises, as the reference raises on a backend without pinned-host memory kinds.
"""

from __future__ import annotations

import torch

from multimodal_tpu_torch.train.optimizer import FusedAdamW


def offload_optimizer_state(optimizer: FusedAdamW) -> FusedAdamW:
    """Move ``optimizer``'s moments into pinned host memory, in place (a no-op when they are
    there already); the optimizer's steps copy them to the device and back."""
    if not isinstance(optimizer, FusedAdamW):
        raise ValueError("optimizer-state offload moves the fused AdamW's moments; "
                         f"{type(optimizer).__name__} keeps its state on the device")
    device = optimizer.count.device
    if device.type != "cuda":
        raise RuntimeError("optimizer-state host offload needs a CUDA device (pinned host "
                           f"memory the card copies from asynchronously); the optimizer is on "
                           f"{device}")
    for p in optimizer._params():
        state = optimizer.state[p]
        for slot in FusedAdamW.SLOTS:
            if state[slot].is_cuda:
                state[slot] = state[slot].to("cpu").pin_memory()
    optimizer.offloaded = True
    torch.cuda.synchronize(device)
    return optimizer
