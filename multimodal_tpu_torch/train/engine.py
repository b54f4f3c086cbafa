"""The training step on one device (port of ``multimodal_tpu/train/engine.py``).

``make_train_step(model, optimizer)`` returns ``step(state, batch) -> metrics``: the forward
of both towers on a uint8 (or already normalized) image batch and its tokens, the CLIP
InfoNCE loss on the normalized features, the backward (on a CUDA tensor the attention half
of every block, and with ``block_mlp`` its MLP half, runs the hand-written forward and
backward kernels), the fused AdamW step
with its global-norm clip and non-finite skip, and the ln(100) clamp of the logit scale.
It is the step the JAX package's ``bench.py`` times and ``train/run.py`` loops over.

Unlike the JAX step, which returns a new state, this one updates the model, the optimizer
and ``state.step`` in place. The metrics are device tensors; reading one waits for the step.
``step(state, batch, generator)`` takes the ``torch.Generator`` that patch dropout draws its
noise from (the JAX step's ``rngs={"patch_dropout": rng}``); a model without patch dropout
needs none.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item: meshes and
shard_map (Queue 1 item 9), gradient accumulation in both forms, the parameter EMA and
optimizer-state offload (item 8), ``wire_size`` (a serving piece of Queue 1), loss
families other than ``clip`` and contrastive forms other than ``dense`` (item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from multimodal_tpu_torch.data.preprocess import normalize_images
from multimodal_tpu_torch.losses.clip_loss import clip_loss
from multimodal_tpu_torch.train.optimizer import extract_grad_norm

LOGIT_SCALE_MAX = 4.6052  # ln(100)


def batch_images(batch: dict, model=None, wire_size: Optional[int] = None) -> torch.Tensor:
    """The image batch, normalized on its device when it arrives as uint8; a spatial size
    that differs from the model's raises, as in the reference."""
    if wire_size is not None:
        raise NotImplementedError("wire_size (the on-device bicubic upsample) is not ported "
                                  "yet (ROADMAP Queue 1, serving pieces)")
    img = batch["image"]
    if img.dtype == torch.uint8:
        img = normalize_images(img)
    target = getattr(getattr(getattr(model, "cfg", None), "vision", None), "image_size", None)
    if target and img.shape[1] != target:
        raise ValueError(
            f"batch images are {img.shape[1]}px but the model expects {target}px — "
            "pass --wire-size to opt into the on-device upsample, or decode the data "
            "at the model's resolution (--force-image-size rebuilds the model at the "
            "forced size)")
    return img


@dataclass
class TrainState:
    """What one training run carries from step to step; the step updates it in place."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, model, optimizer) -> "TrainState":
        return cls(step=0, model=model, optimizer=optimizer)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    return torch.sqrt(torch.stack([t.to(torch.float32).square().sum() for t in tensors]).sum())


@torch.no_grad()
def _clamp_logit_scale(model: torch.nn.Module):
    """Post-step clamp of every ``logit_scale`` parameter to [0, ln(100)], in place."""
    for name, p in model.named_parameters():
        if "logit_scale" in name:
            p.clamp_(0.0, LOGIT_SCALE_MAX)


def make_loss_fn(model, loss_type: str = "clip", loss_kwargs: Optional[dict] = None,
                 wire_size: Optional[int] = None) -> Callable:
    """loss_fn(model, batch, generator=None) -> (loss, metrics) for the CLIP InfoNCE loss
    (dense form); ``generator`` feeds patch dropout."""
    if loss_type != "clip":
        raise NotImplementedError(f"loss_type={loss_type!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")
    kw = dict(loss_kwargs or {})
    label_smoothing = kw.pop("label_smoothing", 0.0)
    kw.pop("local_loss", None)  # only meaningful on a mesh
    impl = kw.pop("contrastive_impl", "dense")
    kw.pop("chunk_size", None)
    kw.pop("moe_aux_weight", None)  # MoE models do not build in the port
    if impl != "dense":
        raise NotImplementedError(f"contrastive_impl={impl!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")
    if wire_size is not None:
        raise NotImplementedError("wire_size (the on-device bicubic upsample) is not ported "
                                  "yet (ROADMAP Queue 1, serving pieces)")

    def loss_fn(model, batch, generator=None):
        out = model(batch_images(batch, model), batch["text"], generator=generator)
        fi, ft, ls = out["image_features"], out["text_features"], out["logit_scale"]
        loss = clip_loss(fi, ft, ls, label_smoothing=label_smoothing, normalize=False, **kw)
        return loss, {"loss": loss.detach(), "logit_scale": ls.detach().clone()}

    return loss_fn


def make_train_step(model, optimizer, loss_type: str = "clip",
                    loss_kwargs: Optional[dict] = None, *, mesh=None,
                    use_shard_map: bool = False, accum_steps: int = 1,
                    feature_cached_accum: bool = False, ema_decay: Optional[float] = None,
                    offload_opt_state: bool = False, wire_size: Optional[int] = None):
    """Build ``step(state, batch, generator=None) -> metrics`` (``loss``, ``logit_scale``,
    ``grad_norm``).

    ``batch`` holds ``image`` (uint8 or float NHWC) and ``text`` (token ids), on the
    model's device. The step runs on ``state.model`` and ``state.optimizer``, which are
    ``model`` and ``optimizer`` when the state comes from ``TrainState.create``.
    ``generator`` is the source of the patch-dropout noise; a model with
    ``vision.patch_dropout`` > 0 raises without one."""
    left_out = {
        "mesh": (mesh is not None, "Queue 1 item 9"),
        "use_shard_map": (use_shard_map, "Queue 1 item 9"),
        "accum_steps": (accum_steps != 1, "Queue 1 item 8"),
        "feature_cached_accum": (feature_cached_accum, "Queue 1 item 8"),
        "ema_decay": (ema_decay is not None, "Queue 1 item 8"),
        "offload_opt_state": (offload_opt_state, "Queue 1 item 9"),
        "wire_size": (wire_size is not None, "Queue 1, serving pieces"),
    }
    for name, (on, item) in left_out.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet (ROADMAP {item})")
    loss_fn = make_loss_fn(model, loss_type, loss_kwargs)

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, batch, generator)
        loss.backward()
        state.optimizer.step()
        _clamp_logit_scale(state.model)
        norm = extract_grad_norm(state.optimizer)
        metrics["grad_norm"] = (norm.clone() if norm is not None else global_norm(
            [p.grad for p in state.model.parameters() if p.grad is not None]))
        state.step += 1
        return metrics

    return step
