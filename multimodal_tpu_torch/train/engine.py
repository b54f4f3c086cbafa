"""The training step on one device (port of ``multimodal_tpu/train/engine.py``).

``make_train_step(model, optimizer)`` returns ``step(state, batch) -> metrics``: the forward
of both towers on a uint8 (or already normalized) image batch and its tokens, the CLIP
InfoNCE loss on the normalized features (with a MoE vision tower plus ``moe_aux_weight``
times its load-balance terms; with ``loss_type="siglip"`` and a model with a ``logit_bias``,
the SigLIP loss; with ``loss_type="vclip"`` and a ``VariationalCLIP``, the variational loss
on the distributions its heads emit), the backward (on a CUDA tensor the attention half of
every block, and with ``block_mlp`` its MLP half, runs the hand-written forward and backward
kernels), the fused AdamW step with its global-norm clip and non-finite skip over the
parameters the optimizer holds (all of them, or the trainable ones of ``train.freeze``), and
the ln(100) clamp of the logit scale (not under SigLIP, whose temperature runs free, as in
the reference).
It is the step the JAX package's ``bench.py`` times and ``train/run.py`` loops over.

Unlike the JAX step, which returns a new state, this one updates the model, the optimizer
and ``state.step`` in place. The metrics are device tensors; reading one waits for the step.
``step(state, batch, generator)`` takes the ``torch.Generator`` that patch dropout draws its
noise from (the JAX step's ``rngs={"patch_dropout": rng}``) and the vclip loss its
Monte-Carlo draws; a model without patch dropout under the clip loss needs none. The step
runs the model in training mode and leaves it in the mode it found it in.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item: meshes and
shard_map (Queue 1 item 9), gradient accumulation in both forms, the parameter EMA and
optimizer-state offload (item 8), ``wire_size`` (a serving piece of Queue 1), the loss
families ``cloob`` and ``align`` and contrastive forms other than ``dense`` (item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from multimodal_tpu_torch.data.preprocess import normalize_images
from multimodal_tpu_torch.distributions import NormalDiag, PowerSpherical, VonMisesFisher
from multimodal_tpu_torch.inference import model_mode
from multimodal_tpu_torch.losses.clip_loss import clip_loss
from multimodal_tpu_torch.losses.siglip_loss import siglip_loss
from multimodal_tpu_torch.losses.vclip_loss import vclip_loss
from multimodal_tpu_torch.models.moe import collect_moe_losses
from multimodal_tpu_torch.ops.sphere import l2_normalize, riemannian_grad
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


def _vclip_loss_fn(loss_kwargs: dict) -> Callable:
    """The variational loss: the heads' normalized means (through ``riemannian_grad`` with
    ``riemannian``) and concentrations as ``distribution_type`` distributions
    (``power_spherical``, ``vmf``, or ``normal`` on the raw means with std sqrt(variance)),
    then ``vclip_loss`` with the step's generator for its draws."""
    kw = dict(loss_kwargs)
    dist_type = kw.pop("distribution_type", "power_spherical")
    riemannian = kw.pop("riemannian", False)
    families = {"power_spherical": PowerSpherical, "vmf": VonMisesFisher}
    if dist_type not in (*families, "normal"):
        raise ValueError(f"unknown distribution_type {dist_type!r}")

    def loss_fn(model, batch, generator=None):
        out = model(batch_images(batch, model), batch["text"])
        conc_i, conc_t = out["image_concentration"], out["text_concentration"]
        if dist_type == "normal":
            di = NormalDiag(out["image_mean"], torch.sqrt(conc_i))
            dt = NormalDiag(out["text_mean"], torch.sqrt(conc_t))
        else:
            mu_i, mu_t = l2_normalize(out["image_mean"]), l2_normalize(out["text_mean"])
            if riemannian:
                mu_i, mu_t = riemannian_grad(mu_i), riemannian_grad(mu_t)
            di, dt = families[dist_type](mu_i, conc_i), families[dist_type](mu_t, conc_t)
        res = vclip_loss(di, dt, conc_i, conc_t, out["logit_scale"], generator=generator, **kw)
        metrics = {k: v.detach() for k, v in res.items()}
        metrics["loss"] = metrics["total_loss"]
        metrics["mean_image_concentration"] = conc_i.detach().mean()
        metrics["mean_text_concentration"] = conc_t.detach().mean()
        return res["total_loss"], metrics

    return loss_fn


def make_loss_fn(model, loss_type: str = "clip", loss_kwargs: Optional[dict] = None,
                 wire_size: Optional[int] = None) -> Callable:
    """loss_fn(model, batch, generator=None) -> (loss, metrics) for the CLIP InfoNCE loss
    (dense form; ``generator`` feeds patch dropout; a model whose config has a MoE vision
    tower adds ``moe_aux_weight`` (0.01) times ``collect_moe_losses`` and reports it as
    ``moe_aux_loss``), the SigLIP loss (``siglip``; the model needs its ``logit_bias``) or the
    variational loss (``vclip``; ``generator`` feeds its draws)."""
    if loss_type in ("cloob", "align"):
        raise NotImplementedError(f"loss_type={loss_type!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")
    if loss_type not in ("clip", "siglip", "vclip"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if wire_size is not None:
        raise NotImplementedError("wire_size (the on-device bicubic upsample) is not ported "
                                  "yet (ROADMAP Queue 1, serving pieces)")
    if loss_type == "vclip":
        return _vclip_loss_fn(loss_kwargs or {})
    kw = dict(loss_kwargs or {})
    if loss_type == "siglip":
        if getattr(getattr(model, "cfg", None), "logit_bias_init", None) is None:
            raise ValueError(
                "loss_type='siglip' needs a model with a logit_bias param — create it "
                "with create_model(..., siglip=True) or cfg.logit_bias_init set")

        def siglip_fn(model, batch, generator=None):
            out = model(batch_images(batch, model), batch["text"], generator=generator)
            ls, lb = out["logit_scale"], out["logit_bias"]
            loss = siglip_loss(out["image_features"], out["text_features"], ls, lb,
                               normalize=False, **kw)
            return loss, {"loss": loss.detach(), "logit_scale": ls.detach().clone(),
                          "logit_bias": lb.detach().clone()}

        return siglip_fn
    label_smoothing = kw.pop("label_smoothing", 0.0)
    kw.pop("local_loss", None)  # only meaningful on a mesh
    impl = kw.pop("contrastive_impl", "dense")
    kw.pop("chunk_size", None)
    moe_aux_weight = kw.pop("moe_aux_weight", 0.01)
    vision = getattr(getattr(model, "cfg", None), "vision", None)
    has_moe = vision is not None and vision.moe_experts > 0
    if impl != "dense":
        raise NotImplementedError(f"contrastive_impl={impl!r} is not ported yet "
                                  "(ROADMAP Queue 1 item 7)")

    def loss_fn(model, batch, generator=None):
        out = model(batch_images(batch, model), batch["text"], generator=generator)
        fi, ft, ls = out["image_features"], out["text_features"], out["logit_scale"]
        loss = clip_loss(fi, ft, ls, label_smoothing=label_smoothing, normalize=False, **kw)
        metrics = {"loss": loss.detach(), "logit_scale": ls.detach().clone()}
        if has_moe:
            aux = collect_moe_losses(model)
            loss = loss + moe_aux_weight * aux
            metrics["moe_aux_loss"], metrics["loss"] = aux.detach(), loss.detach()
        return loss, metrics

    return loss_fn


def make_train_step(model, optimizer, loss_type: str = "clip",
                    loss_kwargs: Optional[dict] = None, *, mesh=None,
                    use_shard_map: bool = False, accum_steps: int = 1,
                    feature_cached_accum: bool = False, ema_decay: Optional[float] = None,
                    offload_opt_state: bool = False, wire_size: Optional[int] = None):
    """Build ``step(state, batch, generator=None) -> metrics`` (``loss``, ``logit_scale``,
    ``grad_norm``, with a MoE vision tower ``moe_aux_loss``; for ``siglip`` also
    ``logit_bias``; for ``vclip`` the five loss terms, ``loss``, the two mean concentrations
    and ``grad_norm``).

    ``batch`` holds ``image`` (uint8 or float NHWC) and ``text`` (token ids), on the
    model's device. The step runs on ``state.model`` and ``state.optimizer``, which are
    ``model`` and ``optimizer`` when the state comes from ``TrainState.create``.
    ``generator`` is the source of the patch-dropout noise and of the vclip loss's draws; a
    model with ``vision.patch_dropout`` > 0, or the sampled vclip loss, raises without one.
    The model runs in training mode and is left in the mode it was in."""
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
        state.optimizer.zero_grad(set_to_none=True)
        with model_mode(state.model, True):
            loss, metrics = loss_fn(state.model, batch, generator)
            loss.backward()
        state.optimizer.step()
        if loss_type != "siglip":  # SigLIP's temperature runs free, as in the reference
            _clamp_logit_scale(state.model)
        norm = extract_grad_norm(state.optimizer)
        metrics["grad_norm"] = (norm.clone() if norm is not None else global_norm(
            [p.grad for p in state.model.parameters() if p.grad is not None]))
        state.step += 1
        return metrics

    return step
