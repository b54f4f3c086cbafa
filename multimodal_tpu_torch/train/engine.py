"""The training step (port of ``multimodal_tpu/train/engine.py``).

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
the reference). The loss families ``cloob`` (modern-Hopfield InfoLOOB) and ``align``
(AlignCLIP's in-modality terms, with the batch's ``semantic`` field when it has one) and the
chunked form of the CLIP loss (``contrastive_impl="chunked"``) are dispatched as in the
reference. It is the step the JAX package's ``bench.py`` times and ``train/run.py`` loops
over.

Gradient accumulation comes in the reference's two forms: plain micro-batch averaging
(``accum_steps``), and OpenCLIP's feature-cached accumulation (``feature_cached_accum``),
whose contrastive batch is the whole batch: a no-grad pass caches every micro-batch's
features, then each micro-batch is forwarded again with grad, spliced into the cached bank
and the whole-bank loss back-propagated. Each micro-batch replays the same patch-dropout
noise in both passes. Unlike the reference, which sums the whole-bank loss's logit-scale
gradient once per micro-batch (``accum_steps`` times the full-batch gradient, ROADMAP Queue
3), the port counts it from one micro-batch: every leaf's gradient is the full batch's.
``ema_decay`` keeps an exponential moving average of the parameters in ``state.ema``.

Unlike the JAX step, which returns a new state, this one updates the model, the optimizer
and ``state.step`` in place. The metrics are device tensors; reading one waits for the step.
``step(state, batch, generator)`` takes the ``torch.Generator`` that patch dropout draws its
noise from (the JAX step's ``rngs={"patch_dropout": rng}``) and the vclip loss its
Monte-Carlo draws; a model without patch dropout under the clip loss needs none. The step
runs the model in training mode and leaves it in the mode it found it in.

``wire_size`` (``--wire-size``) takes batches decoded at that smaller size and upsamples them
to the model's resolution on the device (``data.resize.bicubic``, JAX's bicubic) in the step's
prolog, ``batch_images``.

With ``mesh`` (a ``parallel.mesh`` device mesh) the step is the data-parallel step of one
rank: the batch it gets is this rank's rows (``parallel.shard_batch``), the loss runs its mesh
form over the batch axes' process group (the gathered-feature loss, local against global with
``local_loss``, the chunked form over the gathered keys, ``contrastive_impl="ring"``'s ring,
SigLIP's ring, the gathered CLOOB and align losses; the loss value is the global one on every
rank, and its backward hands each rank its share of the global gradient), and the
``Placement`` (``state_shardings``: FSDP, TP, FSDP x TP, EP; whole parameters without one)
gathers split weights at use, then sums the gradients over the batch axes before the
optimizer, whose global-norm clip and non-finite skip see the norm of the whole gradient. A
PyTorch step always runs per rank with explicit collectives, which is what JAX's
``use_shard_map`` selects; the flag is accepted, with its exclusions. ``offload_opt_state``
keeps the fused AdamW's moments in pinned host memory between steps (``parallel.offload``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from multimodal_tpu_torch.data.preprocess import normalize_images
from multimodal_tpu_torch.data.resize import bicubic
from multimodal_tpu_torch.distributions import NormalDiag, PowerSpherical, VonMisesFisher
from multimodal_tpu_torch.inference import model_mode
from multimodal_tpu_torch.losses.align_loss import align_clip_loss
from multimodal_tpu_torch.losses.clip_loss import clip_loss
from multimodal_tpu_torch.losses.cloob_loss import cloob_loss
from multimodal_tpu_torch.losses.global_contrastive import chunked_clip_loss, ring_clip_loss
from multimodal_tpu_torch.losses.siglip_loss import siglip_loss
from multimodal_tpu_torch.losses.vclip_loss import vclip_loss
from multimodal_tpu_torch.models.moe import collect_moe_losses
from multimodal_tpu_torch.ops.sphere import l2_normalize, riemannian_grad
from multimodal_tpu_torch.parallel.collectives import all_gather, mean_over
from multimodal_tpu_torch.train.optimizer import extract_grad_norm

LOGIT_SCALE_MAX = 4.6052  # ln(100)


def batch_images(batch: dict, model=None, wire_size: Optional[int] = None) -> torch.Tensor:
    """The step's input prolog: the image batch, normalized on its device when it arrives as
    uint8. With ``wire_size`` a batch decoded at that size (the --wire-size format) is
    upsampled to the model's resolution on the device (``data.resize.bicubic``, in float32).
    The resize needs the explicit ``wire_size``: a spatial size that differs from the model's
    without one raises, as does one that differs from ``wire_size``, as in the reference."""
    img = batch["image"]
    if img.dtype == torch.uint8:
        img = normalize_images(img)
    target = getattr(getattr(getattr(model, "cfg", None), "vision", None), "image_size", None)
    if target and img.shape[1] != target:
        if wire_size is None:
            raise ValueError(
                f"batch images are {img.shape[1]}px but the model expects {target}px — "
                "pass --wire-size to opt into the on-device upsample, or decode the data "
                "at the model's resolution (--force-image-size rebuilds the model at the "
                "forced size)")
        if img.shape[1] != wire_size:
            raise ValueError(f"batch images are {img.shape[1]}px but --wire-size is {wire_size}")
        img = bicubic(img, target)
    return img


@dataclass
class TrainState:
    """What one training run carries from step to step; the step updates it in place."""

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    # the parameters' exponential moving average (float32 copies by name), or None
    ema: Optional[dict] = None

    @classmethod
    def create(cls, model, optimizer, ema: bool = False) -> "TrainState":
        return cls(step=0, model=model, optimizer=optimizer,
                   ema=init_ema(model) if ema else None)


@torch.no_grad()
def init_ema(model: torch.nn.Module) -> dict:
    """The EMA's start: a float32 copy of every parameter, by name."""
    return {n: p.detach().to(torch.float32, copy=True) for n, p in model.named_parameters()}


@torch.no_grad()
def update_ema(ema: dict, model: torch.nn.Module, step: int, decay: float):
    """``ema = ema * d + params * (1 - d)`` in place, with the decay warm-up
    ``d = min(decay, (1 + step) / (10 + step))`` at the step before its increment, in
    float32 as the reference computes it."""
    step32 = np.float32(step)
    d = np.minimum(np.float32(decay), (np.float32(1) + step32) / (np.float32(10) + step32))
    named = dict(model.named_parameters())
    avg = list(ema.values())
    torch._foreach_mul_(avg, float(d))
    torch._foreach_add_(avg, torch._foreach_mul([named[n].detach().to(torch.float32)
                                                 for n in ema], float(np.float32(1) - d)))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32."""
    return torch.sqrt(torch.stack([t.to(torch.float32).square().sum() for t in tensors]).sum())


@torch.no_grad()
def _clamp_logit_scale(model: torch.nn.Module):
    """Post-step clamp of every ``logit_scale`` parameter to [0, ln(100)], in place."""
    for name, p in model.named_parameters():
        if "logit_scale" in name:
            p.clamp_(0.0, LOGIT_SCALE_MAX)


def _vclip_loss_fn(loss_kwargs: dict, wire_size: Optional[int] = None,
                   axis_name=None) -> Callable:
    """The variational loss: the heads' normalized means (through ``riemannian_grad`` with
    ``riemannian``) and concentrations as ``distribution_type`` distributions
    (``power_spherical``, ``vmf``, or ``normal`` on the raw means with std sqrt(variance)),
    then ``vclip_loss`` with the step's generator for its draws. On a group each rank's loss
    is its own rows' (as the reference's, which takes no axis), averaged over the ranks."""
    kw = dict(loss_kwargs)
    dist_type = kw.pop("distribution_type", "power_spherical")
    riemannian = kw.pop("riemannian", False)
    families = {"power_spherical": PowerSpherical, "vmf": VonMisesFisher}
    if dist_type not in (*families, "normal"):
        raise ValueError(f"unknown distribution_type {dist_type!r}")

    def loss_fn(model, batch, generator=None):
        out = model(batch_images(batch, model, wire_size), batch["text"])
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
        if axis_name is not None:
            res = {k: mean_over(v, axis_name) for k, v in res.items()}
        metrics = {k: v.detach() for k, v in res.items()}
        metrics["loss"] = metrics["total_loss"]
        metrics["mean_image_concentration"] = conc_i.detach().mean()
        metrics["mean_text_concentration"] = conc_t.detach().mean()
        return res["total_loss"], metrics

    return loss_fn


def make_loss_fn(model, loss_type: str = "clip", loss_kwargs: Optional[dict] = None,
                 wire_size: Optional[int] = None, axis_name=None) -> Callable:
    """loss_fn(model, batch, generator=None) -> (loss, metrics) for a loss family:
    ``clip`` (InfoNCE, dense or with ``contrastive_impl="chunked"`` the chunked form over
    ``chunk_size`` keys; ``generator`` feeds patch dropout; a model whose config has a MoE
    vision tower adds ``moe_aux_weight`` (0.01) times ``collect_moe_losses`` and reports it
    as ``moe_aux_loss``), ``cloob`` (``inv_tau`` 30, ``scale_hopfield`` 8), ``align``
    (``alpha``, ``beta``, ``separate_text``, ``separate_image``; the batch's ``semantic``
    field, when it has one, weights the in-modality terms), ``siglip`` (the model needs its
    ``logit_bias``) or ``vclip`` (``generator`` feeds its draws). ``axis_name`` (the process
    group of the batch axes) selects each loss's mesh form; ``contrastive_impl="ring"`` is the
    ring form on a group and the dense loss without one, as in the reference."""
    if loss_type not in ("clip", "siglip", "vclip", "cloob", "align"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    if loss_type == "vclip":
        return _vclip_loss_fn(loss_kwargs or {}, wire_size, axis_name)
    kw = dict(loss_kwargs or {})

    def forward(model, batch, generator):
        return model(batch_images(batch, model, wire_size), batch["text"], generator=generator)

    if loss_type == "siglip":
        if getattr(getattr(model, "cfg", None), "logit_bias_init", None) is None:
            raise ValueError(
                "loss_type='siglip' needs a model with a logit_bias param — create it "
                "with create_model(..., siglip=True) or cfg.logit_bias_init set")

        def siglip_fn(model, batch, generator=None):
            out = forward(model, batch, generator)
            ls, lb = out["logit_scale"], out["logit_bias"]
            loss = siglip_loss(out["image_features"], out["text_features"], ls, lb,
                               normalize=False, axis_name=axis_name, **kw)
            return loss, {"loss": loss.detach(), "logit_scale": ls.detach().clone(),
                          "logit_bias": lb.detach().clone()}

        return siglip_fn
    if loss_type == "cloob":
        inv_tau, scale_hopfield = kw.pop("inv_tau", 30.0), kw.pop("scale_hopfield", 8.0)

        def cloob_fn(model, batch, generator=None):
            out = forward(model, batch, generator)
            img, txt = out["image_features"], out["text_features"]
            if axis_name is not None:  # every rank computes the global loss
                img, txt = all_gather(img, axis_name), all_gather(txt, axis_name)
            loss = cloob_loss(img, txt, inv_tau=inv_tau, scale_hopfield=scale_hopfield)
            if axis_name is not None:
                loss = mean_over(loss, axis_name)
            return loss, {"loss": loss.detach()}

        return cloob_fn
    if loss_type == "align":

        def align_fn(model, batch, generator=None):
            out = forward(model, batch, generator)
            res = align_clip_loss(out["image_features"], out["text_features"],
                                  out["logit_scale"], semantic_features=batch.get("semantic"),
                                  normalize=False, axis_name=axis_name, **kw)
            metrics = {k: v.detach() for k, v in res.items()}
            return res["total_loss"], {"loss": metrics["total_loss"], **metrics}

        return align_fn
    label_smoothing = kw.pop("label_smoothing", 0.0)
    local_loss = kw.pop("local_loss", True)  # the mesh form's
    impl = kw.pop("contrastive_impl", "dense")
    chunk_size = kw.pop("chunk_size", 1024)
    moe_aux_weight = kw.pop("moe_aux_weight", 0.01)
    vision = getattr(getattr(model, "cfg", None), "vision", None)
    has_moe = vision is not None and vision.moe_experts > 0
    if impl not in ("dense", "chunked", "ring"):
        raise ValueError(f"unknown contrastive_impl {impl!r} (dense | chunked | ring)")

    def loss_fn(model, batch, generator=None):
        out = forward(model, batch, generator)
        fi, ft, ls = out["image_features"], out["text_features"], out["logit_scale"]
        if impl == "ring" and axis_name is not None:
            loss = ring_clip_loss(fi, ft, ls, axis_name, label_smoothing=label_smoothing,
                                  normalize=False, **kw)
        elif impl == "chunked":
            loss = chunked_clip_loss(fi, ft, ls, chunk_size=chunk_size,
                                     label_smoothing=label_smoothing, normalize=False,
                                     axis_name=axis_name, **kw)
        else:
            loss = clip_loss(fi, ft, ls, label_smoothing=label_smoothing, normalize=False,
                             axis_name=axis_name, local_loss=local_loss, **kw)
        metrics = {"loss": loss.detach(), "logit_scale": ls.detach().clone()}
        if has_moe:
            aux = _moe_aux(model, axis_name)
            loss = loss + moe_aux_weight * aux
            metrics["moe_aux_loss"], metrics["loss"] = aux.detach(), loss.detach()
        return loss, metrics

    return loss_fn


def _moe_aux(model, axis_name) -> torch.Tensor:
    """The load-balance terms of the model's MoE layers; on a group their mean over the
    ranks (each term is a mean over sequences, so that is the global batch's)."""
    aux = collect_moe_losses(model)
    return aux if axis_name is None else mean_over(aux, axis_name)


def _micro_batches(batch: dict, accum_steps: int) -> list[dict]:
    """``batch`` split along its first axis into ``accum_steps`` equal micro-batches."""
    n = batch["text"].shape[0]
    if n % accum_steps:
        raise ValueError(f"a batch of {n} does not split into {accum_steps} micro-batches")
    m = n // accum_steps
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(accum_steps)]


def _accum_grads(loss_fn, model, batch: dict, generator, accum_steps: int) -> dict:
    """Plain micro-batch accumulation: each micro-batch's loss back-propagated in turn (the
    gradients summed in ``.grad``), then divided by ``accum_steps``; the loss is the mean of
    the micro-batches', the other metrics the last micro-batch's."""
    loss_sum = 0.0
    for mb in _micro_batches(batch, accum_steps):
        loss, metrics = loss_fn(model, mb, generator)
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    torch._foreach_div_(grads, float(accum_steps))
    metrics["loss"] = loss_sum / accum_steps
    return metrics


def _feature_cached_grads(model, batch: dict, generator, loss_kwargs: Optional[dict],
                          accum_steps: int, wire_size: Optional[int] = None,
                          axis_name=None) -> dict:
    """Feature-cached accumulation of the dense CLIP loss, the full batch's gradient on
    every leaf. Phase 1: every micro-batch's features without grad, in order, the
    generator's state recorded before each. Phase 2: per micro-batch, the generator set back
    to that state (the same patch-dropout noise, so the features equal the cached ones), the
    forward with grad spliced into the cached bank and the whole-bank loss back-propagated,
    the gradients summed. The logit scale enters the whole-bank loss of the first
    micro-batch only: each micro-batch's loss carries the full batch's dependence on it, so
    summing k of them would give k times its gradient. A MoE tower's aux loss enters each
    micro-batch's loss at 1/k of its weight (the full batch's aux is the micro-batches'
    mean); the reported loss is topped up to the full batch's loss plus its aux term. On a
    group each rank banks its own micro-batches and the whole-bank loss takes the group."""
    kw = dict(loss_kwargs or {})
    label_smoothing = kw.pop("label_smoothing", 0.0)
    for key in ("local_loss", "contrastive_impl", "chunk_size"):
        kw.pop(key, None)
    moe_aux_weight = kw.pop("moe_aux_weight", 0.01)
    vision = getattr(getattr(model, "cfg", None), "vision", None)
    has_moe = vision is not None and vision.moe_experts > 0
    micro = _micro_batches(batch, accum_steps)

    def encode(mb):
        out = model(batch_images(mb, model, wire_size), mb["text"], generator=generator)
        aux = _moe_aux(model, axis_name) if has_moe else None
        return out["image_features"], out["text_features"], out["logit_scale"], aux

    states, bank_i, bank_t = [], [], []
    with torch.no_grad():
        for mb in micro:
            states.append(generator.get_state() if generator is not None else None)
            fi, ft, _, _ = encode(mb)
            bank_i.append(fi)
            bank_t.append(ft)
    end_state = generator.get_state() if generator is not None else None
    loss_sum, auxes = 0.0, []
    for idx, mb in enumerate(micro):
        if generator is not None:
            generator.set_state(states[idx])
        fi, ft, ls, aux = encode(mb)
        all_i = torch.cat(bank_i[:idx] + [fi] + bank_i[idx + 1:])
        all_t = torch.cat(bank_t[:idx] + [ft] + bank_t[idx + 1:])
        loss = clip_loss(all_i, all_t, ls if idx == 0 else ls.detach(),
                         label_smoothing=label_smoothing, normalize=False,
                         axis_name=axis_name, **kw)
        if has_moe:
            loss = loss + moe_aux_weight * aux / accum_steps
            auxes.append(aux.detach())
        loss.backward()
        loss_sum = loss_sum + loss.detach()
    if generator is not None:
        generator.set_state(end_state)
    loss_report = loss_sum / accum_steps
    metrics = {"logit_scale": ls.detach().clone()}
    if has_moe:
        mean_aux = torch.stack(auxes).mean()
        loss_report = loss_report + moe_aux_weight * mean_aux * (accum_steps - 1) / accum_steps
        metrics["moe_aux_loss"] = mean_aux
    metrics["loss"] = loss_report
    return metrics


def make_train_step(model, optimizer, loss_type: str = "clip",
                    loss_kwargs: Optional[dict] = None, *, mesh=None,
                    use_shard_map: bool = False, accum_steps: int = 1,
                    feature_cached_accum: bool = False, state_shardings=None,
                    ema_decay: Optional[float] = None, offload_opt_state: bool = False,
                    wire_size: Optional[int] = None):
    """Build ``step(state, batch, generator=None) -> metrics`` (``loss``, ``logit_scale``,
    ``grad_norm``, with a MoE vision tower ``moe_aux_loss``; for ``siglip`` also
    ``logit_bias``; for ``cloob`` ``loss`` and ``grad_norm``; for ``align`` also its three
    terms; for ``vclip`` the five loss terms, ``loss``, the two mean concentrations and
    ``grad_norm``).

    ``batch`` holds ``image`` (uint8 or float NHWC) and ``text`` (token ids), on the
    model's device, and for ``align`` optionally ``semantic``. The step runs on
    ``state.model`` and ``state.optimizer``, which are ``model`` and ``optimizer`` when the
    state comes from ``TrainState.create``. ``generator`` is the source of the patch-dropout
    noise and of the vclip loss's draws; a model with ``vision.patch_dropout`` > 0, or the
    sampled vclip loss, raises without one. ``accum_steps`` > 1 accumulates the gradient
    over that many equal micro-batches, with ``feature_cached_accum`` in the feature-cached
    form (the dense CLIP loss only: another loss or contrastive form raises
    ``ValueError``). With ``ema_decay`` set and ``state.ema`` present (``TrainState.create(...,
    ema=True)``), the EMA follows every update. The model runs in training mode and is left
    in the mode it was in.

    ``mesh``: the step of one rank of a data-parallel run; ``batch`` is this rank's rows.
    ``state_shardings``: the ``parallel.placement.Placement`` of ``model``'s parameters (from
    ``shard_model_fsdp`` / ``shard_model_tp`` / ``shard_model_fsdp_tp`` / ``shard_model_ep``,
    on ``mesh``; the optimizer built over the placed parameters); without it every parameter
    is whole on every rank. ``use_shard_map`` needs the mesh and excludes a placement that
    splits parameters, as in the reference. ``offload_opt_state`` moves the fused AdamW's
    moments into pinned host memory (a CUDA device only)."""
    if mesh is None and (use_shard_map or state_shardings is not None):
        raise ValueError("use_shard_map and state_shardings need a mesh")
    placement, group = None, None
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        from multimodal_tpu_torch.parallel.mesh import batch_group
        from multimodal_tpu_torch.parallel.placement import Placement

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (parallel.create_mesh), got "
                            f"{type(mesh).__name__}")
        placement = state_shardings if state_shardings is not None else Placement(model, mesh, {})
        if use_shard_map and placement.any_split:
            raise ValueError("use_shard_map and a parameter placement that splits parameters "
                             "(FSDP / TP / EP) are exclusive")
        placement.attach(optimizer)
        group = batch_group(mesh)
    if offload_opt_state:
        from multimodal_tpu_torch.parallel.offload import offload_optimizer_state

        offload_optimizer_state(optimizer)
    loss_fn = make_loss_fn(model, loss_type, loss_kwargs, wire_size=wire_size, axis_name=group)
    feature_cached = feature_cached_accum and accum_steps > 1
    if feature_cached:
        lk = loss_kwargs or {}
        if loss_type != "clip":
            raise ValueError("feature-cached accumulation is a CLIP-loss feature "
                             f"(got loss_type={loss_type!r})")
        if lk.get("contrastive_impl") not in (None, "dense") or lk.get("local_loss"):
            raise ValueError(
                "feature-cached accumulation computes the dense full-bank CLIP loss and "
                "does not support --contrastive-impl chunked/ring or --local-loss — "
                "drop --feature-cached-accum or the sharded contrastive options")

    def step(state: TrainState, batch: dict,
             generator: Optional[torch.Generator] = None) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        gathered = placement.gathered() if placement is not None else contextlib.nullcontext()
        with model_mode(state.model, True), gathered:
            if feature_cached:
                metrics = _feature_cached_grads(state.model, batch, generator, loss_kwargs,
                                                accum_steps, wire_size, group)
            elif accum_steps > 1:
                metrics = _accum_grads(loss_fn, state.model, batch, generator, accum_steps)
            else:
                loss, metrics = loss_fn(state.model, batch, generator)
                loss.backward()
        if placement is not None:
            placement.sync_grads()
        state.optimizer.step()
        if loss_type != "siglip":  # SigLIP's temperature runs free, as in the reference
            _clamp_logit_scale(state.model)
        norm = extract_grad_norm(state.optimizer)
        metrics["grad_norm"] = (norm.clone() if norm is not None else global_norm(
            [p.grad for p in state.model.parameters() if p.grad is not None]))
        if ema_decay is not None and state.ema is not None:
            update_ema(state.ema, state.model, state.step, ema_decay)
        state.step += 1
        return metrics

    return step
