"""Model factory: registry name -> initialized ``CLIP`` or ``VariationalCLIP`` on a device
(port of ``multimodal_tpu/models/factory.py:create_model``)."""

from __future__ import annotations

import dataclasses
import math

import torch

from multimodal_tpu_torch.models.clip import CLIP, VariationalCLIP
from multimodal_tpu_torch.models.config import CLIPConfig, VariationalConfig, get_model_config


def model_config(name: str, remat: bool | None = None, patch_dropout: float | None = None,
                 force_quick_gelu: bool = False, siglip: bool = False,
                 lora_rank: int | None = None, lora_alpha: float | None = None,
                 int8_forward: bool = False,
                 force_image_size: int | None = None) -> CLIPConfig:
    """The registry config of ``name`` with the reference factory's options applied in its
    order: ``force_image_size`` (the vision tower built at that resolution; a ``ValueError``
    unless it is a multiple of the patch), ``remat``, ``int8_forward``, ``lora_rank`` /
    ``lora_alpha`` (adapters on every trunk projection; the alpha defaults to the config's),
    ``siglip`` (the SigLIP head: ``logit_bias`` from -10, ``logit_scale`` from ln 10),
    ``force_quick_gelu`` and ``patch_dropout``."""
    cfg = get_model_config(name)
    if force_image_size:
        if force_image_size % cfg.vision.patch_size:
            raise ValueError(f"--force-image-size {force_image_size} is not a multiple of the "
                             f"model's patch size {cfg.vision.patch_size}")
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, image_size=force_image_size))
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if int8_forward:
        cfg = dataclasses.replace(cfg, int8_forward=True)
    if lora_rank:
        cfg = dataclasses.replace(cfg, lora_rank=lora_rank,
                                  lora_alpha=lora_alpha or cfg.lora_alpha)
    if siglip:
        cfg = dataclasses.replace(cfg, logit_bias_init=-10.0,
                                  logit_scale_init=float(math.log(10.0)))
    if force_quick_gelu:
        cfg = dataclasses.replace(cfg, act="quick_gelu")
    if patch_dropout is not None:
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, patch_dropout=patch_dropout))
    return cfg


def create_model(name: str, variational: bool = False, vcfg: VariationalConfig | None = None,
                 dtype: torch.dtype = torch.float32, *, device: str | torch.device = "cuda",
                 seed: int = 0, block_mlp: bool = False, **options) -> CLIP | VariationalCLIP:
    """Build ``name`` with the reference's init distributions, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (the same weights on every device), then
    moved to ``device``: the GPU unless the caller asks for ``"cpu"``; without a CUDA
    device that raises, it never moves to the CPU on its own. Parameters stay float32;
    ``dtype`` is the compute dtype. ``variational=True`` builds the ``VariationalCLIP`` of
    ``vcfg`` (default ``VariationalConfig()``), as the reference does for the same
    arguments. ``block_mlp=True`` opts a ``CLIP`` into the fused MLP operator (on the card
    the hand-written ``block_mlp`` kernels) in every block that can take it; the reference's
    ``VariationalCLIP`` never does, and refuses it here.

    ``options`` are the reference factory's config options, by the same names
    (``model_config``): ``remat``, ``patch_dropout``, ``force_quick_gelu``, ``siglip``,
    ``lora_rank``, ``lora_alpha``, ``int8_forward`` (every dense MLP on the SwitchBack int8
    GEMMs) and ``force_image_size``."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"create_model({name!r}, device={str(device)!r}): no CUDA device is available; "
            "pass device='cpu' to build the model on the CPU")
    cfg = model_config(name, **options)
    if variational:
        if block_mlp:
            raise ValueError("block_mlp: the variational model's trunks take no fused MLP")
        model = VariationalCLIP(cfg, vcfg or VariationalConfig(), dtype=dtype)
    else:
        model = CLIP(cfg, dtype=dtype, block_mlp=block_mlp)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
