"""Train-time image augmentation config (--aug-cfg), applied host-side (port of
``multimodal_tpu/data/augment.py``: the same draws from the same numpy generator in the same
order, so both packages augment a batch to the same bits).

Counterpart of the reference's AugmentationCfg (align_clip/transform.py:18-27) and the
timm-backed train transform it gates (transform.py:88-106): RandomResizedCrop bounds
(scale/ratio), ColorJitter, random grayscale, and RandomErasing. The reference's non-timm
path consumes only ``scale`` and warns on the rest; with ``use_timm`` the full set applies.
Here every supported knob is functional on BOTH decode paths:

  * scale/ratio parameterize the crop itself (native ``mm_decode_batch_aug``, the card's
    crop boxes / preprocess.train_transform);
  * color_jitter / grayscale_prob / re_prob act on the decoded uint8 batch as vectorized
    numpy ops — torchvision-semantics jitter (random order, blend-with-mean contrast and
    blend-with-luma saturation, ITU-R 601-2 weights) and timm 'pixel'-mode erasing
    (per-pixel standard-normal noise in NORMALIZED space, mapped to the uint8 wire format
    through the OpenAI mean/std since normalization happens on-device here).

Unsupported timm keys (auto_augment policies, ...) warn loudly and are dropped,
mirroring transform.py:118's unused-keys warning.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from multimodal_tpu_torch.data.preprocess import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

log = logging.getLogger("multimodal_tpu_torch")

# ITU-R 601-2 luma weights (torchvision rgb_to_grayscale)
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)

_SUPPORTED_INTERP = ("bicubic",)


@dataclass
class AugmentationCfg:
    """Reference transform.py:18-27 surface + grayscale_prob (timm create_transform)."""

    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    color_jitter: Optional[Tuple[float, float, float]] = None
    # timm create_transform's simclr-style knob: probability of applying the jitter at
    # all (None = torchvision semantics, always applied when color_jitter is set)
    color_jitter_prob: Optional[float] = None
    hflip: float = 0.0
    grayscale_prob: float = 0.0
    re_prob: float = 0.0
    re_count: int = 1
    use_timm: bool = False

    @property
    def has_pixel_aug(self) -> bool:
        return (bool(self.color_jitter) or self.grayscale_prob > 0 or self.re_prob > 0
                or self.hflip > 0)


def _as_pair(v) -> Tuple[float, float]:
    if isinstance(v, (int, float)):
        return (float(v), float(v))
    lo, hi = v
    return (float(lo), float(hi))


def parse_aug_cfg(cfg) -> Optional[AugmentationCfg]:
    """dict (from --aug-cfg key=val) -> AugmentationCfg; None when empty.

    Follows the reference's key names. ``color_jitter`` accepts a float (same factor for
    brightness/contrast/saturation, timm's convention) or a 3-tuple. Keys with no
    counterpart here warn loudly and are ignored (transform.py:118 semantics).
    """
    if not cfg:
        return None
    if isinstance(cfg, AugmentationCfg):
        return cfg
    cfg = dict(cfg)
    out = AugmentationCfg()
    if "scale" in cfg:
        out.scale = _as_pair(cfg.pop("scale"))
    if "ratio" in cfg:
        out.ratio = _as_pair(cfg.pop("ratio"))
    cj = cfg.pop("color_jitter", None)
    if cj is not None:
        if isinstance(cj, (int, float)):
            out.color_jitter = (float(cj),) * 3
        else:
            b, c, s = cj
            out.color_jitter = (float(b), float(c), float(s))
        if not any(out.color_jitter):
            out.color_jitter = None
    if "color_jitter_prob" in cfg:
        out.color_jitter_prob = float(cfg.pop("color_jitter_prob"))
    if "hflip" in cfg:
        out.hflip = float(cfg.pop("hflip"))
    # timm spells this key gray_scale_prob (create_transform); accept both
    if "gray_scale_prob" in cfg:
        out.grayscale_prob = float(cfg.pop("gray_scale_prob"))
    if "grayscale_prob" in cfg:
        out.grayscale_prob = float(cfg.pop("grayscale_prob"))
    if "re_prob" in cfg:
        out.re_prob = float(cfg.pop("re_prob"))
    if "re_count" in cfg:
        out.re_count = int(cfg.pop("re_count"))
    out.use_timm = bool(cfg.pop("use_timm", False))
    interp = cfg.pop("interpolation", None)
    if interp and interp not in _SUPPORTED_INTERP:
        log.warning(
            "--aug-cfg interpolation=%s is not supported (the native resampler is "
            "bicubic, matching the reference's non-timm default); using bicubic", interp,
        )
    if cfg:
        log.warning(
            "--aug-cfg keys %s have no counterpart in this pipeline and are IGNORED "
            "(supported: scale, ratio, color_jitter, color_jitter_prob, hflip, "
            "grayscale_prob/gray_scale_prob, re_prob, re_count)",
            sorted(cfg),
        )
    return out


# ---------------------------------------------------------------------------
# pixel-space augmentations on the decoded uint8 batch
# ---------------------------------------------------------------------------


def _jitter_one(img: np.ndarray, rng: np.random.Generator, cj) -> np.ndarray:
    """torchvision ColorJitter on one [H,W,3] float image in [0,255]: factors sampled
    uniform[max(0,1-f), 1+f], transforms applied in random order."""
    b, c, s = cj
    ops = []
    if b:
        f = rng.uniform(max(0.0, 1 - b), 1 + b)
        ops.append(lambda x, f=f: x * f)
    if c:
        f = rng.uniform(max(0.0, 1 - c), 1 + c)
        # blend with the MEAN of the grayscale image (adjust_contrast)
        ops.append(lambda x, f=f: x * f + (1 - f) * (x @ _LUMA).mean())
    if s:
        f = rng.uniform(max(0.0, 1 - s), 1 + s)
        # blend with the per-pixel grayscale (adjust_saturation)
        ops.append(lambda x, f=f: x * f + (1 - f) * (x @ _LUMA)[..., None])
    order = rng.permutation(len(ops))
    for i in order:
        img = ops[i](img)
    return img


def _erase_one(
    img: np.ndarray, rng: np.random.Generator, count: int,
    mean255: np.ndarray, std255: np.ndarray,
) -> None:
    """timm RandomErasing(mode='pixel') in-place on one [H,W,3] uint8 image: per region,
    area ~ U[0.02, 1/3]*HW, log-aspect ~ U[log .3, log 3.3], filled with per-pixel noise
    that is standard-normal in normalized space (here: N(mean,std) scaled to uint8)."""
    h, w = img.shape[:2]
    for _ in range(count):
        for _attempt in range(10):
            area = h * w * rng.uniform(0.02, 1.0 / 3.0)
            aspect = np.exp(rng.uniform(np.log(0.3), np.log(3.3)))
            eh = int(round(np.sqrt(area * aspect)))
            ew = int(round(np.sqrt(area / aspect)))
            if eh < h and ew < w and eh > 0 and ew > 0:
                top = int(rng.integers(0, h - eh + 1))
                left = int(rng.integers(0, w - ew + 1))
                noise = rng.standard_normal((eh, ew, 3)).astype(np.float32)
                img[top:top + eh, left:left + ew] = np.clip(
                    noise * std255 + mean255 + 0.5, 0, 255
                ).astype(np.uint8)
                break


def apply_pixel_augment(
    batch: np.ndarray, rng: np.random.Generator, cfg: AugmentationCfg
) -> np.ndarray:
    """Apply color_jitter / grayscale / random-erasing to a decoded uint8 [N,H,W,3] batch.

    Order matches timm's train transform: jitter -> grayscale -> (normalize) -> erase;
    normalization itself stays on-device (the uint8 wire format), so erasing writes the
    uint8 image of normalized standard-normal noise.
    """
    if not cfg.has_pixel_aug:
        return batch
    mean255 = np.asarray(OPENAI_DATASET_MEAN, np.float32) * 255.0
    std255 = np.asarray(OPENAI_DATASET_STD, np.float32) * 255.0
    out = batch  # mutated in place sample-by-sample; callers own the array
    for i in range(batch.shape[0]):
        img = None
        if cfg.hflip and rng.uniform() < cfg.hflip:
            out[i] = out[i][:, ::-1]  # timm order: hflip before the color transforms
        if cfg.color_jitter and (cfg.color_jitter_prob is None
                                 or rng.uniform() < cfg.color_jitter_prob):
            img = _jitter_one(out[i].astype(np.float32), rng, cfg.color_jitter)
        if cfg.grayscale_prob and rng.uniform() < cfg.grayscale_prob:
            src = img if img is not None else out[i].astype(np.float32)
            img = np.broadcast_to((src @ _LUMA)[..., None], src.shape).copy()
        if img is not None:
            out[i] = np.clip(img + 0.5, 0, 255).astype(np.uint8)
        if cfg.re_prob and rng.uniform() < cfg.re_prob:
            _erase_one(out[i], rng, cfg.re_count, mean255, std255)
    return out
