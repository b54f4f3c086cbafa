"""CLIP image preprocessing: the host-side PIL geometry and the device-side normalization
(port of ``multimodal_tpu/data/preprocess.py``).

``normalize_images`` scales uint8 NHWC on the tensor's device (uint8 stays uint8 on the
wire). The PIL functions are the decode path for what the native JPEG pipeline does not take
(PNG, webp, and JPEGs it fails on): ``eval_transform`` (bicubic resize of the shorter side,
centre crop), ``train_transform`` (RandomResizedCrop drawn from the caller's numpy
generator), ``resize_max_size`` (the letterbox transform) and ``preprocess_bytes``. PIL is an
optional import, as in the reference: without it those functions raise and the decode path
reports such samples as failed.
"""

from __future__ import annotations

import io

import numpy as np
import torch

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # PIL is optional: the PIL path's samples then fail
    _HAS_PIL = False

# OpenAI CLIP dataset statistics
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGE_SIZE = 224


def normalize_images(x: torch.Tensor, mean=OPENAI_DATASET_MEAN,
                     std=OPENAI_DATASET_STD) -> torch.Tensor:
    """uint8 (divided by 255 in float32) or float NHWC images -> normalized float32."""
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _to_rgb(img):
    return img.convert("RGB") if img.mode != "RGB" else img


def _resize_shorter(img, size: int):
    w, h = img.size
    scale = size / min(w, h)
    new_w, new_h = max(round(w * scale), size), max(round(h * scale), size)
    return img.resize((new_w, new_h), Image.BICUBIC)


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top : top + size, left : left + size]


def resize_max_size(img, max_size: int, fill: int = 0):
    """Letterbox transform (align_clip/transform.py:29-53 ResizeMaxSize): scale so the longer
    side equals ``max_size`` (bicubic), then center-pad to a ``max_size`` square with ``fill``.
    Returns a PIL image; preserves aspect ratio instead of cropping."""
    w, h = img.size
    scale = max_size / float(max(w, h))
    if scale == 1.0:
        return img
    new_w, new_h = round(w * scale), round(h * scale)
    img = img.resize((new_w, new_h), Image.BICUBIC)
    canvas = Image.new(img.mode, (max_size, max_size), fill)
    canvas.paste(img, ((max_size - new_w) // 2, (max_size - new_h) // 2))
    return canvas


def eval_transform(img, image_size: int = IMAGE_SIZE, normalize: bool = True) -> np.ndarray:
    """Resize(shorter side, bicubic) -> CenterCrop -> RGB -> [0,1] -> normalize; HWC f32."""
    img = _to_rgb(_resize_shorter(img, image_size))
    arr = _center_crop(np.asarray(img, dtype=np.float32) / 255.0, image_size)
    if normalize:
        arr = (arr - np.asarray(OPENAI_DATASET_MEAN, np.float32)) / np.asarray(
            OPENAI_DATASET_STD, np.float32
        )
    return arr


def train_transform(
    img,
    rng: np.random.Generator,
    image_size: int = IMAGE_SIZE,
    scale=(0.9, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
    normalize: bool = True,
) -> np.ndarray:
    """RandomResizedCrop(scale, ratio, bicubic) -> RGB -> [0,1] -> normalize; HWC f32.

    Same sampling procedure as torchvision's RandomResizedCrop (used by reference
    transform.py:108-117): 10 attempts at area/log-ratio sampling, fallback to center crop.
    """
    img = _to_rgb(img)
    w, h = img.size
    area = w * h
    log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            crop = img.crop((left, top, left + cw, top + ch))
            break
    else:  # fallback: central crop at the clamped aspect
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw, ch = w, int(round(w / ratio[0]))
        elif in_ratio > ratio[1]:
            cw, ch = int(round(h * ratio[1])), h
        else:
            cw, ch = w, h
        left, top = (w - cw) // 2, (h - ch) // 2
        crop = img.crop((left, top, left + cw, top + ch))
    arr = np.asarray(crop.resize((image_size, image_size), Image.BICUBIC), np.float32) / 255.0
    if normalize:
        arr = (arr - np.asarray(OPENAI_DATASET_MEAN, np.float32)) / np.asarray(
            OPENAI_DATASET_STD, np.float32
        )
    return arr


def decode_image(data: bytes):
    """JPEG/PNG bytes -> PIL image (the host decode stage of the PIL path)."""
    if not _HAS_PIL:
        raise RuntimeError("PIL is not installed: the PIL decode path is unavailable")
    return Image.open(io.BytesIO(data))


def preprocess_bytes(
    data: bytes,
    train: bool = False,
    rng=None,
    image_size: int = IMAGE_SIZE,
    scale=(0.9, 1.0),
    ratio=(3.0 / 4.0, 4.0 / 3.0),
):
    img = decode_image(data)
    if train:
        return train_transform(
            img, rng or np.random.default_rng(), image_size, scale=scale, ratio=ratio
        )
    return eval_transform(img, image_size)
