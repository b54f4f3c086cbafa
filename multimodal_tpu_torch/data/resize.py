"""The on-device bicubic resize of the ``--wire-size`` path (the counterpart of
``jax.image.resize(x, shape, method="bicubic")``, which the reference's ``batch_images`` and
``Embedder`` call).

JAX resamples each spatial axis with a dense weight matrix (``compute_weight_mat`` of
``jax/_src/image/scale.py``): output pixel ``i`` samples the input at the half-pixel point
``(i + 0.5) / scale - 0.5``, every input pixel gets Keys' cubic weight (a = -0.5) of its
distance, widened by ``1 / scale`` when downsampling (antialias), the weights of each output
pixel are renormalised to sum to one (out-of-range taps are simply absent), and an output
whose sample point falls outside the image gets zero weights. ``torch``'s own bicubic
(``F.interpolate``) uses a = -0.75 and clamps at the edges, so the weights are built here, in
float32 as JAX builds them, and applied as two float32 products, over H and then W, on the
tensor's device. The reference leaves this to XLA, not to a Pallas kernel, so plain torch is
its port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5, on |distance| (float32, as JAX fills it)."""
    one, two = np.float32(1.0), np.float32(2.0)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + one
    out = np.where(x >= one, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0))
                   * x + two, out)
    return np.where(x >= two, np.float32(0.0), out).astype(np.float32)


def weight_matrix(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """float32 [in_size, out_size] bicubic weights of one axis, as ``compute_weight_mat`` of
    ``jax.image.resize`` builds them: scale = out / in with no translation, the inverse scale
    taken in double and rounded to float32 where it meets the float32 sample grid."""
    inv_scale = 1.0 / (out_size / in_size)  # in double, then used as a float32 scalar
    kernel_scale = np.float32(max(inv_scale, 1.0) if antialias else 1.0)
    sample_f = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale)
                - np.float32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
         / kernel_scale)
    weights = _keys_cubic(x)
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * float(np.finfo(np.float32).eps))
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= np.float32(-0.5)) & (sample_f <= np.float32(in_size) - np.float32(0.5))
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_weights(in_size: int, out_size: int, antialias: bool,
                    device: torch.device) -> torch.Tensor:
    """``weight_matrix`` on ``device``, built and copied once per shape and device (the
    training step and the encoder call ``bicubic`` at a handful of fixed sizes)."""
    return torch.from_numpy(weight_matrix(in_size, out_size, antialias)).to(device)


def bicubic(x: torch.Tensor, size: int, antialias: bool = True) -> torch.Tensor:
    """NHWC images -> float32 [N, size, size, C] on ``x``'s device: ``jax.image.resize(x,
    (N, size, size, C), "bicubic")``."""
    if x.dim() != 4:
        raise ValueError(f"bicubic takes NHWC images, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    wh = _device_weights(h, size, antialias, x.device)
    ww = _device_weights(w, size, antialias, x.device)
    x = x.to(torch.float32)
    y = torch.einsum("nhwc,hi->niwc", x, wh)
    return torch.einsum("niwc,wj->nijc", y, ww).contiguous()
