"""Modality-gap probe: a linear classifier trained to tell image from text embeddings (port
of ``multimodal_tpu/eval/separability.py``); an accuracy near 0.5 means the modalities are
inseparable. Full-batch gradient descent on the CPU in float32. The initial weights are
normal draws times 0.01 from a ``torch.Generator`` seeded with ``seed`` (the reference draws
them from a JAX key, so the two probes start from different weights)."""

from __future__ import annotations

import numpy as np
import torch


def linear_separability(image_features, text_features, epochs: int = 1000, lr: float = 1e-2,
                        seed: int = 0) -> float:
    """Accuracy of the trained linear probe (0.5 = inseparable)."""
    x = torch.as_tensor(np.concatenate([np.asarray(image_features, np.float32),
                                        np.asarray(text_features, np.float32)]))
    y = torch.cat([torch.zeros(len(image_features), dtype=torch.long),
                   torch.ones(len(text_features), dtype=torch.long)])
    generator = torch.Generator().manual_seed(seed)
    w = (torch.randn(x.shape[-1], 2, generator=generator) * 0.01).requires_grad_(True)
    b = torch.zeros(2, requires_grad=True)
    for _ in range(epochs):
        loss = torch.nn.functional.cross_entropy(x @ w + b, y)
        gw, gb = torch.autograd.grad(loss, (w, b))
        with torch.no_grad():
            w -= lr * gw
            b -= lr * gb
    with torch.no_grad():
        return float(((x @ w + b).argmax(dim=-1) == y).to(torch.float32).mean())
