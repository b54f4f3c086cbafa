"""Uniformity probe: the mean angle to the k-th nearest neighbor (port of
``multimodal_tpu/eval/entropy.py``), in blocks of rows so no N x N matrix is held."""

from __future__ import annotations

import numpy as np
import torch


def average_kth_neighbor_angle(embeddings, k: int = 1, batch_size: int = 1000) -> float:
    """Mean angle (radians) between each embedding and its k-th nearest neighbor."""
    x = torch.as_tensor(np.asarray(embeddings, np.float32))
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
    n = x.shape[0]
    total = 0.0
    for start in range(0, n, batch_size):
        block = x[start:start + batch_size]
        sims = block @ x.T
        rows = torch.arange(block.shape[0])
        sims[rows, rows + start] = -torch.inf  # not its own neighbor
        kth = torch.sort(sims, dim=-1).values[:, -k]
        total += float(torch.arccos(torch.clamp(kth, -1.0, 1.0)).sum())
    return total / n


def entropy_metric(image_features, text_features, k: int = 1) -> dict:
    both = np.concatenate([np.asarray(image_features), np.asarray(text_features)], axis=0)
    return {"image_knn_angle": average_kth_neighbor_angle(image_features, k),
            "text_knn_angle": average_kth_neighbor_angle(text_features, k),
            "joint_knn_angle": average_kth_neighbor_angle(both, k)}
