"""Image -> text top-k retrieval accuracy over paired rows (port of
``multimodal_tpu/eval/topk.py``): each image's caption competes with every other caption by
cosine similarity; a hit means the paired caption ranks in the top k. Computed in float32 on
the inputs' device (numpy inputs: the CPU)."""

from __future__ import annotations

import torch

from multimodal_tpu_torch.ops.sphere import l2_normalize


def paired_ranks(image_features, text_features, batch_size: int = 1024) -> torch.Tensor:
    """Rank (0-based) of each image's own caption among all N captions, [N] int: the count of
    captions scoring strictly higher than the paired one, so every top-k is ``rank < k``."""
    img = l2_normalize(torch.as_tensor(image_features).to(torch.float32))
    txt = l2_normalize(torch.as_tensor(text_features).to(img.device, torch.float32))
    ranks = []
    for start in range(0, img.shape[0], batch_size):
        block = img[start : start + batch_size]
        sims = block @ txt.T  # [b, N]
        rows = torch.arange(block.shape[0], device=img.device)
        own = sims[rows, rows + start]
        ranks.append((sims > own[:, None]).sum(dim=-1))
    return torch.cat(ranks)


def top_k_score(image_features, text_features, k: int = 1, batch_size: int = 1024) -> float:
    """image_features [N, E] paired row-wise with text_features [N, E]."""
    ranks = paired_ranks(image_features, text_features, batch_size)
    return int((ranks < k).sum()) / len(ranks)


def topk_metrics(image_features, text_features, ks=(1, 5, 10, 100)) -> dict:
    """Every k from one similarity pass."""
    ranks = paired_ranks(image_features, text_features)
    return {f"top{k}": int((ranks < k).sum()) / len(ranks) for k in ks}
