"""CLOOB: modern-Hopfield retrieval and InfoLOOB (port of
``multimodal_tpu/losses/cloob_loss.py``).

Pure functions of ``[B, E]`` features. Retrieval takes a float32 softmax over the scaled
stored-state similarities and L2-normalizes the retrieved rows with a 1e-12 floor;
InfoLOOB drops the positives from its denominator by masking them with -10000, the
reference's value (not an attention sentinel such as -1e30)."""

from __future__ import annotations

import torch

_LARGE_NEG = -10000.0


def hopfield_retrieval(state_patterns: torch.Tensor, stored_patterns: torch.Tensor,
                       scale_hopfield: float) -> torch.Tensor:
    """Retrieve each state pattern from the stored-pattern memory: state ``[Bs, E]``, stored
    ``[Bm, E]`` -> retrieved ``[Bs, E]``, rows L2-normalized."""
    attn = torch.softmax(
        scale_hopfield * torch.einsum("me,se->sm", stored_patterns, state_patterns).to(
            torch.float32), dim=-1)
    retrieved = attn @ stored_patterns.to(torch.float32)
    return retrieved / torch.clamp(torch.linalg.vector_norm(retrieved, dim=-1, keepdim=True),
                                   min=1e-12)


def infoloob_loss(x: torch.Tensor, y: torch.Tensor, inv_tau: float) -> torch.Tensor:
    """Negative mean log odds of the positive pairs (the diagonal); x, y ``[B, E]``."""
    k = (x @ y.T) * inv_tau
    eye = torch.eye(k.shape[0], dtype=torch.bool, device=k.device)
    positives = -torch.where(eye, k, torch.zeros_like(k)).sum(dim=1).mean()
    masked = torch.where(eye, torch.full_like(k, _LARGE_NEG), k)
    negatives = torch.logsumexp(masked, dim=1).mean()
    return positives + negatives


def cloob_loss(image_features: torch.Tensor, text_features: torch.Tensor, inv_tau: float,
               scale_hopfield: float) -> torch.Tensor:
    """The mean of two InfoLOOB terms after Hopfield retrieval: ``u`` from each modality's
    own memory, ``v`` from the other modality's."""
    u_img = hopfield_retrieval(image_features, image_features, scale_hopfield)
    u_txt = hopfield_retrieval(text_features, text_features, scale_hopfield)
    v_img = hopfield_retrieval(text_features, image_features, scale_hopfield)
    v_txt = hopfield_retrieval(image_features, text_features, scale_hopfield)
    return 0.5 * (infoloob_loss(u_img, v_img, inv_tau) + infoloob_loss(u_txt, v_txt, inv_tau))
