"""Linear probing: logistic regression on frozen features (port of
``multimodal_tpu/eval/linear_probe.py``). AdamW in the form of ``optax.adamw`` (bias-corrected
moments, decoupled weight decay, the LR taken at the step count before the update) under the
port's cosine schedule with a warm-up of a twentieth of the steps; each step a batch of
indices drawn with replacement. The weights start at ``N(0, 0.01)``; the initial draw and the
indices come from one ``torch.Generator`` seeded with ``seed`` on ``device``."""

from __future__ import annotations

import numpy as np
import torch

from multimodal_tpu_torch.train.schedules import cosine_lr

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


def _grads(params: dict, xb: torch.Tensor, yb: torch.Tensor) -> dict:
    """Gradients of the mean cross-entropy of ``xb @ w + b`` against ``yb``."""
    p = torch.softmax(xb @ params["w"] + params["b"], dim=-1)
    p[torch.arange(xb.shape[0], device=xb.device), yb] -= 1.0
    p /= xb.shape[0]
    return {"w": xb.T @ p, "b": p.sum(dim=0)}


def probe_step(params: dict, state: dict, xb: torch.Tensor, yb: torch.Tensor, lr: float,
               weight_decay: float = 0.0) -> tuple[dict, dict]:
    """One AdamW step of the probe on the batch ``(xb, yb)`` at learning rate ``lr``;
    ``state`` holds ``count`` and the moments ``mu`` and ``nu`` (``probe_state``)."""
    g = _grads(params, xb, yb)
    count = state["count"] + 1
    mu = {k: ADAM_B1 * state["mu"][k] + (1 - ADAM_B1) * g[k] for k in g}
    nu = {k: ADAM_B2 * state["nu"][k] + (1 - ADAM_B2) * g[k] * g[k] for k in g}
    out = {}
    for k, p in params.items():
        m_hat = mu[k] / (1 - ADAM_B1 ** count)
        v_hat = nu[k] / (1 - ADAM_B2 ** count)
        out[k] = p - lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS) + weight_decay * p)
    return out, {"count": count, "mu": mu, "nu": nu}


def probe_state(params: dict) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def train_linear_probe(train_features, train_labels, num_classes: int, *, epochs: int = 100,
                       lr: float = 1e-3, weight_decay: float = 0.0, batch_size: int = 4096,
                       seed: int = 0, device="cuda") -> dict:
    """Returns {'w': [D, C], 'b': [C]}, float32 on ``device``."""
    device = torch.device(device)
    x = torch.as_tensor(np.asarray(train_features, np.float32)).to(device)
    y = torch.as_tensor(np.asarray(train_labels)).to(device, torch.int64)
    n, d = x.shape
    bs = min(batch_size, n)
    total_steps = epochs * max(n // bs, 1)
    schedule = cosine_lr(lr, max(total_steps // 20, 1), total_steps)
    generator = torch.Generator(device=device).manual_seed(seed)
    params = {"w": torch.randn((d, num_classes), generator=generator, device=device) * 0.01,
              "b": torch.zeros(num_classes, device=device)}
    state = probe_state(params)
    for step in range(total_steps):
        idx = torch.randint(0, n, (bs,), generator=generator, device=device)
        params, state = probe_step(params, state, x[idx], y[idx], float(schedule(step)),
                                   weight_decay)
    return params


def probe_accuracy(params: dict, features, labels, mean_per_class: bool = False) -> float:
    """Accuracy, or the mean over classes of each class's accuracy."""
    w = params["w"]
    x = torch.as_tensor(np.asarray(features, np.float32)).to(w.device)
    preds = (x @ w + params["b"]).argmax(dim=-1).cpu().numpy()
    labels = np.asarray(labels)
    if not mean_per_class:
        return float((preds == labels).mean())
    return float(np.mean([(preds[labels == c] == c).mean() for c in np.unique(labels)]))


def linear_probe_metrics(train_features, train_labels, test_features, test_labels,
                         num_classes: int, **kw) -> dict:
    params = train_linear_probe(train_features, train_labels, num_classes, **kw)
    return {
        "linear_probe_accuracy": probe_accuracy(params, test_features, test_labels),
        "linear_probe_mean_per_class": probe_accuracy(params, test_features, test_labels,
                                                      mean_per_class=True),
    }
