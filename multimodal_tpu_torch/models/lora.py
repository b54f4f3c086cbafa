"""LoRA adapters: extract, load and merge (port of ``multimodal_tpu/models/lora.py``).

The adapters live in the model as ``<projection>.lora_a`` [in, r] and ``<projection>.lora_b``
[r, out] (``models.layers.Dense``), so a LoRA fine-tune is the normal train step over the
adapters alone (``train.freeze``: mode ``"lora"``). These helpers cover the checkpoint side:
the adapters alone as a small flat dict, re-attached to a base model, or folded into the
kernels for a model without adapters (PEFT's ``merge_and_unload``). Names are the port's
(``model.named_parameters()``); ``checkpoint_interop.jax_adapters_to_port`` renames a dict of
the JAX package's ``extract_lora``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

ALPHA_KEY = "__lora_alpha__"  # the fine-tune's alpha, recorded in an extracted adapter dict


def is_lora_leaf(name: str) -> bool:
    return name.endswith("lora_a") or name.endswith("lora_b")


def _state(params) -> dict[str, torch.Tensor]:
    """name -> tensor of a model's parameters, or of a state dict as it is."""
    if isinstance(params, nn.Module):
        return {n: p.detach() for n, p in params.named_parameters()}
    return dict(params)


def lora_mask(params) -> dict[str, bool]:
    """True on the adapter leaves of a model (or a state dict) and nothing else. The
    optimizer-side mask of a LoRA fine-tune also trains the logit scale
    (``train.freeze.finetune_mask(..., "lora")``)."""
    return {n: is_lora_leaf(n) for n in _state(params)}


def extract_lora(params, alpha: float | None = None, *, cfg=None) -> dict[str, np.ndarray]:
    """The adapter leaves of a model (or a state dict) as a flat {name: float32 array} dict,
    with the fine-tune's alpha under ``ALPHA_KEY`` when it is given (``alpha=``, or ``cfg=``
    whose ``lora_alpha`` is read), so that a later ``merge_lora`` cannot use a wrong scale."""
    out = {n: t.detach().to("cpu", torch.float32).numpy().copy()
           for n, t in _state(params).items() if is_lora_leaf(n)}
    if alpha is None and cfg is not None:
        alpha = float(cfg.lora_alpha)
    if alpha is not None:
        out[ALPHA_KEY] = np.float32(alpha)
    return out


def _checked(state: Mapping[str, torch.Tensor], adapters: Mapping) -> dict[str, torch.Tensor]:
    """The adapters as tensors after checking each against ``state``: an unknown name (a
    wrong rank or another model) raises ``KeyError``, a wrong shape ``ValueError``."""
    out = {}
    for k, v in adapters.items():
        if k == ALPHA_KEY:
            continue
        if k not in state:
            raise KeyError(f"adapter leaf {k!r} not present in the model (wrong rank/model?)")
        if tuple(state[k].shape) != tuple(np.shape(v)):
            raise ValueError(f"adapter {k!r} shape {tuple(np.shape(v))} != model "
                             f"{tuple(state[k].shape)}")
        out[k] = torch.as_tensor(np.asarray(v, np.float32))
    return out


def load_lora(params, adapters: Mapping):
    """Re-attach extracted adapters: into a model in place (returned), or into a state dict
    (a new dict returned). Unknown names and wrong shapes raise."""
    state = _state(params)
    checked = _checked(state, adapters)
    if isinstance(params, nn.Module):
        with torch.no_grad():
            for n, p in params.named_parameters():
                if n in checked:
                    p.copy_(checked[n])
        return params
    return {**state, **{n: v.to(state[n].device, state[n].dtype) for n, v in checked.items()}}


def merge_lora(params, alpha: float | None = None, *, cfg=None, adapters: Mapping | None = None,
               into: nn.Module | None = None):
    """Fold every adapter pair into its kernel, kernel + (alpha / r) lora_a @ lora_b in
    float32, and drop the adapter leaves: the state of the same model built with
    ``lora_rank=0`` (a dict of float32 tensors), or, with ``into`` (such a model), that state
    loaded into it strictly and the model returned. ``params`` (a model or a state dict) is
    not changed.

    ``alpha`` must be the fine-tune's: give it as ``alpha=``, as ``cfg=`` (its
    ``lora_alpha``) or in ``adapters`` (an ``extract_lora`` dict with ``ALPHA_KEY``); sources
    that disagree raise, and so does none at all. ``adapters`` are loaded before the fold
    (``load_lora``: unknown names and wrong shapes raise), so a fresh model merged with a
    trained adapter dict folds the trained adapters."""
    sources = {"alpha": alpha}
    if cfg is not None:
        sources["cfg.lora_alpha"] = float(cfg.lora_alpha)
    if adapters is not None and ALPHA_KEY in adapters:
        sources[f"adapters[{ALPHA_KEY}]"] = float(adapters[ALPHA_KEY])
    given = {k: v for k, v in sources.items() if v is not None}
    if not given:
        raise ValueError("merge_lora needs the fine-tune's alpha: pass alpha=, cfg=, or an "
                         "extract_lora(..., alpha=...) dict via adapters=")
    values = {float(v) for v in given.values()}
    if len(values) > 1:
        raise ValueError(f"conflicting lora alpha values: {given}")
    alpha = values.pop()
    state = _state(params)
    if adapters is not None:
        state = load_lora(state, adapters)
    merged = {}
    for k, v in state.items():
        if is_lora_leaf(k):
            continue
        v = v.to(torch.float32)
        if k.endswith("kernel"):
            base = k[: -len("kernel")]
            a, b = state.get(base + "lora_a"), state.get(base + "lora_b")
            if a is not None and b is not None:
                v = v + (alpha / a.shape[1]) * (a.to(torch.float32) @ b.to(torch.float32))
        merged[k] = v.clone()
    if into is None:
        return merged
    into.load_state_dict(merged)
    return into
