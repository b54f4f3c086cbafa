"""Batch embedding extraction — the serving-side encode API (port of
``multimodal_tpu/inference.py:Embedder``, without the wire-size path).

Every encode runs in eval mode (``model_mode``: the reference encodes with ``train=False``)
under ``torch.inference_mode()`` on the model's device and returns L2-normalized float32
rows; the model's own mode comes back afterwards. uint8 images cross to the device as uint8
and are normalized there. ``quantized=True`` converts the model's weights to int8 once
(``inference_quant.quantize_clip_params``) and encodes every batch through the W8A8 encoders
instead of the model."""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from multimodal_tpu_torch.data.preprocess import normalize_images
from multimodal_tpu_torch.data.tokenizer import tokenize
from multimodal_tpu_torch.inference_quant import encode_image_q, encode_text_q, quantize_clip_params


@contextlib.contextmanager
def model_mode(model: torch.nn.Module, training: bool):
    """Run the body with ``model`` in training (``True``) or eval mode, and give it back the
    mode it had, whatever the body does: an encode is deterministic whatever mode the
    caller's model is in (after a train step, say), and a train step leaves it as it was."""
    was = model.training
    model.train(training)
    try:
        yield model
    finally:
        model.train(was)


class Embedder:
    """Fixed-batch text/image embedding over a ``CLIP`` model; with ``quantized=True`` over
    its int8 weights, converted once here (the model must be one the quantized encoders take,
    else ``ValueError``)."""

    def __init__(self, model, batch_size: int = 256, quantized: bool = False):
        self.model = model
        self.batch_size = batch_size
        self.device = next(model.parameters()).device
        self.qparams = None  # the int8 weights, with quantized=True
        if quantized:
            with torch.inference_mode():
                self.qparams = quantize_clip_params(model)

    def encode_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """One device batch of int tokens [B, context_length] -> float32 [B, embed_dim]."""
        with model_mode(self.model, False), torch.inference_mode():
            t = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
            if self.qparams is not None:
                return encode_text_q(self.qparams, self.model.cfg, t).cpu().numpy()
            return self.model.encode_text(t, normalize=True).cpu().numpy()

    def encode_images(self, images: np.ndarray) -> np.ndarray:
        """One device batch of NHWC images (uint8, or float already normalized)."""
        with model_mode(self.model, False), torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
            if x.dtype == torch.uint8:
                x = normalize_images(x)
            if self.qparams is not None:
                return encode_image_q(self.qparams, self.model.cfg, x).cpu().numpy()
            return self.model.encode_image(x, normalize=True).cpu().numpy()

    def _batched(self, encode, array: np.ndarray) -> np.ndarray:
        """Run ``encode`` over fixed-size chunks; the tail is padded by repeating its last row."""
        outs = []
        for start in range(0, array.shape[0], self.batch_size):
            chunk = array[start : start + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
            out = encode(chunk)
            outs.append(out[: out.shape[0] - pad])
        return np.concatenate(outs, axis=0) if outs else np.zeros((0,), np.float32)

    def embed_texts(self, texts: Sequence[str]):
        ctx = self.model.cfg.text.context_length
        return self._batched(self.encode_tokens, tokenize(list(texts), ctx))

    def embed_images(self, images: np.ndarray):
        """images: [N, S, S, 3] uint8 or normalized float."""
        return self._batched(self.encode_images, images)
