"""Batch embedding extraction — the serving-side encode API (port of
``multimodal_tpu/inference.py:Embedder``).

Every encode runs in eval mode (``model_mode``: the reference encodes with ``train=False``)
under ``torch.inference_mode()`` on the model's device and returns L2-normalized float32
rows (``normalize=False``: the projections as they are); the model's own mode comes back
afterwards. The ``embed_*`` calls keep up to three chunks encoding ahead of the host fetch.
uint8 images cross to the device as uint8 and are normalized there. ``quantized=True``
converts the model's weights to int8 once (``inference_quant.quantize_clip_params``) and
encodes every batch through the W8A8 encoders instead of the model. ``wire_size=N`` also
takes [B, N, N, 3] batches and upsamples them to the model's resolution on the device
(``data.resize.bicubic``), the serving form of the train path's ``--wire-size``.
``embed_image_bytes`` / ``embed_image_files`` decode JPEG (or, through PIL, other) bytes on the
model's device first (``data.wds.decode_images``)."""

from __future__ import annotations

import collections
import contextlib
from typing import Sequence

import numpy as np
import torch

from multimodal_tpu_torch.data.preprocess import IMAGE_SIZE, normalize_images
from multimodal_tpu_torch.data.resize import bicubic
from multimodal_tpu_torch.data.tokenizer import tokenize
from multimodal_tpu_torch.data.wds import decode_images
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


def wire_upsample(x: torch.Tensor, model, wire_size) -> torch.Tensor:
    """The serving form of ``--wire-size`` (``train.engine.batch_images``): a batch at the
    model's resolution passes as it is; a ``wire_size`` batch is normalized (uint8) and
    upsampled to the model's resolution on its device. Any other size raises: the resize
    needs the explicit ``wire_size``."""
    s = model.cfg.vision.image_size
    if x.shape[1] == s and x.shape[2] == s:
        return x
    if wire_size is None or x.shape[1] != wire_size or x.shape[2] != wire_size:
        raise ValueError(
            f"images are {x.shape[1]}x{x.shape[2]} but the model expects {s}px — "
            f"construct the Embedder/EmbeddingService with wire_size={x.shape[1]} to "
            "opt into the on-device upsample")
    if x.dtype == torch.uint8:
        x = normalize_images(x)
    return bicubic(x, s)


class Embedder:
    """Fixed-batch text/image embedding over a ``CLIP`` model; with ``quantized=True`` over
    its int8 weights, converted once here (the model must be one the quantized encoders take,
    else ``ValueError``); with ``wire_size`` also over [B, wire_size, wire_size, 3] batches,
    upsampled on the device. ``normalize=False`` returns the projections as they are."""

    WINDOW = 3  # chunks encoded ahead of the host fetch (the reference's in-flight bound)

    def __init__(self, model, batch_size: int = 256, normalize: bool = True,
                 quantized: bool = False, wire_size: int | None = None):
        self.model = model
        self.batch_size = batch_size
        self.normalize = normalize
        self.wire_size = wire_size
        self.device = next(model.parameters()).device
        self.qparams = None  # the int8 weights, with quantized=True
        if quantized:
            with torch.inference_mode():
                self.qparams = quantize_clip_params(model)

    def _upload(self, array, dtype=None) -> torch.Tensor:
        """A numpy chunk (or a tensor) on the model's device; on the GPU a host chunk crosses
        from pinned memory without blocking the host, behind the encodes queued before it."""
        t = array if isinstance(array, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(array))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type == "cuda" and not t.is_cuda:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _text_features(self, tokens) -> torch.Tensor:
        t = self._upload(tokens, torch.int64)
        if self.qparams is not None:
            return encode_text_q(self.qparams, self.model.cfg, t, normalize=self.normalize)
        return self.model.encode_text(t, normalize=self.normalize)

    def _image_features(self, images) -> torch.Tensor:
        x = wire_upsample(self._upload(images), self.model, self.wire_size)
        if x.dtype == torch.uint8:
            x = normalize_images(x)
        if self.qparams is not None:
            return encode_image_q(self.qparams, self.model.cfg, x, normalize=self.normalize)
        return self.model.encode_image(x, normalize=self.normalize)

    def encode_tokens(self, tokens) -> np.ndarray:
        """One device batch of int tokens [B, context_length] -> float32 [B, embed_dim]."""
        with model_mode(self.model, False), torch.inference_mode():
            return self._text_features(tokens).cpu().numpy()

    def encode_images(self, images) -> np.ndarray:
        """One device batch of NHWC images (uint8, or float already normalized; numpy or a
        tensor)."""
        with model_mode(self.model, False), torch.inference_mode():
            return self._image_features(images).cpu().numpy()

    def _batched(self, features, array) -> np.ndarray:
        """Run ``features`` over fixed-size chunks of a numpy array or a tensor; the tail is
        padded by repeating its last row. Up to ``WINDOW`` chunks are encoded ahead of the
        host fetch: on the GPU each result is copied without blocking into a pinned buffer
        behind its encode, and the host waits on a chunk's event only when the window is
        full, so a chunk's upload and encode overlap the fetch of the ones before it."""
        cuda = self.device.type == "cuda"
        in_flight: collections.deque = collections.deque()
        outs = []

        def drain_one():
            host, done, n = in_flight.popleft()
            if done is not None:
                done.synchronize()
            outs.append(host.numpy()[:n])

        with model_mode(self.model, False), torch.inference_mode():
            for start in range(0, array.shape[0], self.batch_size):
                chunk = array[start : start + self.batch_size]
                n = chunk.shape[0]
                pad = self.batch_size - n
                if pad and isinstance(chunk, torch.Tensor):
                    chunk = torch.cat([chunk, chunk[-1:].expand(pad, *chunk.shape[1:])])
                elif pad:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
                out = features(chunk)
                done = None
                if cuda:
                    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    host = out
                in_flight.append((host, done, n))
                if len(in_flight) > self.WINDOW:
                    drain_one()
            while in_flight:
                drain_one()
        return np.concatenate(outs, axis=0) if outs else np.zeros((0,), np.float32)

    def embed_texts(self, texts: Sequence[str], context_length: int | None = None):
        ctx = context_length or self.model.cfg.text.context_length
        return self._batched(self._text_features, tokenize(list(texts), ctx))

    def embed_tokens(self, tokens):
        """Int tokens [N, context_length] (numpy or a tensor) -> float32 [N, embed_dim]."""
        return self._batched(self._text_features, tokens)

    def embed_images(self, images):
        """images: [N, S, S, 3] uint8 or normalized float."""
        return self._batched(self._image_features, images)

    def embed_image_bytes(self, buffers: Sequence[bytes], image_size: int = IMAGE_SIZE):
        """Encoded images (JPEG/PNG bytes) -> (embeddings, ok): decoded at ``image_size`` on
        the model's device, then embedded; failed decodes come back as zero rows, flagged
        in ``ok``."""
        arr, ok = decode_images(list(buffers), image_size, train=False, device=self.device)
        emb = self.embed_images(arr)
        emb[~ok] = 0.0
        return emb, ok

    def embed_image_files(self, paths: Sequence[str], image_size: int = IMAGE_SIZE):
        buffers = []
        for p in paths:
            try:
                with open(p, "rb") as f:
                    buffers.append(f.read())
            except OSError:
                buffers.append(b"")
        return self.embed_image_bytes(buffers, image_size)
