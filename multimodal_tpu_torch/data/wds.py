"""Webdataset-style tar shard reading: sample grouping, non-throwing decode, batching (port of
``multimodal_tpu/data/wds.py``).

Counterpart of the reference's webdataset pipeline (AlignCLIP/main/data.py:424-548): tar ->
samples grouped by key (:310-315), sample shuffle buffer (:483), decode + tokenize (:487-492),
batched collation (:493), with log-and-continue error absorption (:276-279).

  * shards are indexed by the port's native tar scanner (``native/tar_index.cc``);
  * JPEGs decode in one batched call: on the host through the native libjpeg pipeline
    (``native/jpeg_pipeline.cc``), on a CUDA device through nvJPEG and the resample kernel
    (``ops/resample.py``); everything else, and every JPEG the batched path fails on, goes to
    PIL when PIL imports and otherwise comes back ``ok=False``;
  * batches leave as uint8 [B, S, S, 3] images on the decode's device + int32 [B, 77] tokens;
    normalization happens on the device (``train.engine.batch_images``);
  * on a CUDA device a batch is built on the calling thread's own stream (``on_own_stream``):
    it waits for none of the work queued on the caller's stream (the training step), which
    waits for the batch in turn.

Every random draw (crop seeds, the PIL path's crops, the augmentations, the shuffle buffer, the
backfill) comes from the reader's numpy generator in the reference's order, so both packages
build the same batches from the same shards and seed.
"""

from __future__ import annotations

import logging
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from multimodal_tpu_torch.data import preprocess
from multimodal_tpu_torch.data.augment import apply_pixel_augment, parse_aug_cfg
from multimodal_tpu_torch.data.shards import ShardSampler, expand_shards
from multimodal_tpu_torch.data.tokenizer import CONTEXT_LENGTH, tokenize
from multimodal_tpu_torch.native import bindings as native

log = logging.getLogger(__name__)

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp", "ppm", "pgm", "pbm", "pnm")
TEXT_EXTS = ("txt", "text", "caption")


def iter_tar_samples(path: str) -> Iterator[dict]:
    """Yield {'__key__': str, ext: bytes, ...} samples from one tar shard, grouping
    consecutive members by basename-before-first-dot (the webdataset convention).
    Non-throwing: unreadable shards and truncated members are logged and skipped."""
    try:
        entries = native.tar_index(path)
    except (OSError, ValueError) as e:  # unopenable, or an index line that does not parse
        log.warning("skipping unreadable shard %s: %r", path, e)
        return
    current_key, sample = None, {}
    try:
        with open(path, "rb") as f:
            for name, offset, size in entries:
                base = name.split("/")[-1]
                if base.startswith(".") or "." not in base:
                    continue
                key, ext = base.split(".", 1)
                ext = ext.lower()
                if key != current_key:
                    if sample:
                        yield sample
                    current_key, sample = key, {"__key__": key}
                f.seek(offset)
                sample[ext] = f.read(size)
    except OSError as e:
        log.warning("truncated shard %s: %r", path, e)
    if sample:
        yield sample


_own = threading.local()


def _own_stream(device: torch.device):
    """The calling thread's decode stream on ``device`` (one per thread and device)."""
    streams = _own.__dict__.setdefault("streams", {})
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _cuda_tensors(result) -> Iterator[torch.Tensor]:
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            yield result
    elif isinstance(result, dict):
        for v in result.values():
            yield from _cuda_tensors(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            yield from _cuda_tensors(v)


def on_own_stream(device, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its work on a CUDA ``device`` queued on the calling thread's
    own stream, so that it waits for none of the work queued on the caller's stream. Then the
    caller's stream waits for that work, and every CUDA tensor of the result is recorded as
    used on the caller's stream, so the allocator reuses none before the caller's work on it
    is done. Off CUDA, or already on the thread's own stream, it is ``fn(*args, **kwargs)``."""
    device = torch.device(device)
    if device.type != "cuda":
        return fn(*args, **kwargs)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    caller = torch.cuda.current_stream(device)
    own = _own_stream(device)
    if caller == own:
        return fn(*args, **kwargs)
    with torch.cuda.stream(own):
        result = fn(*args, **kwargs)
    caller.wait_stream(own)
    for t in _cuda_tensors(result):
        t.record_stream(caller)
    return result


def _first(sample: dict, exts: Iterable[str]) -> Optional[bytes]:
    for e in exts:
        if e in sample:
            return sample[e]
    return None


def _pil_fallback(data: bytes, image_size: int, train: bool, rng,
                  aug=None) -> Optional[np.ndarray]:
    """The PIL path of one sample -> uint8 [S, S, 3], or None where it fails (no PIL
    included)."""
    try:
        crop_kw = {"scale": aug.scale, "ratio": aug.ratio} if aug is not None else {}
        arr = preprocess.preprocess_bytes(data, train=train, rng=rng, image_size=image_size,
                                          **crop_kw)
        # preprocess returns normalized float; reconstruct the uint8 wire format
        mean = np.asarray(preprocess.OPENAI_DATASET_MEAN, np.float32)
        std = np.asarray(preprocess.OPENAI_DATASET_STD, np.float32)
        return np.clip((arr * std + mean) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    except Exception:  # noqa: BLE001 - per-sample absorption: the sample comes back not ok
        return None


def decode_images(
    buffers: list[bytes],
    image_size: int,
    train: bool,
    seeds: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
    aug=None,
    device="cuda",
) -> tuple[torch.Tensor, np.ndarray]:
    """Batch decode -> (uint8 [N,S,S,3] on ``device``, ok [N] bool). JPEGs go through the
    batched path of the device (the host's libjpeg pipeline on ``cpu``, nvJPEG and the resample
    kernel on ``cuda``); everything else (and batched-path failures) through PIL; failures come
    back ok=False. ``aug`` (data.augment.AugmentationCfg) parameterizes the train crop and adds
    the pixel-space augmentations (on the host) after decode. On CUDA the decode runs on the
    calling thread's own stream (``on_own_stream``)."""
    return on_own_stream(device, _decode_images, buffers, image_size, train, seeds, rng, aug,
                         device)


def _decode_images(buffers, image_size, train, seeds, rng, aug, device):
    device = torch.device(device)
    n = len(buffers)
    rng = rng or np.random.default_rng(0)
    if seeds is None:
        seeds = rng.integers(0, 2**63, n, dtype=np.uint64)
    crop_kw = {"scale": aug.scale, "ratio": aug.ratio} if aug is not None else {}
    jpeg_idx = [i for i in range(n) if native.is_jpeg(buffers[i])]
    ok = np.zeros(n, bool)
    if device.type == "cuda":
        from multimodal_tpu_torch.ops.resample import decode_jpegs

        out = torch.zeros((n, image_size, image_size, 3), dtype=torch.uint8, device=device)
        if jpeg_idx:
            imgs, good = decode_jpegs([buffers[i] for i in jpeg_idx], image_size, train,
                                      seeds=seeds[jpeg_idx], device=device, **crop_kw)
            idx = np.asarray(jpeg_idx)[good]
            out[torch.from_numpy(idx)] = imgs[torch.from_numpy(np.flatnonzero(good))]
            ok[idx] = True
    elif device.type == "cpu":
        out = torch.zeros((n, image_size, image_size, 3), dtype=torch.uint8)
        if jpeg_idx:
            imgs, good = native.decode_batch([buffers[i] for i in jpeg_idx], image_size,
                                             train=train, seeds=seeds[jpeg_idx], **crop_kw)
            idx = np.asarray(jpeg_idx)[good]
            out.numpy()[idx] = imgs[good]
            ok[idx] = True
    else:
        raise ValueError(f"decode_images decodes on cuda or cpu, not {device}")
    for i in np.flatnonzero(~ok):
        arr = _pil_fallback(buffers[i], image_size, train, rng, aug=aug)
        if arr is not None:
            out[i] = torch.from_numpy(arr).to(device)
            ok[i] = True
    if train and aug is not None and aug.has_pixel_aug:
        host = out.cpu().numpy() if device.type == "cuda" else out.numpy()
        out = torch.from_numpy(apply_pixel_augment(host, rng, aug)).to(device)
    return out, ok


def backfill(images: torch.Tensor, texts: list, ok: np.ndarray, rng) -> list:
    """Static batch shape: every failed sample takes the image and text of a good one drawn
    from the batch (in place on ``images``); the texts list, so filled."""
    good_idx = np.flatnonzero(ok)
    if len(good_idx) == len(texts):
        return list(texts)
    fill = rng.choice(good_idx, size=len(texts) - len(good_idx))
    bad_idx = np.flatnonzero(~ok)
    images[torch.from_numpy(bad_idx)] = images[torch.from_numpy(fill)]
    texts = list(texts)
    for b, g in zip(bad_idx, fill):
        texts[b] = texts[g]
    return texts


class WdsReader:
    """Shards -> shuffled, decoded, tokenized uint8/int32 batches.

    One reader per (host, worker). Bad samples are backfilled with good ones from the same
    batch, so every batch has the same shape. Images decode on ``device``."""

    def __init__(
        self,
        urls: str,
        *,
        batch_size: int,
        train: bool = True,
        image_size: int = preprocess.IMAGE_SIZE,
        context_length: int = CONTEXT_LENGTH,
        shuffle_buffer: int = 2000,
        seed: int = 0,
        resampled: bool = False,
        weights: Optional[str] = None,
        num_hosts: int = 1,
        host_id: int = 0,
        num_workers: int = 1,
        worker_id: int = 0,
        caption_key: Optional[str] = None,
        semantic_encoder=None,
        aug_cfg=None,
        device="cuda",
    ):
        shards, w = expand_shards(urls, weights)
        self.sampler = ShardSampler(shards, weights=w, seed=seed, resampled=resampled,
                                    num_hosts=num_hosts, host_id=host_id,
                                    num_workers=num_workers, worker_id=worker_id)
        self.batch_size = batch_size
        self.train = train
        self.image_size = image_size
        self.context_length = context_length
        self.shuffle_buffer = shuffle_buffer if train else 0
        self.seed = seed
        self.caption_key = caption_key
        # optional host-side caption embedder adding batch['semantic'] (AlignCLIP NL
        # semantic supervision side-input)
        self.semantic_encoder = semantic_encoder
        self.aug = parse_aug_cfg(aug_cfg) if train else None
        self.device = torch.device(device)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.sampler.set_epoch(epoch)

    @property
    def num_batches(self):
        """Unknown for streamed shards (the tar carries no index); callers needing an epoch
        length pass --train-num-samples / --steps-per-epoch."""
        return None

    def _raw_samples(self, rng) -> Iterator[tuple[bytes, str]]:
        buf: list[tuple[bytes, str]] = []
        for shard in self.sampler:
            for sample in iter_tar_samples(shard):
                img = _first(sample, IMAGE_EXTS)
                txt = (sample.get(self.caption_key) if self.caption_key
                       else _first(sample, TEXT_EXTS))
                if img is None or txt is None:
                    continue
                text = txt.decode("utf-8", errors="replace") if isinstance(txt, bytes) else txt
                if self.shuffle_buffer:
                    buf.append((img, text))
                    if len(buf) >= self.shuffle_buffer:
                        idx = int(rng.integers(len(buf)))
                        buf[idx], item = buf[-1], buf[idx]
                        buf.pop()
                        yield item
                else:
                    yield (img, text)
        rng.shuffle(buf)
        yield from buf

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng([self.seed, self.epoch, self.sampler.worker_id])
        images, texts = [], []
        for img_bytes, text in self._raw_samples(rng):
            images.append(img_bytes)
            texts.append(text)
            if len(images) == self.batch_size:
                batch = collate(images, texts, rng, image_size=self.image_size,
                                train=self.train, aug=self.aug,
                                context_length=self.context_length,
                                semantic_encoder=self.semantic_encoder, device=self.device)
                images, texts = [], []
                if batch is not None:
                    yield batch


def _collate(images, texts, rng, image_size, train, aug, context_length, semantic_encoder,
             device) -> Optional[dict]:
    arr, ok = decode_images(images, image_size, train, rng=rng, aug=aug, device=device)
    if not ok.any():
        return None
    texts = backfill(arr, texts, ok, rng)
    batch = {"image": arr, "text": tokenize(texts, context_length)}
    if semantic_encoder is not None:
        batch["semantic"] = semantic_encoder(texts)
    return batch


def collate(images: list[bytes], texts: list[str], rng, *, image_size: int, train: bool, aug,
            context_length: int, semantic_encoder, device) -> Optional[dict]:
    """One batch of (image bytes, caption) pairs -> {'image', 'text'[, 'semantic']}: decoded,
    failed samples backfilled, tokenized; None when no image decodes. On CUDA the device work
    (decode, backfill) runs on the calling thread's own stream (``on_own_stream``)."""
    return on_own_stream(device, _collate, images, list(texts), rng, image_size, train, aug,
                         context_length, semantic_encoder, device)
