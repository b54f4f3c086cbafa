"""The synthetic data backend: the training loop runs with no data and no network (port of
``multimodal_tpu/data/synthetic.py``).

``SyntheticBatches`` draws each epoch's stream from ``numpy.random.default_rng([seed,
epoch])``: uint8 images, token rows framed by BOS (``vocab_size - 2``) and EOT
(``vocab_size - 1``), and with ``with_semantic`` a unit-norm float32 ``semantic`` field. The
stream is bit for bit the reference's, so the same seed feeds both packages the same
batches."""

from __future__ import annotations

import numpy as np

from multimodal_tpu_torch.data.preprocess import IMAGE_SIZE, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from multimodal_tpu_torch.data.tokenizer import CONTEXT_LENGTH, tokenize


class SyntheticDataset:
    """A fixed black image (already normalized) and a fixed tokenized caption."""

    def __init__(self, num_samples: int = 100, image_size: int = IMAGE_SIZE,
                 caption: str = "Dummy caption", context_length: int = CONTEXT_LENGTH):
        self.num_samples = num_samples
        self.image_size = image_size
        self._image = ((np.zeros((image_size, image_size, 3), np.float32)
                        - np.asarray(OPENAI_DATASET_MEAN, np.float32))
                       / np.asarray(OPENAI_DATASET_STD, np.float32))
        self._text = tokenize([caption], context_length=context_length)[0]

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        if not 0 <= idx < self.num_samples:
            raise IndexError(idx)
        return {"image": self._image, "text": self._text}

    def batches(self, batch_size: int, steps: int | None = None):
        """Yield ``{"image": [B, H, W, 3] float32, "text": [B, L] int32}``."""
        total = steps if steps is not None else self.num_samples // batch_size
        image = np.broadcast_to(self._image, (batch_size,) + self._image.shape).copy()
        text = np.broadcast_to(self._text, (batch_size,) + self._text.shape).copy()
        for _ in range(total):
            yield {"image": image, "text": text}


class SyntheticBatches:
    """Iterator of random batches with the real readers' protocol (``set_epoch``,
    ``num_batches``): uint8 images, normalized on the device by the step."""

    def __init__(self, batch_size: int, num_samples: int = 12800, image_size: int = IMAGE_SIZE,
                 context_length: int = CONTEXT_LENGTH, vocab_size: int = 49408, seed: int = 0,
                 randomized: bool = True, with_semantic: int = 0):
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.image_size = image_size
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.seed = seed
        self.randomized = randomized
        self.with_semantic = with_semantic
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    @property
    def num_batches(self):
        return self.num_samples // self.batch_size

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        rng = np.random.default_rng([self.seed, self.epoch])
        if not self.randomized:
            ds = SyntheticDataset(self.batch_size, self.image_size,
                                  context_length=self.context_length)
            yield from ds.batches(self.batch_size, steps=self.num_batches)
            return
        b, v = self.batch_size, self.vocab_size
        for _ in range(self.num_batches):
            batch = {
                "image": rng.integers(0, 256, (b, self.image_size, self.image_size, 3),
                                      dtype=np.uint8),
                "text": np.concatenate([
                    np.full((b, 1), v - 2, np.int32),
                    rng.integers(1, v - 3, (b, self.context_length - 2), dtype=np.int32),
                    np.full((b, 1), v - 1, np.int32),
                ], axis=1),
            }
            if self.with_semantic:
                sem = rng.standard_normal((b, self.with_semantic)).astype(np.float32)
                batch["semantic"] = sem / np.linalg.norm(sem, axis=1, keepdims=True)
            yield batch
