"""Dataset adapters: webdataset shards, COCO, LAION, COOD, CSV, Flickr30K and labeled image
folders, local-file based, iterator-style (port of ``multimodal_tpu/data/datasets.py``).

Counterparts of the reference dataset layer:
  * CocoDataset (Datasets/coco.py:26-102): parse captions_{split}.json, image_id -> file map,
    per-item decode + tokenize, collate to [B,·,·,3] + [B,77];
  * CC12mDataset (Datasets/cc12m.py): webdataset shards — served here by WdsReader;
  * LaionDataset (Datasets/laion.py:22-78): images/ dir + captions.json;
  * CoodDataset (Datasets/cood.py:18-70): folder-per-class, caption = class-folder name;
  * CsvDataset (AlignCLIP/main/data.py:29-54): separator/img_key/caption_key.

Nothing here downloads: each adapter documents the on-disk layout it expects. All adapters
yield the same static-shape batch dict as WdsReader: {'image': uint8 [B,S,S,3] on the decode's
device, 'text': int32 [B,77]} (normalization runs on the device). ``build_dataset`` with
``num_workers > 1`` runs that many shard-disjoint webdataset readers through
``InterleavedReaders``."""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from multimodal_tpu_torch.data import preprocess
from multimodal_tpu_torch.data.augment import parse_aug_cfg
from multimodal_tpu_torch.data.tokenizer import CONTEXT_LENGTH
from multimodal_tpu_torch.data.wds import WdsReader, collate, decode_images, on_own_stream

DATASET_TYPES = ("webdataset", "coco", "laion", "cood", "csv", "synthetic")


class FileListDataset:
    """Common engine: (image_path, caption) pairs -> shuffled, decoded, tokenized batches."""

    def __init__(
        self,
        items: Sequence[tuple[str, str]],
        *,
        batch_size: int,
        train: bool = True,
        image_size: int = preprocess.IMAGE_SIZE,
        context_length: int = CONTEXT_LENGTH,
        seed: int = 0,
        drop_last: bool = True,
        num_hosts: int = 1,
        host_id: int = 0,
        semantic_encoder=None,
        aug_cfg=None,
        device="cuda",
    ):
        self.items = list(items)[host_id::num_hosts]
        self.batch_size = batch_size
        self.train = train
        self.image_size = image_size
        self.context_length = context_length
        self.seed = seed
        self.drop_last = drop_last
        self.semantic_encoder = semantic_encoder
        self.aug = parse_aug_cfg(aug_cfg) if train else None
        self.device = torch.device(device)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.items)

    @property
    def num_batches(self):
        n = len(self.items) // self.batch_size
        if not self.drop_last and len(self.items) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng([self.seed, self.epoch])
        order = rng.permutation(len(self.items)) if self.train else np.arange(len(self.items))
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            paths, texts = zip(*(self.items[i] for i in idx))
            buffers = []
            for p in paths:
                try:
                    with open(p, "rb") as f:
                        buffers.append(f.read())
                except OSError:
                    buffers.append(b"")
            batch = collate(buffers, list(texts), rng, image_size=self.image_size,
                            train=self.train, aug=self.aug, context_length=self.context_length,
                            semantic_encoder=self.semantic_encoder, device=self.device)
            if batch is not None:  # static shape: backfilled (see wds.WdsReader)
                yield batch


def coco_captions(root: str, split: str = "train", year: str = "2017",
                  ann_path: str | None = None) -> list[tuple[str, str]]:
    """Parse COCO ``annotations/captions_{split}{year}.json`` into (image_path, caption)
    pairs — one pair per annotation (Datasets/coco.py:40-80 keeps all captions).

    Layout: root/{split}{year}/*.jpg + root/annotations/captions_{split}{year}.json;
    ann_path overrides the annotation file location (CLI --ms-coco-annot)."""
    ann_path = ann_path or os.path.join(root, "annotations", f"captions_{split}{year}.json")
    with open(ann_path) as f:
        ann = json.load(f)
    id_to_file = {
        img["id"]: os.path.join(root, f"{split}{year}", img["file_name"])
        for img in ann["images"]
    }
    return [
        (id_to_file[a["image_id"]], a["caption"])
        for a in ann["annotations"]
        if a["image_id"] in id_to_file
    ]


def laion_items(root: str) -> list[tuple[str, str]]:
    """LAION as materialized by the reference downloader (Datasets/laion.py:80-128):
    root/images/{i}.jpg + root/captions.json (a list or dict of captions)."""
    with open(os.path.join(root, "captions.json")) as f:
        captions = json.load(f)
    if isinstance(captions, dict):
        pairs = [(os.path.join(root, "images", k), v) for k, v in captions.items()]
    else:
        pairs = [
            (os.path.join(root, "images", f"{i}.jpg"), c) for i, c in enumerate(captions)
        ]
    return [(p, c) for p, c in pairs if os.path.exists(p)]


def cood_items(root: str) -> list[tuple[str, str]]:
    """COOD (ImageNet-AO OOD) layout: root/<class name>/*.jpg, caption = folder name
    (Datasets/cood.py:18-70)."""
    items = []
    for cls in sorted(os.listdir(root)):
        cls_dir = os.path.join(root, cls)
        if not os.path.isdir(cls_dir):
            continue
        for fn in sorted(os.listdir(cls_dir)):
            if fn.lower().endswith((".jpg", ".jpeg", ".png", ".webp")):
                items.append((os.path.join(cls_dir, fn), cls.replace("_", " ")))
    return items


def csv_items(
    path: str,
    img_key: str = "filepath",
    caption_key: str = "title",
    sep: str = "\t",
) -> list[tuple[str, str]]:
    """CSV/TSV dataset (main/data.py:29-54 CsvDataset): img_key/caption_key columns."""
    import csv

    items = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f, delimiter=sep):
            items.append((row[img_key], row[caption_key]))
    return items


def build_dataset(
    dataset_type: str,
    *,
    path: str,
    batch_size: int,
    train: bool = True,
    seed: int = 0,
    num_hosts: int = 1,
    host_id: int = 0,
    num_workers: int = 1,
    worker_id: int = 0,
    **kw,
):
    """Dispatcher (reference get_data, main/data.py:711-768). dataset_type:
    'webdataset' | 'coco' | 'laion' | 'cood' | 'csv' | 'synthetic'. As in the reference, the
    synthetic stream takes its seed from ``kw`` (default 0), not from ``seed``."""
    if dataset_type == "webdataset":
        def reader(wid, nw):
            return WdsReader(
                path,
                batch_size=batch_size,
                train=train,
                seed=seed,
                num_hosts=num_hosts,
                host_id=host_id,
                num_workers=nw,
                worker_id=wid,
                **kw,
            )

        if num_workers > 1:
            # N dataloader workers (reference data.py:467-469): shard-disjoint readers
            # drained concurrently — parallel tar read + decode across threads
            from multimodal_tpu_torch.data.pipeline import InterleavedReaders

            return InterleavedReaders([reader(w, num_workers)
                                       for w in range(num_workers)])
        return reader(worker_id, num_workers)
    if dataset_type == "synthetic":
        from multimodal_tpu_torch.data.synthetic import SyntheticBatches

        return SyntheticBatches(batch_size=batch_size, **kw)
    if dataset_type == "coco":
        items = coco_captions(path, **{k: kw.pop(k) for k in ("split", "year") if k in kw})
    elif dataset_type == "laion":
        items = laion_items(path)
    elif dataset_type == "cood":
        items = cood_items(path)
    elif dataset_type == "csv":
        items = csv_items(
            path, **{k: kw.pop(k) for k in ("img_key", "caption_key", "sep") if k in kw}
        )
    else:
        raise ValueError(f"unknown dataset_type {dataset_type!r}")
    return FileListDataset(
        items,
        batch_size=batch_size,
        train=train,
        seed=seed,
        num_hosts=num_hosts,
        host_id=host_id,
        **kw,
    )


class LabeledImageFolder:
    """Folder-per-class eval set -> (uint8 images [B,S,S,3] on ``device``, int labels [B])
    batches.

    The zero-shot/linear-probe input format (torchvision ImageFolder semantics used by the
    reference's eval sets, main/data.py:123-257). Class order is the sorted folder names."""

    def __init__(
        self,
        root: str,
        *,
        batch_size: int,
        image_size: int = preprocess.IMAGE_SIZE,
        num_hosts: int = 1,
        host_id: int = 0,
        limit: Optional[int] = None,
        device="cuda",
    ):
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.items = []
        for label, cls in enumerate(self.classes):
            cls_dir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cls_dir)):
                if fn.lower().endswith((".jpg", ".jpeg", ".png", ".webp")):
                    self.items.append((os.path.join(cls_dir, fn), label))
        self.items = self.items[host_id::num_hosts]
        if limit:
            self.items = self.items[:limit]
        self.batch_size = batch_size
        self.image_size = image_size
        self.device = torch.device(device)

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        rng = np.random.default_rng(0)
        for start in range(0, len(self.items), self.batch_size):
            chunk = self.items[start : start + self.batch_size]
            buffers = []
            for p, _ in chunk:
                try:
                    with open(p, "rb") as f:
                        buffers.append(f.read())
                except OSError:
                    buffers.append(b"")
            labels = np.asarray([label for _, label in chunk], np.int32)
            arr, labels = on_own_stream(self.device, self._decode, buffers, labels, rng)
            if len(labels):
                yield arr, labels

    def _decode(self, buffers, labels, rng):
        arr, ok = decode_images(buffers, self.image_size, train=False, rng=rng,
                                device=self.device)
        if not ok.all():  # drop undecodable eval images (no backfill: labels matter)
            arr, labels = arr[torch.from_numpy(ok).to(arr.device)], labels[ok]
        return arr, labels


def flickr_items(root: str, token_path: str | None = None) -> list[tuple[str, str]]:
    """Flickr30K layout: root/flickr30k-images/*.jpg + root/results_20130124.token
    ('image.jpg#N<TAB>caption' per line — the standard karpathy-style token file used by
    the reference's Flickr retrieval set, main/data.py:673-708). token_path overrides the
    token-file location (CLI --flickr-annot)."""
    if token_path is None:
        for cand in ("results_20130124.token", "results.token", "captions.token"):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                token_path = p
                break
    if token_path is None:
        raise FileNotFoundError(f"no Flickr token file under {root}")
    img_dir = os.path.join(root, "flickr30k-images")
    if not os.path.isdir(img_dir):
        img_dir = root
    items = []
    with open(token_path, encoding="utf-8") as f:
        for line in f:
            if "\t" not in line:
                continue
            key, caption = line.rstrip("\n").split("\t", 1)
            fname = key.split("#", 1)[0]
            items.append((os.path.join(img_dir, fname), caption))
    return items
