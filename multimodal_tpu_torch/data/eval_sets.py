"""The zero-shot and linear-probe eval sets in their stock on-disk layouts, read directly (port
of ``multimodal_tpu/data/eval_sets.py``): the archives torchvision's CIFAR10/CIFAR100,
Food101, Flowers102 and StanfordCars read, parsed with numpy, pickle and ``scipy.io``, and
batched as ``LabeledImageFolder`` batches them: (uint8 images [B, S, S, 3], int32 labels
[B]) with a ``.classes`` list, so every consumer (zero-shot, linear probe) takes either.

Formats:
  * CIFAR-10/100: the python pickle batches (``cifar-10-batches-py/test_batch``,
    ``cifar-100-python/test``), rows of R/G/B planes; resized on the host with the eval
    transform (bicubic shorter side, center crop) and yielded as numpy;
  * Food-101: ``images/<class>/<id>.jpg`` and ``meta/{classes,test,train}.txt``;
  * Flowers-102: ``jpg/image_XXXXX.jpg``, ``imagelabels.mat`` and ``setid.mat``;
  * Stanford Cars: ``cars_test/``, ``cars_test_annos_withlabels.mat`` and, when present, the
    devkit's ``cars_meta.mat`` for the class names.

The image files decode on ``device`` (``data.wds.decode_images``: on the GPU nvJPEG and the
resample kernel) and their batches are tensors there. ``scipy`` (Flowers, Cars) is imported
where it is read, and an ``ImportError`` names it where it is missing.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from multimodal_tpu_torch.data import preprocess
from multimodal_tpu_torch.data.datasets import LabeledImageFolder


def _loadmat(path: str) -> dict:
    try:
        from scipy.io import loadmat
    except ImportError as e:
        raise ImportError(f"reading {os.path.basename(path)} (a Flowers-102 or Stanford Cars "
                          "eval set) needs the 'scipy' package, which is not installed") from e
    return loadmat(path)


class FileEvalDataset(LabeledImageFolder):
    """(path, label) items -> (uint8 [B, S, S, 3] on ``device``, int32 [B]) batches:
    ``LabeledImageFolder``'s batches over an explicit item list and class table. Images that
    do not decode are dropped with their labels."""

    def __init__(self, items, classes, *, batch_size: int,
                 image_size: int = preprocess.IMAGE_SIZE, limit: Optional[int] = None,
                 device="cuda"):
        self.items = items[:limit] if limit else items
        self.classes = list(classes)
        self.batch_size = batch_size
        self.image_size = image_size
        self.device = torch.device(device)


class ArrayEvalDataset:
    """In-memory uint8 [N, H, W, 3] images and labels, resized per batch on the host with the
    eval transform (bicubic shorter-side resize, center crop); numpy batches."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, classes, *, batch_size: int,
                 image_size: int = preprocess.IMAGE_SIZE, limit: Optional[int] = None):
        if limit:
            images, labels = images[:limit], labels[:limit]
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.classes = list(classes)
        self.batch_size = batch_size
        self.image_size = image_size

    def __len__(self):
        return len(self.images)

    def __iter__(self):
        from PIL import Image

        s = self.image_size
        for start in range(0, len(self.images), self.batch_size):
            chunk = self.images[start : start + self.batch_size]
            out = np.empty((len(chunk), s, s, 3), np.uint8)
            for i, arr in enumerate(chunk):
                img = preprocess._resize_shorter(Image.fromarray(arr), s)
                out[i] = preprocess._center_crop(np.asarray(img, np.uint8), s)
            yield out, self.labels[start : start + len(chunk)]


def _find_dir(root: str, name: str) -> str:
    """``root`` may be the directory itself or its parent (torchvision's root convention)."""
    if os.path.basename(os.path.normpath(root)) == name:
        return root
    cand = os.path.join(root, name)
    return cand if os.path.isdir(cand) else root


def _unpickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def cifar_batches(root: str, version: str = "10", split: str = "test", *, batch_size: int,
                  image_size: int = preprocess.IMAGE_SIZE,
                  limit: Optional[int] = None) -> ArrayEvalDataset:
    """The CIFAR python pickle batches: rows of 3072 uint8, R/G/B 32x32 planes."""
    if version == "10":
        d = _find_dir(root, "cifar-10-batches-py")
        files = [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
        label_key, meta_file, names_key = "labels", "batches.meta", "label_names"
    elif version == "100":
        d = _find_dir(root, "cifar-100-python")
        files = ["train"] if split == "train" else ["test"]
        label_key, meta_file, names_key = "fine_labels", "meta", "fine_label_names"
    else:
        raise ValueError(version)
    data, labels = [], []
    for fn in files:
        batch = _unpickle(os.path.join(d, fn))
        data.append(np.asarray(batch["data"], np.uint8))
        labels.extend(batch[label_key])
    images = np.concatenate(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    classes = _unpickle(os.path.join(d, meta_file))[names_key]
    return ArrayEvalDataset(images, np.asarray(labels), classes, batch_size=batch_size,
                            image_size=image_size, limit=limit)


def food101(root: str, split: str = "test", *, batch_size: int,
            image_size: int = preprocess.IMAGE_SIZE, limit: Optional[int] = None,
            device="cuda") -> FileEvalDataset:
    """Food-101: images/<class>/<id>.jpg and meta/{classes,test,train}.txt."""
    d = _find_dir(root, "food-101")
    with open(os.path.join(d, "meta", "classes.txt")) as f:
        classes = [line.strip() for line in f if line.strip()]
    index = {c: i for i, c in enumerate(classes)}
    items = []
    with open(os.path.join(d, "meta", f"{split}.txt")) as f:
        for line in f:
            rel = line.strip()
            if rel:
                items.append((os.path.join(d, "images", rel + ".jpg"), index[rel.split("/", 1)[0]]))
    return FileEvalDataset(items, [c.replace("_", " ") for c in classes], batch_size=batch_size,
                           image_size=image_size, limit=limit, device=device)


def flowers102(root: str, split: str = "test", *, batch_size: int,
               image_size: int = preprocess.IMAGE_SIZE, limit: Optional[int] = None,
               device="cuda") -> FileEvalDataset:
    """Flowers-102: jpg/image_%05d.jpg, imagelabels.mat and setid.mat (1-indexed ids and
    labels, as torchvision's Flowers102 reads them)."""
    from multimodal_tpu_torch.eval.metadata import classnames

    d = _find_dir(root, "flowers-102")
    labels = _loadmat(os.path.join(d, "imagelabels.mat"))["labels"].ravel()  # 1..102
    setid = _loadmat(os.path.join(d, "setid.mat"))
    ids = setid[{"train": "trnid", "val": "valid", "test": "tstid"}[split]].ravel()
    items = [(os.path.join(d, "jpg", f"image_{i:05d}.jpg"), int(labels[i - 1]) - 1) for i in ids]
    return FileEvalDataset(items, classnames("flowers102"), batch_size=batch_size,
                           image_size=image_size, limit=limit, device=device)


def stanford_cars(root: str, split: str = "test", *, batch_size: int,
                  image_size: int = preprocess.IMAGE_SIZE, limit: Optional[int] = None,
                  device="cuda") -> FileEvalDataset:
    """Stanford Cars devkit layout: cars_{split}/, the annotations .mat (fields fname and
    class, 1-indexed) and devkit/cars_meta.mat's class names when present."""
    from multimodal_tpu_torch.eval.metadata import classnames

    d = _find_dir(root, "stanford_cars")
    if split == "test":
        annos_path = os.path.join(d, "cars_test_annos_withlabels.mat")
        img_dir = os.path.join(d, "cars_test")
    else:
        annos_path = os.path.join(d, "devkit", "cars_train_annos.mat")
        img_dir = os.path.join(d, "cars_train")
    annos = _loadmat(annos_path)["annotations"].ravel()
    items = [(os.path.join(img_dir, str(a["fname"].item())), int(a["class"].item()) - 1)
             for a in annos]
    meta = os.path.join(d, "devkit", "cars_meta.mat")
    if os.path.exists(meta):
        classes = [str(c.item()) for c in _loadmat(meta)["class_names"].ravel()]
    else:
        classes = classnames("stanford-cars")
    return FileEvalDataset(items, classes, batch_size=batch_size, image_size=image_size,
                           limit=limit, device=device)


# per-flag stock-layout markers: (the directory name torchvision uses, the files that prove
# the layout)
_NATIVE_MARKERS = {
    "cifar10": ("cifar-10-batches-py", ("test_batch",)),
    "cifar100": ("cifar-100-python", ("test", "meta")),
    "food": ("food-101", ("meta/classes.txt",)),
    "flowers": ("flowers-102", ("imagelabels.mat", "setid.mat")),
    "stanford_cars": ("stanford_cars", ("cars_test_annos_withlabels.mat",)),
}


def _is_native(flag: str, path: str) -> bool:
    if flag not in _NATIVE_MARKERS:
        return False
    dirname, rels = _NATIVE_MARKERS[flag]
    d = _find_dir(path, dirname)
    return all(os.path.exists(os.path.join(d, *r.split("/"))) for r in rels)


def open_eval_dataset(flag: str, path: str, *, batch_size: int,
                      image_size: int = preprocess.IMAGE_SIZE, split: str = "test",
                      limit: Optional[int] = None, device="cuda"):
    """An eval set's path -> its stock-layout reader when the layout is there, else a
    folder-per-class ``LabeledImageFolder``. ``flag`` is the CLI's dataset key
    (``train.run.ZERO_SHOT_DATASETS``); ``"linear_probe"`` takes any stock layout it finds
    (the reference reads every linear-probe path as folder-per-class)."""
    kw = dict(batch_size=batch_size, image_size=image_size, limit=limit)
    if flag == "linear_probe":
        flag = next((f for f in _NATIVE_MARKERS if _is_native(f, path)), flag)
    if _is_native(flag, path):
        if flag == "cifar10":
            return cifar_batches(path, "10", split, **kw)
        if flag == "cifar100":
            return cifar_batches(path, "100", split, **kw)
        if flag == "food":
            return food101(path, split, device=device, **kw)
        if flag == "flowers":
            return flowers102(path, "test" if split == "val" else split, device=device, **kw)
        if flag == "stanford_cars":
            return stanford_cars(path, split, device=device, **kw)
    return LabeledImageFolder(path, device=device, **kw)
