"""The port's stock-layout eval sets against the JAX package's readers on the same files, built
in ``tmp_path`` as ``tests/test_eval_sets.py`` builds them (CIFAR-10/100 pickle batches,
Food-101, Flowers-102 and Stanford Cars .mat files, a folder-per-class set): the same
classes, the same labels and the same uint8 pixels, bit for bit (on the CPU both decode
JPEGs with the same host pipeline), and the same dispatch of ``open_eval_dataset``."""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from multimodal_tpu.data import eval_sets as ref
from multimodal_tpu_torch.data import eval_sets as port

torch.set_num_threads(1)


def _jpg(path, seed, size=(40, 52)):
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.random.default_rng(seed).integers(0, 256, (*size, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path, quality=90)


def _batches(ds):
    images, labels = [], []
    for im, lab in ds:
        images.append(im.cpu().numpy() if isinstance(im, torch.Tensor) else np.asarray(im))
        labels.append(np.asarray(lab))
    return np.concatenate(images), np.concatenate(labels)


def _same(got, want):
    assert list(got.classes) == list(want.classes)
    assert len(got) == len(want)
    gi, gl = _batches(got)
    wi, wl = _batches(want)
    assert gi.dtype == np.uint8 and gl.dtype == wl.dtype == np.int32
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gi, wi)


@pytest.fixture
def cifar(tmp_path):
    rng = np.random.default_rng(0)
    d10 = tmp_path / "c10" / "cifar-10-batches-py"
    d10.mkdir(parents=True)
    data = rng.integers(0, 255, (20, 3072), dtype=np.uint8)
    labels = list(rng.integers(0, 10, 20))
    with open(d10 / "test_batch", "wb") as f:
        pickle.dump({"data": data, "labels": labels}, f)
    for i in range(1, 6):
        with open(d10 / f"data_batch_{i}", "wb") as f:
            pickle.dump({"data": data[2 * i:2 * i + 3], "labels": labels[2 * i:2 * i + 3]}, f)
    with open(d10 / "batches.meta", "wb") as f:
        pickle.dump({"label_names": [f"class{i}" for i in range(10)]}, f)
    d100 = tmp_path / "c100" / "cifar-100-python"
    d100.mkdir(parents=True)
    with open(d100 / "test", "wb") as f:
        pickle.dump({"data": data[:6], "fine_labels": [0, 5, 99, 1, 2, 3]}, f)
    with open(d100 / "train", "wb") as f:
        pickle.dump({"data": data[6:9], "fine_labels": [7, 8, 9]}, f)
    with open(d100 / "meta", "wb") as f:
        pickle.dump({"fine_label_names": [f"f{i}" for i in range(100)]}, f)
    return str(tmp_path / "c10"), str(tmp_path / "c100")


@pytest.mark.parametrize("version,split,size", [("10", "test", 32), ("10", "train", 48),
                                                ("100", "test", 24), ("100", "train", 32)])
def test_cifar_batches_equal_the_reference(cifar, version, split, size):
    root = cifar[0] if version == "10" else cifar[1]
    _same(port.cifar_batches(root, version, split, batch_size=7, image_size=size),
          ref.cifar_batches(root, version, split, batch_size=7, image_size=size))


def test_food101_equals_the_reference(tmp_path):
    d = tmp_path / "food-101"
    (d / "meta").mkdir(parents=True)
    (d / "meta" / "classes.txt").write_text("apple_pie\nbaby_back_ribs\nwaffles\n")
    rel = ["apple_pie/1", "waffles/2", "waffles/3", "baby_back_ribs/4"]
    (d / "meta" / "test.txt").write_text("\n".join(rel) + "\n")
    for i, r in enumerate(rel):
        _jpg(str(d / "images" / (r + ".jpg")), i)
    kw = dict(batch_size=3, image_size=32)
    _same(port.food101(str(tmp_path), "test", device="cpu", **kw),
          ref.food101(str(tmp_path), "test", **kw))


def _flowers(tmp_path):
    from scipy.io import savemat

    d = tmp_path / "flowers-102"
    (d / "jpg").mkdir(parents=True)
    savemat(str(d / "imagelabels.mat"), {"labels": np.arange(1, 9)[None, :]})
    savemat(str(d / "setid.mat"), {"trnid": np.array([[1, 2]]), "valid": np.array([[3, 4]]),
                                   "tstid": np.array([[5, 6, 7, 8]])})
    for i in range(1, 9):
        _jpg(str(d / "jpg" / f"image_{i:05d}.jpg"), i)
    return str(tmp_path)


@pytest.mark.parametrize("split", ["test", "train", "val"])
def test_flowers102_equals_the_reference(tmp_path, split):
    root = _flowers(tmp_path)
    kw = dict(batch_size=3, image_size=32)
    _same(port.flowers102(root, split, device="cpu", **kw), ref.flowers102(root, split, **kw))


def test_stanford_cars_equals_the_reference(tmp_path):
    from scipy.io import savemat

    d = tmp_path / "stanford_cars"
    (d / "cars_test").mkdir(parents=True)
    (d / "devkit").mkdir()
    fnames = ["00001.jpg", "00002.jpg", "00003.jpg"]
    annos = np.array([(np.array([f]), np.array([[c]])) for f, c in zip(fnames, [3, 196, 1])],
                     dtype=[("fname", "O"), ("class", "O")])
    savemat(str(d / "cars_test_annos_withlabels.mat"), {"annotations": annos[None, :]})
    savemat(str(d / "devkit" / "cars_meta.mat"),
            {"class_names": np.array([np.array([f"car {i}"]) for i in range(1, 197)],
                                     dtype="O")[None, :]})
    for i, f in enumerate(fnames):
        _jpg(str(d / "cars_test" / f), i)
    kw = dict(batch_size=2, image_size=32)
    _same(port.stanford_cars(str(tmp_path), "test", device="cpu", **kw),
          ref.stanford_cars(str(tmp_path), "test", **kw))


def test_open_eval_dataset_dispatch_equals_the_reference(cifar, tmp_path):
    kw = dict(batch_size=8, image_size=32)
    got = port.open_eval_dataset("cifar10", cifar[0], device="cpu", **kw)
    assert type(got).__name__ == "ArrayEvalDataset"
    _same(got, ref.open_eval_dataset("cifar10", cifar[0], **kw))
    folder = tmp_path / "folders"
    for c, cls in enumerate(["a", "b"]):
        for i in range(3):
            _jpg(str(folder / cls / f"{i}.jpg"), 10 * c + i)
    got = port.open_eval_dataset("cifar10", str(folder), device="cpu", **kw)
    assert type(got).__name__ == "LabeledImageFolder"
    _same(got, ref.open_eval_dataset("cifar10", str(folder), **kw))
    assert port._is_native("cifar100", cifar[1]) and not port._is_native("cifar10", cifar[1])


def test_linear_probe_reads_a_stock_layout(cifar, tmp_path):
    """The reference reads every linear-probe path as folder-per-class; the port takes the
    stock layout it finds (CIFAR's train split is the five data batches)."""
    got = port.open_eval_dataset("linear_probe", cifar[0], batch_size=8, image_size=32,
                                 split="train", device="cpu")
    _same(got, ref.cifar_batches(cifar[0], "10", "train", batch_size=8, image_size=32))


def test_missing_scipy_raises_naming_it(tmp_path, monkeypatch):
    root = _flowers(tmp_path)
    monkeypatch.setitem(sys.modules, "scipy.io", None)
    with pytest.raises(ImportError, match="scipy"):
        port.flowers102(root, "test", batch_size=2, image_size=32, device="cpu")
