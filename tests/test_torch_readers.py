"""The port's readers against the JAX package's on the committed fixture: ``WdsReader``, the
file-list datasets (COCO, LAION, COOD, CSV, Flickr30K, ``LabeledImageFolder``) and
``InterleavedReaders`` build the same batches bit for bit (uint8 images, int32 tokens, the
semantic field) in train and eval, epochs 0 and 1, with a host split, three workers,
resampled weighted shards, augmentations and the backfill of failed samples."""

import json
import os

import numpy as np
import pytest
import torch

from multimodal_tpu.data import datasets as jax_datasets
from multimodal_tpu.data import wds as jax_wds
from multimodal_tpu.data.semantic import HashingSemanticEncoder as JaxHashing
from multimodal_tpu_torch.data import datasets, wds
from multimodal_tpu_torch.data.pipeline import InterleavedReaders
from multimodal_tpu_torch.data.semantic import HashingSemanticEncoder

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_shards")
TRAIN = os.path.join(DATA, "train-{000000..000001}.tar")
VAL = os.path.join(DATA, "val-000000.tar")
PHOTOS = os.path.join(DATA, "photos-000000.tar")


def _assert_same_stream(got, want, limit=None):
    got, want = list(got)[:limit], list(want)[:limit]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if isinstance(g, tuple):  # LabeledImageFolder: (images, labels)
            assert isinstance(g[0], torch.Tensor)
            np.testing.assert_array_equal(g[0].numpy(), w[0])
            np.testing.assert_array_equal(g[1], w[1])
            continue
        assert sorted(g) == sorted(w)
        assert isinstance(g["image"], torch.Tensor) and g["image"].dtype == torch.uint8
        np.testing.assert_array_equal(g["image"].numpy(), w["image"])
        assert g["text"].dtype == np.int32
        np.testing.assert_array_equal(g["text"], w["text"])
        if "semantic" in g:
            np.testing.assert_array_equal(g["semantic"], w["semantic"])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("epoch", [0, 1])
def test_wds_reader_matches_jax(train, epoch):
    kw = dict(batch_size=24, train=train, image_size=32, context_length=16, seed=5,
              shuffle_buffer=100)
    got = wds.WdsReader(TRAIN, device="cpu", **kw)
    want = jax_wds.WdsReader(TRAIN, **kw)
    got.set_epoch(epoch)
    want.set_epoch(epoch)
    _assert_same_stream(got, want, limit=4)


@pytest.mark.parametrize("options", [
    dict(num_hosts=2, host_id=1),
    dict(resampled=True, weights="3"),
    dict(aug_cfg={"color_jitter": 0.4, "re_prob": 0.5, "hflip": 0.5, "scale": (0.5, 1.0)}),
    dict(caption_key="txt", num_workers=2, worker_id=1),
])
def test_wds_reader_options_match_jax(options):
    kw = dict(batch_size=16, image_size=24, context_length=12, seed=1, shuffle_buffer=50,
              **options)
    _assert_same_stream(wds.WdsReader(TRAIN, device="cpu", **kw), jax_wds.WdsReader(TRAIN, **kw),
                        limit=3)


def test_semantic_field_and_backfill_match_jax():
    """The photo shard holds a corrupt JPEG: it is backfilled from the batch (one draw of
    the reader's generator) in both packages; the PNG goes through PIL."""
    kw = dict(batch_size=6, image_size=32, context_length=16, seed=2, shuffle_buffer=0)
    got = list(wds.WdsReader(PHOTOS, device="cpu", semantic_encoder=HashingSemanticEncoder(32),
                             **kw))
    want = list(jax_wds.WdsReader(PHOTOS, semantic_encoder=JaxHashing(32), **kw))
    _assert_same_stream(got, want)
    assert len(got) == 3 and got[0]["semantic"].shape == (6, 32)


def test_interleaved_three_workers_match_jax():
    kw = dict(path=TRAIN + "::" + VAL, batch_size=16, train=True, seed=3, num_workers=3,
              image_size=24, context_length=12, shuffle_buffer=40)
    got = datasets.build_dataset("webdataset", device="cpu", **kw)
    want = jax_datasets.build_dataset("webdataset", **kw)
    assert isinstance(got, InterleavedReaders) and len(got.readers) == 3
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        _assert_same_stream(got, want)
    assert got.num_batches is None


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """The val shard's 64 shapes JPEGs and captions laid out as every file-list dataset
    expects, plus one unreadable path and the PNG of the photo shard."""
    root = tmp_path_factory.mktemp("lists")
    samples = list(wds.iter_tar_samples(VAL))
    png = [s["png"] for s in wds.iter_tar_samples(PHOTOS) if "png" in s][0]
    items = []
    for i, s in enumerate(samples):
        cap = s["txt"].decode()
        items.append((f"{i:04d}.jpg", s["jpg"], cap))
    items.append(("0064.png", png, "a png image"))
    coco = root / "coco"
    (coco / "train2017").mkdir(parents=True)
    (coco / "annotations").mkdir()
    for name, data, _ in items:
        (coco / "train2017" / name).write_bytes(data)
    ann = {"images": [{"id": i, "file_name": n} for i, (n, _, _) in enumerate(items)]
           + [{"id": 999, "file_name": "missing.jpg"}],
           "annotations": [{"image_id": i, "caption": c} for i, (_, _, c) in enumerate(items)]
           + [{"image_id": 999, "caption": "gone"}]}
    (coco / "annotations" / "captions_train2017.json").write_text(json.dumps(ann))
    laion = root / "laion"
    (laion / "images").mkdir(parents=True)
    for i, (_, data, _) in enumerate(items[:40]):
        (laion / "images" / f"{i}.jpg").write_bytes(data)
    (laion / "captions.json").write_text(json.dumps([c for _, _, c in items[:40]] + ["none"]))
    cood = root / "cood"
    for i, (name, data, cap) in enumerate(items):
        d = cood / cap.split(" on ")[0].replace("a ", "", 1).replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / name).write_bytes(data)
    tsv = root / "data.tsv"
    rows = ["filepath\ttitle"] + [f"{coco / 'train2017' / n}\t{c}" for n, _, c in items]
    tsv.write_text("\n".join(rows) + "\n")
    flickr = root / "flickr"
    (flickr / "flickr30k-images").mkdir(parents=True)
    lines = []
    for n, data, c in items[:30]:
        (flickr / "flickr30k-images" / n).write_bytes(data)
        lines += [f"{n}#0\t{c}", f"{n}#1\tanother {c}"]
    (flickr / "results_20130124.token").write_text("\n".join(lines) + "\n")
    return {"coco": str(coco), "laion": str(laion), "cood": str(cood), "csv": str(tsv),
            "flickr": str(flickr)}


@pytest.mark.parametrize("kind", ["coco", "laion", "cood", "csv"])
@pytest.mark.parametrize("train", [True, False])
def test_file_list_datasets_match_jax(image_tree, kind, train):
    kw = dict(batch_size=12, train=train, seed=4, image_size=32, context_length=16)
    got = datasets.build_dataset(kind, path=image_tree[kind], device="cpu", **kw)
    want = jax_datasets.build_dataset(kind, path=image_tree[kind], **kw)
    assert isinstance(got, datasets.FileListDataset)
    assert len(got) == len(want) and got.num_batches == want.num_batches
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        _assert_same_stream(got, want)


def test_file_list_host_split_semantic_and_aug_match_jax(image_tree):
    items = datasets.coco_captions(image_tree["coco"])
    assert items == jax_datasets.coco_captions(image_tree["coco"])
    kw = dict(batch_size=10, train=True, seed=6, image_size=24, context_length=12,
              num_hosts=2, host_id=1, drop_last=False,
              aug_cfg={"grayscale_prob": 0.5, "re_prob": 0.5, "ratio": (0.5, 2.0)})
    got = datasets.FileListDataset(items, device="cpu", semantic_encoder=HashingSemanticEncoder(16),
                                   **kw)
    want = jax_datasets.FileListDataset(items, semantic_encoder=JaxHashing(16), **kw)
    assert got.num_batches == want.num_batches == 4  # 33 items, the last batch kept
    _assert_same_stream(got, want)


def test_flickr_and_item_parsers_match_jax(image_tree):
    assert datasets.flickr_items(image_tree["flickr"]) == jax_datasets.flickr_items(
        image_tree["flickr"])
    assert datasets.laion_items(image_tree["laion"]) == jax_datasets.laion_items(
        image_tree["laion"])
    assert datasets.cood_items(image_tree["cood"]) == jax_datasets.cood_items(image_tree["cood"])
    assert datasets.csv_items(image_tree["csv"]) == jax_datasets.csv_items(image_tree["csv"])
    items = datasets.flickr_items(image_tree["flickr"])
    kw = dict(batch_size=8, train=False, image_size=32, context_length=16)
    _assert_same_stream(datasets.FileListDataset(items, device="cpu", **kw),
                        jax_datasets.FileListDataset(items, **kw))


def test_labeled_image_folder_matches_jax(image_tree):
    kw = dict(batch_size=16, image_size=32, limit=50)
    got = datasets.LabeledImageFolder(image_tree["cood"], device="cpu", **kw)
    want = jax_datasets.LabeledImageFolder(image_tree["cood"], **kw)
    assert got.classes == want.classes and len(got) == len(want) == 50
    _assert_same_stream(got, want)


def test_unknown_dataset_type_raises_like_jax():
    assert datasets.DATASET_TYPES == ("webdataset", "coco", "laion", "cood", "csv",
                                      "synthetic")
    for mod in (datasets, jax_datasets):
        with pytest.raises(ValueError, match="unknown dataset_type"):
            mod.build_dataset("parquet", path="/x", batch_size=2)


def test_bench_reader_rate_consumes_every_timed_batch():
    """``bench_pipeline._reader_rate`` times the batches after the first and hands each to the
    consumer (stage 6's step in place)."""
    from multimodal_tpu_torch.data import bench_pipeline

    batches = [{"text": np.zeros((4, 77), np.int32), "i": i} for i in range(5)]
    seen = []
    rate, n = bench_pipeline._reader_rate(lambda: iter(batches), "cpu",
                                          lambda b: seen.append(b["i"]))
    assert n == 4 and seen == [1, 2, 3, 4] and rate > 0
    assert bench_pipeline._reader_rate(lambda: iter([]), "cpu") == (None, 0)
