"""A reader that fails mid-epoch fails the run: ``background``, ``InterleavedReaders``,
``prefetch_to_device`` and the training CLI over a file-list dataset raise the reader's own
exception in the consumer's thread (the reference's producers end the stream quietly
instead, ``multimodal_tpu/data/pipeline.py:21-46``), while a clean stream still ends."""

import os
import traceback

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_tpu_torch.data import datasets
from multimodal_tpu_torch.data.pipeline import (
    DataInfo,
    InterleavedReaders,
    background,
    prefetch_to_device,
)

torch.set_num_threads(1)


def _failing(n_good: int, make=lambda i: i):
    for i in range(n_good):
        yield make(i)
    raise OSError(f"shard read failed after {n_good} items")


def test_background_raises_the_readers_exception_with_its_traceback():
    got = []
    with pytest.raises(OSError, match="after 2 items") as info:
        for item in background(_failing(2)):
            got.append(item)
    assert got == [0, 1]
    frames = [f.name for f in traceback.extract_tb(info.value.__traceback__)]
    assert "_failing" in frames  # raised where the reader raised it


def test_clean_streams_still_end():
    assert list(background(iter(range(5)), depth=2)) == [0, 1, 2, 3, 4]
    assert list(InterleavedReaders([[10, 11, 12], [1, 2]])) == [10, 1, 11, 2, 12]
    assert list(background(iter([]))) == []


def test_interleaved_readers_raise_instead_of_dropping_the_worker():
    got = []
    with pytest.raises(OSError, match="after 2 items"):
        for item in InterleavedReaders([[10, 11, 12, 13], _failing(2)]):
            got.append(item)
    assert got == [10, 0, 11, 1, 12]  # the failing worker's turn raises


def test_prefetch_to_device_on_the_cpu_raises_the_readers_exception():
    batch = lambda i: {"image": np.full((2, 4, 4, 3), i, np.uint8),  # noqa: E731
                       "text": np.full((2, 8), i, np.int32)}
    got = []
    with pytest.raises(OSError, match="after 3 items"):
        for b in prefetch_to_device(_failing(3, batch), "cpu", depth=2):
            got.append(int(b["text"][0, 0]))
    # batches staged ahead when the failure arrives are not handed out: a prefix, in order
    assert got == list(range(len(got))) and len(got) <= 3
    with pytest.raises(OSError):
        list(DataInfo(_failing(1, batch), "cpu"))


@pytest.fixture
def folder(tmp_path):
    rng = np.random.default_rng(0)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / "data" / cls)
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(
                tmp_path / "data" / cls / f"{i}.jpg", quality=90)
    return str(tmp_path / "data")


def test_cli_over_a_file_list_dataset_fails_with_the_readers_exception(folder, tmp_path,
                                                                       monkeypatch):
    from multimodal_tpu_torch.train.run import main

    argv = ["--dataset-type", "cood", "--train-data", folder, "--model", "tiny",
            "--batch-size", "4", "--epochs", "1", "--device", "cpu", "--precision", "fp32",
            "--logs", str(tmp_path / "logs"), "--log-every-n-steps", "1"]
    assert main(argv + ["--name", "clean"]) == 0  # 16 images, 4 steps
    real, calls = datasets.collate, []

    def collate_failing_at_the_third_batch(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise OSError("disk read failed mid-epoch")
        return real(*args, **kw)

    monkeypatch.setattr(datasets, "collate", collate_failing_at_the_third_batch)
    with pytest.raises(OSError, match="disk read failed mid-epoch"):
        main(argv + ["--name", "failing"])
    assert not os.path.exists(tmp_path / "logs" / "failing" / "checkpoints" / "4")
