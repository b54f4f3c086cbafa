"""The port's synthetic data path against the JAX package's: ``SyntheticBatches`` bit for
bit (the same numpy stream from ``default_rng([seed, epoch])``: uint8 images, BOS/EOT-framed
tokens, the optional unit-norm ``semantic`` field, and the fixed-image form), the
``build_dataset`` dispatch, the hashing semantic encoder bit for bit, and the device feed
(``prefetch_to_device``, ``DataInfo``, ``background``). Exact comparisons throughout."""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.data.datasets import build_dataset
from multimodal_tpu_torch.data.pipeline import DataInfo, background, prefetch_to_device
from multimodal_tpu_torch.data.semantic import HashingSemanticEncoder, make_semantic_encoder
from multimodal_tpu_torch.data.synthetic import SyntheticBatches, SyntheticDataset

CASES = [  # SyntheticBatches kwargs
    dict(batch_size=4, num_samples=12, image_size=32, context_length=77, vocab_size=49408),
    dict(batch_size=3, num_samples=10, image_size=16, context_length=20, vocab_size=500,
         seed=5, with_semantic=24),
    dict(batch_size=2, num_samples=6, image_size=8, context_length=16, vocab_size=300,
         randomized=False),
]


def _stream(src, epoch):
    src.set_epoch(epoch)
    return list(src)


@pytest.mark.parametrize("kw", CASES)
@pytest.mark.parametrize("epoch", [0, 3])
def test_synthetic_batches_are_the_references_bit_for_bit(kw, epoch):
    from multimodal_tpu.data.synthetic import SyntheticBatches as JaxBatches

    got, want = _stream(SyntheticBatches(**kw), epoch), _stream(JaxBatches(**kw), epoch)
    assert len(got) == len(want) == kw["num_samples"] // kw["batch_size"]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if kw.get("randomized", True):
        b = got[0]["text"]
        v = kw["vocab_size"]
        assert (b[:, 0] == v - 2).all() and (b[:, -1] == v - 1).all()
        assert got[0]["image"].dtype == np.uint8


def test_epochs_differ_and_replay():
    src = SyntheticBatches(batch_size=2, num_samples=4, image_size=8, context_length=8,
                           vocab_size=100)
    a, b, a2 = _stream(src, 0), _stream(src, 1), _stream(src, 0)
    assert not np.array_equal(a[0]["image"], b[0]["image"])
    np.testing.assert_array_equal(a[1]["text"], a2[1]["text"])


def test_synthetic_dataset_is_the_references():
    from multimodal_tpu.data.synthetic import SyntheticDataset as JaxDataset

    got, want = SyntheticDataset(5, 16, context_length=12), JaxDataset(5, 16, context_length=12)
    assert len(got) == 5
    np.testing.assert_array_equal(got[0]["image"], want[0]["image"])
    np.testing.assert_array_equal(got[0]["text"], want[0]["text"])
    with pytest.raises(IndexError):
        got[5]


def test_build_dataset_synthetic_only():
    from multimodal_tpu.data.datasets import build_dataset as jax_build

    kw = dict(image_size=8, context_length=8, vocab_size=50, num_samples=6)
    got = build_dataset("synthetic", path="", batch_size=2, seed=9, **kw)
    want = jax_build("synthetic", path="", batch_size=2, seed=9, **kw)
    assert got.seed == want.seed == 0  # the stream's seed comes from kw, as in the reference
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
    # the real-data types build their readers (tests/test_torch_readers.py holds them to the
    # reference's); a missing file-list root fails as the reference's does
    from multimodal_tpu_torch.data.wds import WdsReader

    assert isinstance(build_dataset("webdataset", path="/x-{0..1}.tar", batch_size=2), WdsReader)
    for kind in ("coco", "laion", "cood", "csv"):
        with pytest.raises(FileNotFoundError):
            build_dataset(kind, path="/x", batch_size=2)
        with pytest.raises(FileNotFoundError):
            jax_build(kind, path="/x", batch_size=2)
    with pytest.raises(ValueError, match="unknown dataset_type"):
        build_dataset("parquet", path="/x", batch_size=2)


def test_hashing_encoder_is_the_references_bit_for_bit():
    from multimodal_tpu.data.semantic import HashingSemanticEncoder as JaxEncoder

    texts = ["a photo of a cat", "a photo of a dog", "two dogs in the snow", "", "Cat's toy!"]
    for dim, ngrams in ((256, 2), (64, 3)):
        got = HashingSemanticEncoder(dim, ngrams)(texts)
        np.testing.assert_array_equal(got, JaxEncoder(dim, ngrams)(texts))
    assert isinstance(make_semantic_encoder(None), HashingSemanticEncoder)
    with pytest.raises(FileNotFoundError, match="all-mpnet-base-v2"):  # no hashing fallback
        make_semantic_encoder("/models/all-mpnet-base-v2", device="cpu")


def test_prefetch_to_device_preserves_the_stream_on_the_cpu():
    src = SyntheticBatches(batch_size=3, num_samples=15, image_size=8, context_length=8,
                           vocab_size=64, with_semantic=4)
    want = list(src)
    got = list(prefetch_to_device(src, "cpu", depth=2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_datainfo_plumbs_the_epoch_and_size():
    src = SyntheticBatches(batch_size=2, num_samples=6, image_size=8, context_length=8,
                           vocab_size=64)
    info = DataInfo(src, "cpu")
    assert info.num_batches == 3
    info.set_epoch(4)
    assert src.epoch == 4
    src4 = SyntheticBatches(batch_size=2, num_samples=6, image_size=8, context_length=8,
                            vocab_size=64)
    src4.set_epoch(4)
    np.testing.assert_array_equal(next(iter(info))["image"].numpy(), next(iter(src4))["image"])


def test_background_runs_ahead_and_stops_early():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    it = background(gen(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert len(produced) < 100


@pytest.mark.cuda
def test_prefetch_to_device_on_the_card_pins_and_holds_the_host_buffers():
    """On a CUDA target every batch crosses from pinned memory; the pinned tensors of a
    batch live until the consumer asks for the next batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import gc
    import weakref

    import multimodal_tpu_torch.data.pipeline as pipeline

    pinned = []
    real = pipeline._host_tensors

    def recording(batch, pin):
        host = real(batch, pin)
        pinned.append({k: weakref.ref(v) for k, v in host.items()})
        assert all(v.is_pinned() for v in host.values())
        return host

    pipeline._host_tensors = recording
    try:
        src = SyntheticBatches(batch_size=4, num_samples=40, image_size=32, context_length=16,
                               vocab_size=100)
        want = list(src)
        it = prefetch_to_device(src, "cuda", depth=2)
        for i, w in enumerate(want):
            g = next(it)
            gc.collect()
            assert all(r() is not None for r in pinned[i].values()), i  # held
            if i >= 1:
                assert all(r() is None for r in pinned[i - 1].values()), i  # released
            np.testing.assert_array_equal(g["image"].cpu().numpy(), w["image"])
            assert g["image"].device.type == "cuda"
    finally:
        pipeline._host_tensors = real
