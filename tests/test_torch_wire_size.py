"""The ``--wire-size`` path against the JAX package's: the port's bicubic resize
(``data.resize.bicubic``) against ``jax.image.resize(..., "bicubic")`` (max abs <= 1e-5 x
max|JAX|), ``batch_images`` with and without ``wire_size`` and both of its errors, the train
step with ``wire_size``, and ``Embedder(wire_size=)`` / ``embed_image_bytes`` /
``embed_image_files`` on ``tiny-test`` with JAX's weights carried over by
``load_jax_params`` (atol 2e-4, the port's Embedder parity tolerance)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.inference import Embedder as JaxEmbedder
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.train.engine import batch_images as jax_batch_images
from multimodal_tpu_torch.data import wds
from multimodal_tpu_torch.data.resize import bicubic, weight_matrix
from multimodal_tpu_torch.inference import Embedder
from multimodal_tpu_torch.models import create_model, load_jax_params
from multimodal_tpu_torch.train import make_optimizer, make_train_step
from multimodal_tpu_torch.train.engine import TrainState, batch_images
from torch_jax_models import random_params

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_shards")


@pytest.mark.parametrize("src,dst", [(128, 224), (64, 224), (97, 224), (16, 32), (200, 224)])
def test_bicubic_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(src).standard_normal((3, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, dst, dst, 3), "bicubic"))
    got = bicubic(torch.from_numpy(x), dst)
    assert got.dtype == torch.float32 and got.shape == (3, dst, dst, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_weight_matrix_is_jax_compute_weight_mat():
    from jax._src.image import scale as jax_scale

    for src, dst in ((128, 224), (97, 224), (300, 224), (5, 7)):
        want = np.asarray(jax_scale.compute_weight_mat(
            src, dst, dst / src, 0.0, jax_scale._fill_keys_cubic_kernel, True))
        np.testing.assert_allclose(weight_matrix(src, dst), want, atol=1e-7)
    with pytest.raises(ValueError, match="NHWC"):
        bicubic(torch.zeros(4, 4, 3), 8)


def test_bicubic_builds_each_weight_matrix_once():
    """The device weight matrices are built once per (size, size, antialias, device) and
    reused; a non-square input takes one matrix per axis."""
    from multimodal_tpu_torch.data import resize

    x = torch.from_numpy(np.random.default_rng(0).random((2, 12, 20, 3), np.float32))
    first = bicubic(x, 16)
    hits = resize._device_weights.cache_info().hits
    again = bicubic(x, 16)
    assert resize._device_weights.cache_info().hits == hits + 2
    assert torch.equal(first, again)
    cpu = torch.device("cpu")
    assert resize._device_weights(12, 16, True, cpu) is resize._device_weights(12, 16, True, cpu)
    np.testing.assert_array_equal(resize._device_weights(20, 16, True, cpu).numpy(),
                                  weight_matrix(20, 16))


def test_batch_images_wire_size_matches_jax():
    jm = jax_create_model("tiny-test")
    pm = create_model("tiny-test", device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    got = batch_images({"image": torch.from_numpy(images)}, pm, wire_size=16)
    want = np.asarray(jax_batch_images({"image": images}, jm, wire_size=16))
    assert got.shape == (4, 32, 32, 3)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    full = np.random.default_rng(1).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    np.testing.assert_allclose(  # the model's size passes through, wire_size or not
        batch_images({"image": torch.from_numpy(full)}, pm, wire_size=16).numpy(),
        np.asarray(jax_batch_images({"image": full}, jm, wire_size=16)), atol=1e-6)
    for fn, model, img in ((batch_images, pm, torch.from_numpy(images)),
                           (jax_batch_images, jm, images)):
        with pytest.raises(ValueError, match="pass --wire-size"):
            fn({"image": img}, model)
        with pytest.raises(ValueError, match="--wire-size is 8"):
            fn({"image": img}, model, wire_size=8)


def test_train_step_with_wire_size_matches_the_upsampled_batch():
    """A step on a wire-size batch is the step on the batch upsampled by batch_images."""
    images = np.random.default_rng(2).integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(1, 999, (4, 16)))
    upsampled = batch_images({"image": torch.from_numpy(images)},
                             create_model("tiny-test", device="cpu"), 16)
    losses = []
    for wire, img in ((16, torch.from_numpy(images)), (None, upsampled)):
        model = create_model("tiny-test", device="cpu", seed=0)
        opt = make_optimizer(model.named_parameters(), 1e-3)
        step = make_train_step(model, opt, wire_size=wire)
        metrics = step(TrainState.create(model, opt), {"image": img, "text": tokens})
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all() and abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[1])


@pytest.fixture(scope="module")
def embedders():
    jm = jax_create_model("tiny-test")
    params = random_params(jm)
    pm = load_jax_params(create_model("tiny-test", device="cpu"), params)
    return (Embedder(pm, batch_size=4, wire_size=16),
            JaxEmbedder(jm, params, batch_size=4, wire_size=16))


def test_embedder_wire_size_matches_jax(embedders):
    ours, theirs = embedders
    small = np.random.default_rng(4).integers(0, 256, (5, 16, 16, 3), dtype=np.uint8)
    full = np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    for imgs in (small, full):
        got = ours.embed_images(imgs)
        np.testing.assert_allclose(got, theirs.embed_images(imgs), atol=2e-4)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    odd = np.zeros((2, 20, 20, 3), np.uint8)
    with pytest.raises(ValueError, match="wire_size=20"):
        ours.embed_images(odd)
    with pytest.raises(ValueError, match="wire_size=16"):
        Embedder(ours.model, batch_size=4).embed_images(small)


def test_embed_image_bytes_and_files_match_jax(embedders, tmp_path):
    ours, theirs = embedders
    samples = list(wds.iter_tar_samples(os.path.join(DATA, "photos-000000.tar")))
    bufs = [s.get("jpg", s.get("png")) for s in samples][10:]  # 6 photos, the corrupt, the PNG
    for size in (16, 32):
        got, ok = ours.embed_image_bytes(bufs, image_size=size)
        want, want_ok = theirs.embed_image_bytes(bufs, image_size=size)
        np.testing.assert_array_equal(ok, want_ok)
        assert not ok[-2] and ok[-1] and (got[~ok] == 0).all()
        np.testing.assert_allclose(got, want, atol=2e-4)
    paths = []
    for i, b in enumerate(bufs[:3]):
        paths.append(str(tmp_path / f"{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(b)
    paths.append(str(tmp_path / "missing.jpg"))
    got, ok = ours.embed_image_files(paths, image_size=16)
    want, want_ok = theirs.embed_image_files(paths, image_size=16)
    np.testing.assert_array_equal(ok, [True, True, True, False])
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_allclose(got, want, atol=2e-4)
