"""The port's native input pipeline (``multimodal_tpu_torch.native``: its own copies of
``tar_index.cc`` and ``jpeg_pipeline.cc``, built with g++) against the JAX package's library,
bit for bit: the tar index (and ``tarfile``, its plain version), ``decode_batch`` and
``decode_images`` in eval and train, on the fast and the exact train path, with non-default
crop bounds, on corrupt, truncated and garbage input; the PIL path; the committed fixture; and
the host side of the card's decode (crop boxes, the resample kernel's plain version)."""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_tpu.data import wds as jax_wds
from multimodal_tpu.native import bindings as jax_native
from multimodal_tpu_torch.data import wds
from multimodal_tpu_torch.native import bindings as native
from multimodal_tpu_torch.ops import resample as rs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_shards")


def _photo(h, w, seed, quality=90):
    from multimodal_tpu.data.bench_pipeline import _natural_image

    arr = _natural_image(np.random.default_rng(seed), max(h, w))[:h, :w]
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(arr)).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture(scope="module")
def photos():
    samples = list(wds.iter_tar_samples(os.path.join(DATA, "photos-000000.tar")))
    return [s.get("jpg", s.get("png")) for s in samples]


@pytest.fixture(scope="module")
def hard_inputs():
    """Garbage, garbage behind a JPEG marker, truncated JPEGs, an empty buffer and intact
    photos of odd sizes."""
    rng = np.random.default_rng(0)
    whole = _photo(90, 130, 1)
    bufs = [rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
            b"\xff\xd8\xff" + rng.integers(0, 256, 500, dtype=np.uint8).tobytes(),
            b"\xff\xd8garbage-after-soi", b""]
    bufs += [whole[: len(whole) // d] for d in (2, 3, 9)]
    bufs += [whole, _photo(77, 301, 2), _photo(640, 400, 3), _photo(33, 33, 4)]
    return bufs


@pytest.mark.parametrize("name", ["train-000000.tar", "val-000000.tar", "photos-000000.tar"])
def test_tar_index_matches_jax_and_tarfile(name):
    path = os.path.join(DATA, name)
    got = native.tar_index(path)
    with tarfile.open(path) as tar:
        want = [(m.name, m.offset_data, m.size) for m in tar if m.isreg()]
    assert got == want == jax_native.tar_index(path)


def test_tar_index_fuzz_and_truncation_match_jax(tmp_path):
    garbage = tmp_path / "garbage.tar"
    garbage.write_bytes(np.random.default_rng(2).integers(0, 256, 4096, dtype=np.uint8).tobytes())
    assert native.tar_index(str(garbage)) == jax_native.tar_index(str(garbage))
    real = tmp_path / "real.tar"
    with tarfile.open(real, "w") as tar:
        for name, payload in (("a.txt", b"x" * 1000), ("dir/b.jpg", b"y" * 3000)):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    data = real.read_bytes()
    for cut in (len(data) // 2, 700, 2000):
        trunc = tmp_path / f"trunc{cut}.tar"
        trunc.write_bytes(data[:cut])
        got = native.tar_index(str(trunc))
        assert got == jax_native.tar_index(str(trunc))
        assert [n for n, _, _ in got][:1] == ["a.txt"]
    for mod in (native, jax_native):
        with pytest.raises(FileNotFoundError):
            mod.tar_index(str(tmp_path / "missing.tar"))


def test_iter_tar_samples_matches_jax_on_truncated_shard(tmp_path):
    data = open(os.path.join(DATA, "val-000000.tar"), "rb").read()
    trunc = tmp_path / "t.tar"
    trunc.write_bytes(data[: len(data) // 3])
    got = list(wds.iter_tar_samples(str(trunc)))
    assert got == list(jax_wds.iter_tar_samples(str(trunc)))
    assert got and list(wds.iter_tar_samples(str(tmp_path / "missing.tar"))) == []


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("fast", ["1", "0"])
@pytest.mark.parametrize("bounds", [{}, {"scale": (0.3, 0.8), "ratio": (0.5, 2.0)}])
def test_decode_batch_matches_jax_bit_for_bit(monkeypatch, hard_inputs, train, fast, bounds):
    monkeypatch.setenv("MMTPU_TRAIN_FAST_DECODE", fast)
    jpegs = [b for b in hard_inputs if b]
    seeds = np.arange(7, 7 + len(jpegs), dtype=np.uint64)
    for size in (32, 64):
        got, ok = native.decode_batch(jpegs, size, train=train, seeds=seeds, **bounds)
        want, want_ok = jax_native.decode_batch(jpegs, size, train=train, seeds=seeds, **bounds)
        np.testing.assert_array_equal(ok, want_ok)
        np.testing.assert_array_equal(got, want)
    assert ok[-4:].all() and not ok[:3].any()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("fast", ["1", "0"])
def test_decode_images_matches_jax_bit_for_bit(monkeypatch, photos, hard_inputs, train, fast):
    """JPEGs through the native batch, the PNG and the failures through PIL (the generator
    shared between the PIL crops and the seeds, as in the reference)."""
    monkeypatch.setenv("MMTPU_TRAIN_FAST_DECODE", fast)
    bufs = photos + hard_inputs
    got_rng, want_rng = np.random.default_rng(3), np.random.default_rng(3)
    got, ok = wds.decode_images(bufs, 48, train, rng=got_rng, device="cpu")
    want, want_ok = jax_wds.decode_images(bufs, 48, train, rng=want_rng)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_rng.integers(2**62) == want_rng.integers(2**62)


def test_pil_path_matches_jax_pil_fallback(photos):
    png = photos[-1]
    assert png[:4] == b"\x89PNG" and not native.is_jpeg(png)
    for train in (False, True):
        for size in (40, 64):
            got = wds._pil_fallback(png, size, train, np.random.default_rng(1))
            want = jax_wds._pil_fallback(png, size, train, np.random.default_rng(1))
            np.testing.assert_array_equal(got, want)
    assert wds._pil_fallback(b"not an image", 32, False, np.random.default_rng(0)) is None


def test_is_jpeg_matches_jax(hard_inputs, photos):
    for b in hard_inputs + photos + [b"\xff\xd8\xff"]:
        assert native.is_jpeg(b) == jax_native.is_jpeg(b)


def test_train_decode_needs_its_seeds(photos):
    with pytest.raises(ValueError, match="seeds"):
        native.decode_batch(photos[:2], 32, train=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        wds.decode_images(photos[:2], 32, False, device="meta")


def test_committed_fixture_is_the_jax_decode():
    """tests/torch_make_data_fixture.py's expected arrays, regenerated from the JAX package,
    equal the committed ones."""
    import torch_make_data_fixture as fixture

    with open(os.path.join(DATA, "photos.json")) as f:
        meta = json.load(f)
    samples = list(wds.iter_tar_samples(os.path.join(DATA, "photos-000000.tar")))
    assert [s["__key__"] for s in samples] == meta["keys"]
    members = fixture.photo_members()
    assert [m[1] for m in members] == [s.get("jpg", s.get("png")) for s in samples]
    exp = fixture.expected([m[1] for m in members])
    for mode in ("eval", "train"):
        np.testing.assert_array_equal(exp[mode], np.load(os.path.join(DATA, f"expected_{mode}64.npy")))
        assert exp[f"ok_{mode}"].tolist() == meta[f"ok_{mode}"]


def test_missing_library_raises_with_the_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DMMT_NO_SUCH_FLAG",
                                                                 "-include", "no_such_header.h"))
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="did not build.*no_such_header"):
        native.load("jpeg")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not build"):
        native.build("host")


def _full_decode(bufs):
    """Full-size RGB decode (PIL, libjpeg-turbo's default path, as the exact host path's
    full-scale decode) packed into an arena, as nvJPEG leaves it on the card."""
    imgs = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in bufs]
    dims = np.array([i.shape[:2] for i in imgs], np.int64)
    sizes = dims[:, 0] * dims[:, 1] * 3
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return torch.from_numpy(np.concatenate([i.ravel() for i in imgs])), dims, offsets


@pytest.mark.parametrize("train", [False, True])
def test_card_decode_geometry_matches_the_exact_host_path(monkeypatch, train):
    """The card's decode on the host: a full decode, ``crop_boxes`` and the resample kernel's
    plain version give the exact host path's pixels within one step where the host decodes
    at full scale (sources under twice the output size)."""
    monkeypatch.setenv("MMTPU_TRAIN_FAST_DECODE", "0")
    bufs = [_photo(h, w, s) for s, (h, w) in enumerate([(60, 90), (100, 64), (127, 127),
                                                        (70, 120), (90, 90)])]
    seeds = np.arange(3, 3 + len(bufs), dtype=np.uint64)
    arena, dims, offsets = _full_decode(bufs)
    ok = np.ones(len(bufs), bool)
    boxes = native.crop_boxes(dims, 64, train, seeds if train else None)
    got = rs.resample_batch(arena, dims, offsets, boxes, ok, 64)
    want, want_ok = native.decode_batch(bufs, 64, train=train, seeds=seeds)
    assert want_ok.all()
    assert int((got.numpy().astype(int) - want).__abs__().max()) <= 1


def test_crop_boxes_follow_the_reference_geometry():
    dims = np.array([[480, 640], [640, 480], [100, 100]])
    ev = native.crop_boxes(dims, 224, False)
    for (h, w), box in zip(dims, ev):  # PIL's resize of the shorter side, then the centre
        s = 224 / min(w, h)
        nw, nh = max(round(w * s), 224), max(round(h * s), 224)
        left, top = (nw - 224) // 2, (nh - 224) // 2
        np.testing.assert_allclose(box, [left * w / nw, top * h / nh, (left + 224) * w / nw,
                                         (top + 224) * h / nh], rtol=1e-12)
    np.testing.assert_allclose(ev[2], [0.0, 0.0, 100.0, 100.0])
    seeds = np.array([1, 2, 3], np.uint64)
    tr = native.crop_boxes(dims, 224, True, seeds, scale=(0.5, 1.0))
    np.testing.assert_array_equal(tr, native.crop_boxes(dims, 224, True, seeds, scale=(0.5, 1.0)))
    w, h = tr[:, 2] - tr[:, 0], tr[:, 3] - tr[:, 1]
    area = w * h / (dims[:, 0] * dims[:, 1])
    assert (tr[:, :2] >= 0).all() and (tr[:, 2] <= dims[:, 1]).all() and (tr[:, 3] <= dims[:, 0]).all()
    assert ((area > 0.45) & (area <= 1.0)).all()
    with pytest.raises(ValueError, match="seeds"):
        native.crop_boxes(dims, 224, True)
    with pytest.raises(ValueError, match="positive"):
        native.crop_boxes(np.array([[0, 5]]), 224, False)


def test_resample_batch_plain_version_and_checks():
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in ((20, 30), (9, 40))]
    arena = torch.from_numpy(np.concatenate([i.ravel() for i in imgs]))
    dims = np.array([[20, 30], [9, 40]])
    offsets = np.array([0, 20 * 30 * 3])
    boxes = np.array([[0.0, 0.0, 30.0, 20.0], [5.0, 1.0, 25.0, 8.0]])
    out = rs.resample_batch(arena, dims, offsets, boxes, np.array([True, False]), 16)
    assert out.shape == (2, 16, 16, 3) and (out[1] == 0).all()
    torch.testing.assert_close(out[0], rs.resample_reference(torch.from_numpy(imgs[0]),
                                                             boxes[0], 16))
    # the identity box at the same size is the image itself
    sq = rs.resample_reference(torch.from_numpy(imgs[0][:, :20]), (0, 0, 20, 20), 20)
    assert torch.equal(sq, torch.from_numpy(imgs[0][:, :20]))
    with pytest.raises(ValueError, match="outside the arena"):
        rs.resample_batch(arena, dims, offsets + 10_000, boxes, np.array([True, True]), 16)
    with pytest.raises(ValueError, match="flat uint8"):
        rs.resample_batch(arena.float(), dims, offsets, boxes, np.array([True, True]), 16)
    with pytest.raises(ValueError, match="CUDA device"):
        rs.decode_full([b"x"], "cpu")


def test_contribs_weights_sum_to_one_and_stay_in_range():
    for out, b0, b1, size in ((64, 0.0, 1100.0, 1100), (224, 3.5, 120.25, 128),
                              (16, 10.0, 12.0, 40)):
        first, count, w = rs.contribs(out, b0, b1, size)
        assert (first >= 0).all() and (first + count <= size).all()
        sums = np.array([w[i, :count[i]].sum() for i in range(out)])
        np.testing.assert_allclose(sums, 1.0, atol=1e-5)
