"""The card's JPEG decode (``ops/resample.py``: nvJPEG, then the resample kernel pair of
``ops/csrc/resample.cu``) on a CUDA device: the kernel against its plain version on the same
decoded images within one uint8 step, at the shapes of the input path (the fixture's 128-px
shapes JPEGs to 224 and 128 px, its 96-1100 px photos to 64 and 224 px), a second launch the
same bits and one launch count per batch; the card's ``decode_images`` against the committed
host-pipeline outputs (mean |diff| < 3 and correlation > 0.99 per image, the bound for two
decoders of the same crop); garbage and truncated input absorbed; the decode waits for none of
the work queued on the caller's stream; the wire upsample on the card against the CPU. Every
test needs a CUDA device and skips without one; nothing here imports JAX.

    python -m pytest tests/test_torch_resample_cuda.py -m cuda
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.data.wds import decode_images, iter_tar_samples
from multimodal_tpu_torch.native import bindings as native
from multimodal_tpu_torch.ops import launches
from multimodal_tpu_torch.ops import resample as rs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_shards")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (nvJPEG and the resample kernel have no CPU mode)")
    return torch.device("cuda")


def _buffers(name):
    return [s.get("jpg", s.get("png")) for s in iter_tar_samples(os.path.join(DATA, name))]


@pytest.mark.cuda
@pytest.mark.parametrize("shard,size,train", [
    ("train-000000.tar", 224, True), ("train-000000.tar", 128, True),
    ("train-000000.tar", 224, False), ("photos-000000.tar", 64, True),
    ("photos-000000.tar", 64, False), ("photos-000000.tar", 224, True),
])
def test_resample_kernel_matches_its_plain_version(cuda_device, shard, size, train):
    bufs = [b for b in _buffers(shard) if native.is_jpeg(b)]
    arena, dims, off, ok = rs.decode_full(bufs, cuda_device)
    seeds = np.arange(len(bufs), dtype=np.uint64) * 7919
    boxes = np.zeros((len(bufs), 4))
    boxes[ok] = native.crop_boxes(dims[ok], size, train, seeds[ok] if train else None)
    launches.reset_launch_counts()
    got = rs.resample_batch(arena, dims, off, boxes, ok, size)
    again = rs.resample_batch(arena, dims, off, boxes, ok, size)
    assert launches.launch_counts()["resample"] == 2
    assert torch.equal(got, again)
    for i in range(len(bufs)):
        if not ok[i]:
            assert (got[i] == 0).all()
            continue
        image = arena[off[i]:off[i] + dims[i, 0] * dims[i, 1] * 3].view(int(dims[i, 0]),
                                                                         int(dims[i, 1]), 3)
        want = rs.resample_reference(image, boxes[i], size)
        assert int((got[i].int() - want.int()).abs().max()) <= 1, i


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_card_decode_holds_the_committed_host_outputs(cuda_device, mode):
    with open(os.path.join(DATA, "photos.json")) as f:
        meta = json.load(f)
    bufs = _buffers("photos-000000.tar")
    want = np.load(os.path.join(DATA, f"expected_{mode}64.npy"))
    kw = ({"seeds": np.arange(len(bufs), dtype=np.uint64), "rng": np.random.default_rng(0)}
          if mode == "train" else {})
    out, ok = decode_images(bufs, 64, mode == "train", device=cuda_device, **kw)
    assert out.is_cuda and out.shape == (len(bufs), 64, 64, 3)
    got = out.cpu().numpy()
    corrupt = ~np.array(meta[f"ok_{mode}"])
    assert not ok[corrupt].any()
    for i in np.flatnonzero(ok):
        g, w = got[i].astype(np.float64).ravel(), want[i].astype(np.float64).ravel()
        assert np.abs(g - w).mean() < 3.0, i
        assert np.corrcoef(g, w)[0, 1] > 0.99, i


@pytest.mark.cuda
def test_card_decode_absorbs_garbage_and_truncation(cuda_device):
    whole = _buffers("val-000000.tar")[0]
    rng = np.random.default_rng(0)
    bufs = [b"\xff\xd8\xff" + rng.integers(0, 256, 600, dtype=np.uint8).tobytes(),
            b"\xff\xd8garbage", whole[:40], whole]
    out, ok = rs.decode_jpegs(bufs, 32, False, device=cuda_device)
    assert ok[-1] and not ok[:3].any()
    assert (out[:3] == 0).all() and out.shape == (4, 32, 32, 3)
    empty, none = rs.decode_jpegs([], 32, False, device=cuda_device)
    assert empty.shape == (0, 32, 32, 3) and none.shape == (0,)


def _spin_caller_stream(ms: float):
    """Queue about ``ms`` of spinning on the current stream."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    torch.cuda._sleep(int(ms * 10**7 / start.elapsed_time(end)))


@pytest.mark.cuda
def test_card_decode_waits_for_none_of_the_callers_stream(cuda_device):
    """With a second of work queued on the caller's stream, ``decode_images`` and a reader's
    ``collate`` return on the host long before it ends; their outputs, read on the caller's
    stream after it, are the unloaded decode's."""
    from multimodal_tpu_torch.data.wds import collate

    bufs = _buffers("val-000000.tar")[:32]
    want, want_ok = decode_images(bufs, 64, False, device=cuda_device)
    kw = dict(image_size=64, train=False, aug=None, context_length=77, semantic_encoder=None,
              device=cuda_device)
    want_batch = collate(bufs, ["a"] * len(bufs), np.random.default_rng(0), **kw)
    torch.cuda.synchronize()
    _spin_caller_stream(1000.0)
    t0 = time.perf_counter()
    got, ok = decode_images(bufs, 64, False, device=cuda_device)
    batch = collate(bufs, ["a"] * len(bufs), np.random.default_rng(0), **kw)
    host_ms = (time.perf_counter() - t0) * 1e3
    assert not torch.cuda.current_stream().query()  # the spinning is still queued
    assert host_ms < 500.0
    assert torch.equal(got, want) and np.array_equal(ok, want_ok)
    assert torch.equal(batch["image"], want_batch["image"])


@pytest.mark.cuda
def test_wire_upsample_on_the_card_matches_the_cpu(cuda_device):
    from multimodal_tpu_torch.data.resize import bicubic

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 128, 128, 3),
                                                                  dtype=np.float32))
    want = bicubic(x, 224)
    got = bicubic(x.to(cuda_device), 224).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
