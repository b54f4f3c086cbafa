"""The card's JPEG decode: nvJPEG at full size, then the host pipeline's bicubic resample and
crop as a hand-written kernel pair (``ops/csrc/resample.cu``).

The host decode (``native/jpeg_pipeline.cc``, libjpeg) decodes at a reduced DCT scale where it
can and resamples the crop box with PIL's bicubic (a = -0.5, widened by in/out when
downscaling, taps clamped to the image and renormalised). On the card nvJPEG decodes each
image whole into a device arena; ``resample_batch`` resamples the same source box
(``native.bindings.crop_boxes``: the eval centre crop, or the seeded RandomResizedCrop from the
full image's dimensions) with the same weights. The two decoders differ where the host's DCT
scaling or its train path's fast IDCT moves a pixel, so the card's output is held to the host's
within the bound for two decoders of the same crop; the kernel is held to its plain version on
the same decoded image within one uint8 step.

``contribs`` computes an axis's taps and weights on the host (float64, as the host pipeline
does, stored as float32); the kernel and ``resample_reference`` read the same weights. On a
CUDA tensor ``resample_batch`` launches the kernel pair (one launch count per call); on a CPU
tensor it runs ``resample_reference`` per image.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from multimodal_tpu_torch.ops import launches

launches.register("resample")

DESC_FIELDS = 12  # resample.cu's per-image descriptor (int64)
MAX_PIXELS = 1 << 28  # larger headers are refused (the host path then takes the image)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel, a = -0.5 (PIL's BICUBIC), in float64."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def contribs(out_size: int, box0: float, box1: float, in_size: int):
    """The taps of one axis: resampling [box0, box1) of an ``in_size`` axis to ``out_size``
    (the host pipeline's ``compute_contribs``). Returns (first [out] int32, count [out] int32,
    weights float32 [out, kmax]); taps clamp to the full axis [0, in_size)."""
    scale = (box1 - box0) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    kmax = int(math.ceil(support)) * 2 + 1
    center = box0 + (np.arange(out_size) + 0.5) * scale
    first = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    last = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size)
    j = first[:, None] + np.arange(kmax)[None, :]
    w = np.where(j < last[:, None], _bicubic((j - center[:, None] + 0.5) / filterscale), 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), 0.0)
    count = np.maximum(last - first, 0)
    return first.astype(np.int32), count.astype(np.int32), w.astype(np.float32)


def _dense(first, count, weights, in_size: int, device) -> torch.Tensor:
    """float32 [out, in_size] matrix of one axis's taps."""
    out = np.zeros((len(first), in_size), np.float32)
    for i, (f, c) in enumerate(zip(first, count)):
        out[i, f:f + c] = weights[i, :c]
    return torch.from_numpy(out).to(device)


def resample_reference(image: torch.Tensor, box, size: int) -> torch.Tensor:
    """Plain version of the kernel pair: uint8 [H, W, 3] -> uint8 [size, size, 3], the source
    box (x0, y0, x1, y1) resampled as two float32 products and rounded as the host does."""
    h, w, _ = image.shape
    x0, y0, x1, y1 = (float(v) for v in box)
    wx = _dense(*contribs(size, x0, x1, w), w, image.device)
    wy = _dense(*contribs(size, y0, y1, h), h, image.device)
    tmp = torch.einsum("xw,hwc->hxc", wx, image.to(torch.float32))
    out = torch.einsum("yh,hxc->yxc", wy, tmp)
    return torch.clamp(out + 0.5, 0.0, 255.0).to(torch.uint8)


def _check(arena, dims, offsets, boxes, ok, size):
    n = len(ok)
    if arena.dtype != torch.uint8 or arena.dim() != 1:
        raise ValueError(f"the arena is a flat uint8 tensor, got {arena.dtype} "
                         f"{tuple(arena.shape)}")
    if dims.shape != (n, 2) or offsets.shape != (n,) or boxes.shape != (n, 4) or size < 1:
        raise ValueError(f"dims [n, 2], offsets [n] and boxes [n, 4] for n={n} images, got "
                         f"{dims.shape}, {offsets.shape}, {boxes.shape}; size {size}")
    ends = offsets + dims[:, 0].astype(np.int64) * dims[:, 1] * 3
    if ok.any() and (offsets[ok].min() < 0 or ends[ok].max() > arena.numel()):
        raise ValueError("an image lies outside the arena")


def plan(dims, offsets, boxes, ok, size: int) -> dict:
    """The kernel pair's host-side inputs for a batch: per-image descriptors, the taps and
    weights of both axes (``contribs``), the tmp layout, and the work they describe (``taps``:
    multiply-adds of both passes; ``read_bytes``: the bytes of the rows and columns that the
    taps touch, each image's tapped rectangle read once)."""
    n = len(ok)
    desc = np.zeros((n, DESC_FIELDS), np.int64)
    bx = np.zeros((n, size, 2), np.int32)
    by = np.zeros((n, size, 2), np.int32)
    wx_parts, wy_parts = [], []
    wx_off = wy_off = tmp_off = 0
    max_rows = taps = read_bytes = 0
    for i in np.flatnonzero(ok):
        h, w = int(dims[i, 0]), int(dims[i, 1])
        fx, cx, wxi = contribs(size, boxes[i, 0], boxes[i, 2], w)
        fy, cy, wyi = contribs(size, boxes[i, 1], boxes[i, 3], h)
        y_lo = max(int(fy.min()), 0)
        rows = max(min(int((fy + cy).max()), h) - y_lo, 0)
        cols = max(min(int((fx + cx).max()), w) - max(int(fx.min()), 0), 0)
        desc[i] = (offsets[i], h, w, tmp_off, y_lo, rows, wx_off, wxi.shape[1], wy_off,
                   wyi.shape[1], 1, 0)
        bx[i, :, 0], bx[i, :, 1] = fx, cx
        by[i, :, 0], by[i, :, 1] = fy, cy
        wx_parts.append(wxi.ravel())
        wy_parts.append(wyi.ravel())
        wx_off += wxi.size
        wy_off += wyi.size
        tmp_off += rows * size * 3
        max_rows = max(max_rows, rows)
        taps += 3 * (rows * int(cx.sum()) + size * int(cy.sum()))
        read_bytes += rows * cols * 3
    empty = np.zeros(1, np.float32)
    return {"n": n, "size": size, "desc": desc, "bx": bx, "by": by,
            "wx": np.concatenate(wx_parts) if wx_parts else empty,
            "wy": np.concatenate(wy_parts) if wy_parts else empty,
            "tmp_floats": max(tmp_off, 1), "max_rows": max_rows, "taps": taps,
            "read_bytes": read_bytes}


def to_device(host_plan: dict, device) -> dict:
    """``plan``'s arrays on ``device``, with the tmp scratch and the output allocated."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    n, size = host_plan["n"], host_plan["size"]
    return {**host_plan, **{k: put(host_plan[k]) for k in ("desc", "bx", "by", "wx", "wy")},
            "tmp": torch.empty(host_plan["tmp_floats"], dtype=torch.float32, device=device),
            "out": torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)}


def launch(arena: torch.Tensor, dev_plan: dict) -> torch.Tensor:
    """One launch of the kernel pair over a ``to_device`` plan (counted as one ``resample``
    launch); its output tensor."""
    from multimodal_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(arena.device):
        err = lib.mmt_resample(arena.data_ptr(), dev_plan["desc"].data_ptr(),
                               dev_plan["wx"].data_ptr(), dev_plan["bx"].data_ptr(),
                               dev_plan["wy"].data_ptr(), dev_plan["by"].data_ptr(),
                               dev_plan["tmp"].data_ptr(), dev_plan["out"].data_ptr(),
                               dev_plan["n"], dev_plan["size"], dev_plan["max_rows"],
                               torch.cuda.current_stream(arena.device).cuda_stream)
    _build.check(lib, err, "resample launch")
    launches.count("resample")
    return dev_plan["out"]


def resample_batch(arena: torch.Tensor, dims: np.ndarray, offsets: np.ndarray,
                   boxes: np.ndarray, ok: np.ndarray, size: int) -> torch.Tensor:
    """Images packed in ``arena`` (flat uint8; image i is [dims[i, 0], dims[i, 1], 3] at byte
    ``offsets[i]``) -> uint8 [n, size, size, 3] on the arena's device: each ``ok`` image's
    source box ``boxes[i]`` (x0, y0, x1, y1) resampled, the others black. On a CUDA tensor the
    kernel pair (a build or launch error raises); on a CPU tensor the plain version."""
    dims = np.asarray(dims, np.int64).reshape(-1, 2)
    offsets = np.asarray(offsets, np.int64)
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    ok = np.asarray(ok, bool)
    _check(arena, dims, offsets, boxes, ok, size)
    if len(ok) == 0:
        return torch.zeros((0, size, size, 3), dtype=torch.uint8, device=arena.device)
    if arena.is_cuda:
        return launch(arena, to_device(plan(dims, offsets, boxes, ok, size), arena.device))
    if arena.device.type != "cpu":
        raise ValueError(f"resample_batch runs on cuda or cpu tensors, not {arena.device}")
    out = torch.zeros((len(ok), size, size, 3), dtype=torch.uint8)
    for i in np.flatnonzero(ok):
        h, w = int(dims[i, 0]), int(dims[i, 1])
        image = arena[offsets[i]:offsets[i] + h * w * 3].view(h, w, 3)
        out[i] = resample_reference(image, boxes[i], size)
    return out


def _blob(buffers):
    offsets = np.zeros(len(buffers) + 1, np.int64)
    for i, b in enumerate(buffers):
        offsets[i + 1] = offsets[i] + len(b)
    return b"".join(buffers), offsets


def decode_full(buffers: list[bytes], device, num_threads: int | None = None):
    """nvJPEG: JPEG bytes -> (flat uint8 arena on ``device``, dims int64 [n, 2], byte offsets
    [n], ok [n] bool). Image i, where ok, is its full-size RGB [h, w, 3] at its offset; a
    header or decode nvJPEG refuses comes back not ok."""
    from multimodal_tpu_torch.ops import _build

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG decodes onto a CUDA device, not {device}")
    lib = _build.load()
    n = len(buffers)
    blob, offsets = _blob(buffers)
    dims = np.zeros((n, 2), np.int32)
    ok = np.zeros(n, np.uint8)
    if n:
        _build.check(lib, lib.mmt_jpeg_dims(blob, offsets.ctypes.data, n, dims.ctypes.data,
                                            ok.ctypes.data), "nvJPEG header read")
    pixels = dims[:, 0].astype(np.int64) * dims[:, 1]
    ok &= (pixels <= MAX_PIXELS).astype(np.uint8)
    sizes = np.where(ok.astype(bool), pixels * 3, 0)
    arena_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64) if n else sizes
    arena = torch.empty(max(int(sizes.sum()), 1), dtype=torch.uint8, device=device)
    if ok.any():
        threads = num_threads or min(os.cpu_count() or 8, 16)
        with torch.cuda.device(device):
            err = lib.mmt_jpeg_decode(blob, offsets.ctypes.data, n, arena.data_ptr(),
                                      arena_off.ctypes.data, dims.ctypes.data, ok.ctypes.data,
                                      threads, device.index if device.index is not None
                                      else torch.cuda.current_device(),
                                      torch.cuda.current_stream(device).cuda_stream)
        _build.check(lib, err, "nvJPEG decode")
    return arena, dims.astype(np.int64), arena_off, ok.astype(bool)


def decode_jpegs(buffers: list[bytes], image_size: int, train: bool,
                 seeds: np.ndarray | None = None, scale=(0.9, 1.0),
                 ratio=(3.0 / 4.0, 4.0 / 3.0), device="cuda", num_threads: int | None = None):
    """The card's form of ``native.bindings.decode_batch``: JPEG bytes -> (uint8 [N, S, S, 3]
    on ``device``, ok [N] bool). nvJPEG decodes each image whole; the eval centre crop or the
    train RandomResizedCrop (from ``seeds``, one per buffer) is resampled by the kernel pair.
    Failed decodes come back black with ok=False."""
    from multimodal_tpu_torch.native import bindings as native

    arena, dims, arena_off, ok = decode_full(buffers, device, num_threads)
    boxes = np.zeros((len(buffers), 4), np.float64)
    if ok.any():
        if train and seeds is None:
            raise ValueError("a train decode needs its per-sample crop seeds")
        boxes[ok] = native.crop_boxes(dims[ok], image_size, train,
                                      np.asarray(seeds)[ok] if train else None, scale, ratio)
    return resample_batch(arena, dims, arena_off, boxes, ok, image_size), ok
