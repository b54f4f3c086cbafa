"""ctypes bindings for the port's native input pipeline (port of
``multimodal_tpu/native/bindings.py``: ``decode_batch``, ``is_jpeg``, ``tar_index``).

Two shared libraries, built with g++ at first use into ``native/_build_cache/`` (git-ignored):

- ``host``: ``tar_index.cc`` (the tar shard scanner) and ``crop_boxes.cc`` (the crop
  geometry of the card's decode). Needs only the C++ standard library.
- ``jpeg``: ``jpeg_pipeline.cc``, the batched libjpeg decode with the PIL-compatible bicubic
  resample and the crop, linked with ``-ljpeg``. The host (CPU) decode path.

They are two because a machine may have a compiler and no libjpeg headers: the tar index and
the crop geometry still build there, and its JPEGs decode on the GPU (``ops/resample.py``).
Each library is named by a digest of its sources, its flags, the compiler and the CPU it was
built on (``-march=native``), built in a temporary directory and moved into place with
``os.replace`` under a file lock, so concurrent processes never load a partial file. A library that does not build raises with the compiler's output; nothing falls
back to another decoder or to Python's ``tarfile`` (the tar index's plain version, used by the
tests only).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build_cache")
CXX = "g++"
# the reference's Makefile flags: the CPU tests hold both builds bit for bit, and other flags
# can move where the compiler contracts to FMA
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-march=native")
HEADERS = ("crop_geometry.h",)
LIBRARIES = {  # name -> (sources, link flags)
    "host": (("tar_index.cc", "crop_boxes.cc"), ()),
    "jpeg": (("jpeg_pipeline.cc",), ("-ljpeg", "-lpthread")),
}
DEFAULT_SCALE = (0.9, 1.0)
DEFAULT_RATIO = (3.0 / 4.0, 4.0 / 3.0)

_lock = threading.Lock()
_libs: dict = {}


def _machine_tag() -> bytes:
    """What ``-march=native`` and the compiler make of the sources where they build: the CPU's
    model and flags and the compiler's version."""
    tag = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"model name", b"flags")):
                    tag += line
                if tag.count(b"\n") >= 2:
                    break
    except OSError:
        pass
    try:
        tag += subprocess.run([CXX, "--version"], capture_output=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        tag += repr(e).encode()
    return tag


def library_path(name: str) -> str:
    sources, link = LIBRARIES[name]
    digest = hashlib.sha256(" ".join(CXX_FLAGS + link).encode() + _machine_tag())
    for src in sources + HEADERS:
        with open(os.path.join(_HERE, src), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libmmt_{name}_{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile library ``name`` if the one for its digest is missing; its path. A failed
    build raises ``RuntimeError`` with the compiler's output."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources, link = LIBRARIES[name]
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build per library, whatever the processes
        if os.path.isfile(out):
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            lib = os.path.join(tmp, "lib.so")
            cmd = [CXX, *CXX_FLAGS, "-o", lib, *(os.path.join(_HERE, s) for s in sources),
                   *link]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"the native data library {name!r} did not build: "
                                   f"{' '.join(cmd)}: {e!r}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"the native data library {name!r} did not build "
                                   f"({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(lib, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Library ``name``, built on first call, every entry's argument types declared."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = ctypes.CDLL(build(name))
        i32, i64, f64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
        if name == "host":
            lib.mm_tar_index.restype = ptr
            lib.mm_tar_index.argtypes = [ctypes.c_char_p, ctypes.POINTER(i64)]
            lib.mm_free.restype = None
            lib.mm_free.argtypes = [ptr]
            lib.mm_crop_boxes.restype = None
            lib.mm_crop_boxes.argtypes = [ptr, i32, i32, i32, ptr, f64, f64, f64, f64, ptr]
        else:
            # blob, offsets [n+1], n, size, mode, seeds (nullable), out, ok flags, threads
            common = [ptr, ctypes.POINTER(i64), i32, i32, i32, ctypes.POINTER(ctypes.c_uint64),
                      ptr, ptr, i32]
            lib.mm_decode_batch.restype = i32
            lib.mm_decode_batch.argtypes = common
            lib.mm_decode_batch_aug.restype = i32
            lib.mm_decode_batch_aug.argtypes = common + [f64] * 4  # scale lo/hi, ratio lo/hi
            lib.mm_is_jpeg.restype = i32
            lib.mm_is_jpeg.argtypes = [ctypes.c_char_p, i64]
        _libs[name] = lib
        return lib


def decode_batch(
    buffers: list[bytes],
    image_size: int = 224,
    train: bool = False,
    seeds: np.ndarray | None = None,
    num_threads: int | None = None,
    scale: tuple[float, float] = DEFAULT_SCALE,
    ratio: tuple[float, float] = DEFAULT_RATIO,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of JPEG byte strings on the host -> (images [N,S,S,3] uint8, ok [N]
    bool).

    Failed decodes come back as black frames with ok=False. Non-JPEG inputs fail here; route
    them through the PIL path with ``is_jpeg`` first. ``scale``/``ratio`` set the train
    RandomResizedCrop bounds. A train batch needs its per-sample ``seeds`` (the caller's
    generator draws them; nothing here draws unseeded numbers)."""
    lib = load("jpeg")
    n = len(buffers)
    offsets = np.zeros(n + 1, np.int64)
    for i, b in enumerate(buffers):
        offsets[i + 1] = offsets[i] + len(b)
    blob = b"".join(buffers)
    out = np.empty((n, image_size, image_size, 3), np.uint8)
    ok = np.empty(n, np.uint8)
    if train:
        if seeds is None:
            raise ValueError("a train decode needs its per-sample crop seeds")
        seeds = np.ascontiguousarray(seeds, np.uint64)
        seeds_p = seeds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    else:
        seeds_p = None
    threads = num_threads or min(os.cpu_count() or 8, 16)
    common = (blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, image_size,
              1 if train else 0, seeds_p, out.ctypes.data_as(ctypes.c_void_p),
              ok.ctypes.data_as(ctypes.c_void_p), threads)
    if tuple(scale) == DEFAULT_SCALE and tuple(ratio) == DEFAULT_RATIO:
        lib.mm_decode_batch(*common)
    else:
        lib.mm_decode_batch_aug(*common, scale[0], scale[1], ratio[0], ratio[1])
    return out, ok.astype(bool)


def is_jpeg(data: bytes) -> bool:
    """Is this buffer a JPEG the native paths take (the reference's ``mm_is_jpeg``)? PNG,
    webp and the rest go to the PIL path."""
    return len(data) > 3 and data[:3] == b"\xff\xd8\xff"


def tar_index(path: str) -> list[tuple[str, int, int]]:
    """Scan a tar shard -> [(member_name, payload_offset, size)] for regular files."""
    lib = load("host")
    out_len = ctypes.c_int64(0)
    ptr = lib.mm_tar_index(path.encode(), ctypes.byref(out_len))
    if not ptr:
        raise FileNotFoundError(path)
    try:
        raw = ctypes.string_at(ptr, out_len.value).decode("utf-8", errors="replace")
    finally:
        lib.mm_free(ptr)
    entries = []
    for line in raw.splitlines():
        name, off, size = line.rsplit("\t", 2)
        entries.append((name, int(off), int(size)))
    return entries


def crop_boxes(dims: np.ndarray, image_size: int, train: bool,
               seeds: np.ndarray | None = None, scale=DEFAULT_SCALE,
               ratio=DEFAULT_RATIO) -> np.ndarray:
    """dims int [N, 2] (height, width) -> float64 [N, 4] resample source boxes (x0, y0, x1,
    y1): the eval centre crop, or the train RandomResizedCrop from ``seeds``, as the host
    decode draws them from the full image's dimensions."""
    lib = load("host")
    dims = np.ascontiguousarray(dims, np.int32).reshape(-1, 2)
    n = dims.shape[0]
    if (dims <= 0).any():
        raise ValueError(f"image dimensions must be positive, got {dims[(dims <= 0).any(1)]}")
    boxes = np.empty((n, 4), np.float64)
    if train:
        if seeds is None:
            raise ValueError("train crop boxes need their per-sample seeds")
        seeds = np.ascontiguousarray(seeds, np.uint64)
    lib.mm_crop_boxes(dims.ctypes.data, n, image_size, 1 if train else 0,
                      seeds.ctypes.data if train else None, scale[0], scale[1], ratio[0],
                      ratio[1], boxes.ctypes.data)
    return boxes
