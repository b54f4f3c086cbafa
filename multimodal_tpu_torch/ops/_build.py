"""Build and load the port's CUDA kernels at first use.

The sources under ``ops/csrc`` have a plain C interface and are compiled by ``nvcc`` into
one shared library, loaded with ``ctypes``. A library that includes PyTorch's headers
(``torch.utils.cpp_extension.load``) takes minutes to compile and needs ``ninja``; the C
interface builds in seconds with ``nvcc`` alone. Pointers cross as ``data_ptr()`` integers
and the launch stream as ``torch.cuda.current_stream().cuda_stream``.

The library lands in ``ops/_build_cache/`` (git-ignored), named by a digest of its sources
and flags, so a checkout builds once and a changed source rebuilds. A failed build raises
with the compiler's output; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "csrc", "block_attention_fwd.cu"),)
BUILD_DIR = os.path.join(_HERE, "_build_cache")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libmmt_kernels_{digest.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the sources if the library for their digest is missing.

    Returns (library path, the compiler's ``-Xptxas -v`` report; empty when cached)."""
    out = library_path()
    if os.path.isfile(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; argument types declared for every entry."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.mmt_block_attention_fwd.argtypes = [i32] + [ptr] * 12 + [i32] * 5 + [ptr]
            lib.mmt_block_attention_fwd.restype = i32
            lib.mmt_error_string.argtypes = [i32]
            lib.mmt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.mmt_error_string(err).decode()})")
