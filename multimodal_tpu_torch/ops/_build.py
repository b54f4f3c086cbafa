"""Build and load the port's CUDA kernels at first use.

The sources under ``ops/csrc`` have a plain C interface. ``nvcc`` compiles each into an
object, all of them at once in parallel processes, and links the objects into one shared
library, loaded with ``ctypes``. A library that includes PyTorch's headers
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
import re
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = tuple(os.path.join(_HERE, "csrc", name) for name in (
    "block_attention_fwd.cu", "block_attention_bwd.cu", "fused_attention.cu", "block_mlp.cu",
    "flash_attention.cu", "quant.cu", "int8_gemm.cu", "resample.cu"))
HEADERS = tuple(os.path.join(_HERE, "csrc", name) for name in (
    "block_attention_common.cuh", "attention_passes.cuh", "mma_tiles.cuh", "register_tiles.cuh",
    "tf32_tiles.cuh", "mma_gemm.cuh", "hopper.cuh", "wgmma_gemm.cuh", "wgmma_attention.cuh"))
BUILD_DIR = os.path.join(_HERE, "_build_cache")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The tensor-core GEMMs' template arguments after their two types (csrc/mma_gemm.cuh's
# mma_gemm_kernel, csrc/wgmma_gemm.cuh's wgmma_gemm_kernel): form, load transform, store; each
# use is its own instantiation and so its own kernel name
GEMM_FORMS = ("NN", "NT", "TN")
GEMM_LOADS = ("plain", "LN", "act", "LN-b")
GEMM_STORES = ("round", "residual", "act'", "bias-residual", "round+act", "serial")

# resample.cu decodes JPEGs with the toolkit's nvJPEG
LINK_LIBS = ("-lnvjpeg",)

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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_LIBS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libmmt_kernels_{digest.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the sources if the library for their digest is missing: one ``nvcc -c`` per
    source, all started together, then one link.

    Returns (library path, the compiler's ``-Xptxas -v`` report; empty when cached)."""
    out = library_path()
    if os.path.isfile(out):
        return out, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        report = "".join(logs)
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"({proc.returncode}):\n{log}")
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, "-shared", "-o", lib, *objs, *LINK_LIBS],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib, out)  # atomic: a concurrent build never loads a partial file
    return out, report


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; argument types declared for every entry."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            entries = {  # every entry returns a cudaError_t
                "mmt_block_attention_fwd": [i32] + [ptr] * 12 + [i32] * 5 + [ptr],
                "mmt_block_attention_ln_fwd": [i32] + [ptr] * 15 + [i32] * 6 + [f32, ptr],
                "mmt_block_attention_bwd": [i32] + [ptr] * 18 + [i32] * 5 + [ptr],
                "mmt_block_attention_ln_bwd": [i32] + [ptr] * 25 + [i32] * 6 + [f32, ptr],
                "mmt_fused_attention_fwd": [i32] + [ptr] * 5 + [i32] * 5 + [f32, ptr],
                "mmt_fused_attention_bwd": [i32] + [ptr] * 10 + [i32] * 5 + [f32, ptr],
                "mmt_flash_attention_fwd": [i32] + [ptr] * 5 + [i32] * 6 + [f32, ptr],
                "mmt_flash_attention_dq": [i32] + [ptr] * 7 + [i32] * 6 + [f32, ptr],
                "mmt_flash_attention_dkv": [i32] + [ptr] * 8 + [i32] * 6 + [f32, ptr],
                "mmt_ln_bwd_partial_rows": [i32],
                "mmt_block_attention_wgrad": [ptr] * 9 + [i32] * 4 + [ptr],
                "mmt_block_wgrad_flag_count": [i32],
                "mmt_block_mlp_fwd": [i32] + [ptr] * 11 + [i32] * 5 + [f32, ptr],
                "mmt_block_mlp_bwd": [i32] + [ptr] * 16 + [i32] * 6 + [f32, ptr],
                "mmt_block_mlp_db1_partial_rows": [i32],
                "mmt_quantize_rows": [i32] + [ptr] * 3 + [i32] * 4 + [ptr],
                "mmt_int8_gemm": [i32] * 2 + [ptr] * 6 + [i32] * 3 + [ptr],
                "mmt_resample": [ptr] * 8 + [i32] * 3 + [ptr],
                "mmt_jpeg_dims": [ptr, ptr, i32, ptr, ptr],
                "mmt_jpeg_decode": [ptr, ptr, i32, ptr, ptr, ptr, ptr, i32, i32, ptr],
            }
            for name, argtypes in entries.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = i32
            lib.mmt_error_string.argtypes = [i32]
            lib.mmt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def gemm_signature(kernel: str) -> tuple[str, str, str, str, str] | None:
    """(T, TOut, form, load, store) of an ``mma_gemm_kernel`` or ``wgmma_gemm_kernel``
    instantiation, from its mangled name (the SASS, ``-Xptxas -v``) or its demangled one (the
    profiler), e.g. ("bfloat16", "float", "TN", "LN-b", "round"); None for any other kernel.
    ``"wgmma_gemm_kernel" in kernel`` tells the two GEMMs apart; the wgmma GEMM's last template
    arguments, its tile width and its operand sets (``gemm_sets``), are not part of the
    signature."""
    found = re.search(r"mma_gemm_kernel<([\w:]+), ([\w:]+), (\d), (\d), (\d)(?:, \d+)*>",
                      kernel)
    if found:
        types = ["float" if t == "float" else "bfloat16" for t in found.group(1, 2)]
    else:  # the second type of a bf16 -> bf16 GEMM is a back-reference (S<n>_) to the first
        found = re.search(r"mma_gemm_kernelI(13__nv_bfloat16|f)(13__nv_bfloat16|f|S\d*_)"
                          r"Li(\d)ELi(\d)ELi(\d)E", kernel)
        if not found:
            return None
        types = ["float" if t == "f" else "bfloat16" for t in found.group(1, 2)]
    form, load, store = (int(v) for v in found.group(3, 4, 5))
    return (*types, GEMM_FORMS[form], GEMM_LOADS[load], GEMM_STORES[store])


def gemm_sets(kernel: str) -> int:
    """The operand sets of a ``wgmma_gemm_kernel`` instantiation, its last template argument (3
    for the block-attention kernels' GEMMs, 4 for the block backward's weight gradients, 1 for
    the fused MLP's), from its mangled or demangled name; 1 for any other kernel."""
    found = (re.search(r"wgmma_gemm_kernel<(?:[\w:]+, ){6}(\d+)>", kernel)
             or re.search(r"wgmma_gemm_kernelI(?:13__nv_bfloat16|f)(?:13__nv_bfloat16|f|S\d*_)"
                          r"(?:Li\d+E){4}Li(\d+)E", kernel))
    return int(found.group(1)) if found else 1


NVJPEG_ERROR = 100000  # resample.cu's nvJPEG entries return this + the nvjpegStatus_t


def check(lib: ctypes.CDLL, err: int, what: str):
    if err >= NVJPEG_ERROR:
        raise RuntimeError(f"{what} failed: nvJPEG status {err - NVJPEG_ERROR}")
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.mmt_error_string(err).decode()})")
