"""multimodal_tpu_torch — the PyTorch/CUDA port of ``multimodal_tpu``.

The JAX package beside it stays the reference; this package serves the same CLIP-family
embeddings from PyTorch on an NVIDIA GPU. Plain tensor code is PyTorch; each Pallas kernel
on a ported path has a hand-written CUDA counterpart under ``ops/csrc`` with a plain
PyTorch twin in the same module (used on CPU tensors and as the on-card reference).

Importing this package never imports ``jax`` or the JAX package: model configs and the BPE
vocabulary are read from ``multimodal_tpu``'s data files by path (``paths.py``).
"""

__version__ = "0.1.0"
