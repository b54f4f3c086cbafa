"""Data files shared with the JAX package, located by path (never by import: importing
``multimodal_tpu.models`` or ``multimodal_tpu.data`` pulls in jax)."""

from __future__ import annotations

import os

# both packages sit side by side, in the repository root or in site-packages
_REFERENCE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "multimodal_tpu"
)

CONFIG_DIR = os.path.join(_REFERENCE_ROOT, "models", "configs")
BPE_VOCAB_PATH = os.path.join(_REFERENCE_ROOT, "data", "assets", "bpe_simple_vocab_16e6.txt.gz")
ZERO_SHOT_METADATA_PATH = os.path.join(_REFERENCE_ROOT, "eval", "assets", "zero_shot_metadata.json")
