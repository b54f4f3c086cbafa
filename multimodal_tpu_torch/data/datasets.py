"""The dataset dispatcher (port of ``multimodal_tpu/data/datasets.py:build_dataset``), its
synthetic branch.

Not ported yet: the webdataset reader and the file-list datasets (COCO, LAION, COOD, CSV)
with their decode and augmentation, ROADMAP Queue 1 item 8 (the data path); every
``dataset_type`` but ``synthetic`` raises ``NotImplementedError``."""

from __future__ import annotations

from multimodal_tpu_torch.data.synthetic import SyntheticBatches

DATASET_TYPES = ("webdataset", "coco", "laion", "cood", "csv", "synthetic")


def build_dataset(dataset_type: str, *, path: str = "", batch_size: int, train: bool = True,
                  seed: int = 0, num_hosts: int = 1, host_id: int = 0, num_workers: int = 1,
                  worker_id: int = 0, **kw):
    """``synthetic`` -> ``SyntheticBatches(batch_size, **kw)``. As in the reference, the
    synthetic stream takes its seed from ``kw`` (default 0), not from ``seed``."""
    if dataset_type == "synthetic":
        return SyntheticBatches(batch_size=batch_size, **kw)
    if dataset_type in DATASET_TYPES:
        raise NotImplementedError(
            f"dataset_type={dataset_type!r}: the real-data readers are not ported yet "
            "(ROADMAP Queue 1 item 8, the data path)")
    raise ValueError(f"unknown dataset_type {dataset_type!r}")
