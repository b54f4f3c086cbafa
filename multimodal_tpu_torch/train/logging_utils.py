"""Meters and run records (port of ``multimodal_tpu/train/logging_utils.py``): wall-clock
meters, samples/s, ``results.jsonl``, the logging setup, and wandb / tensorboard when they
are installed (each warns and is skipped when it is not)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


class ThroughputMeter:
    """samples/s and samples/s/device over a sliding window (train.py:206-207)."""

    def __init__(self, num_devices: int = 1):
        self.num_devices = num_devices
        self._t0 = time.perf_counter()
        self._samples = 0

    def update(self, batch_samples: int):
        self._samples += batch_samples

    def rates(self):
        dt = time.perf_counter() - self._t0
        sps = self._samples / max(dt, 1e-9)
        return {"samples_per_s": sps, "samples_per_s_per_device": sps / self.num_devices}

    def reset(self):
        self._t0 = time.perf_counter()
        self._samples = 0


class JsonlLogger:
    """Append eval/train records to results.jsonl (train.py:326-328)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")


def setup_logging(log_file: Optional[str] = None, level=logging.INFO, rank: int = 0):
    """Root-logger setup with stream + optional file handler (main/logger.py:8-29)."""
    fmt = logging.Formatter(
        f"%(asctime)s | rank{rank} | %(levelname)s | %(message)s", datefmt="%Y-%m-%d,%H:%M:%S"
    )
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers.clear()
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)


class ExperimentLogger:
    """Fan-out to console/JSONL + wandb/tensorboard when available (run.py:350-369)."""

    def __init__(self, log_dir: str, use_wandb: bool = False, use_tensorboard: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        self.jsonl = JsonlLogger(os.path.join(log_dir, "results.jsonl"))
        self._wandb = None
        self._tb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except ImportError:
                logging.warning("wandb requested but not installed; skipping")
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, "tensorboard"))
            except ImportError:
                logging.warning("tensorboard requested but not installed; skipping")

    def log(self, record: dict, step: Optional[int] = None):
        self.jsonl.log(record)
        if self._wandb is not None:
            self._wandb.log(record, step=step)
        if self._tb is not None:
            for k, v in record.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
