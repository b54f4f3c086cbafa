"""Checkpoints with the reference's save / rotate / resume-latest semantics, in torch files
(port of ``multimodal_tpu/train/checkpoints.py:CheckpointManager``, which writes Orbax
directories; the two formats are not interchangeable).

Each save is ``<directory>/<step>/state.pt`` (``torch.save`` of the state, every tensor on
the host) and ``<directory>/<step>/metadata.json``, written into ``<directory>/.<step>.tmp``
and moved into place with ``os.replace``: a save cut short leaves only a hidden temporary
directory, which ``all_steps`` never lists. ``async_save`` copies the state into host memory
before ``save`` returns (the port's step updates the parameters and the moments in place, so
a snapshot taken later would hold a later step) and writes the files on a thread;
``wait`` joins the writes."""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` (dicts, lists, tuples) with every tensor copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 async_save: bool = False):
        """``max_to_keep`` keeps the newest steps only (``None``: all); ``async_save``
        writes on a thread after the host copy."""
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._async = async_save
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _write(self, step: int, state: Any, metadata: Optional[dict]):
        tmp = os.path.join(self._dir, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METADATA_FILE), "w") as f:
            json.dump(metadata or {}, f)
        final = os.path.join(self._dir, str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                self.delete(old)

    def _write_logged(self, *args):
        try:
            self._write(*args)
        except Exception as e:  # noqa: BLE001 - raised again by wait()
            self._error = e

    def save(self, step: int, state: Any, metadata: Optional[dict] = None):
        """Save ``state`` (a tree of tensors and plain values) at ``step``. The host copy is
        made before this returns, whether the write is asynchronous or not."""
        self.wait()
        host = to_host(state)
        if self._async:
            self._writer = threading.Thread(target=self._write_logged,
                                            args=(step, host, metadata), daemon=True)
            self._writer.start()
        else:
            self._write(step, host, metadata)

    def wait(self):
        """Join an asynchronous write; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self) -> list[int]:
        """The saved steps, in order: the directories whose name is a step and that hold a
        complete save."""
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit() and os.path.exists(os.path.join(self._dir, n, METADATA_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> tuple[Any, Optional[dict]]:
        """(state, metadata) at ``step`` (default: the latest), every tensor on the CPU; (None,
        None) when nothing is saved."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        path = os.path.join(self._dir, str(step))
        state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                           weights_only=True)
        with open(os.path.join(path, METADATA_FILE)) as f:
            return state, json.load(f)

    def delete(self, step: int):
        """Remove one saved step (the run replaces a mid-epoch save that landed on the
        epoch boundary with the clean epoch-end save)."""
        shutil.rmtree(os.path.join(self._dir, str(step)), ignore_errors=True)

    def close(self):
        self.wait()
