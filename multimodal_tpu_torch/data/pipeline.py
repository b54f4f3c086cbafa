"""The device feed: a background producer and a prefetch onto the device (port of
``multimodal_tpu/data/pipeline.py``: ``background``, ``prefetch_to_device`` and
``DataInfo``).

A daemon thread runs the host side of the stream (batch generation and, for a CUDA target,
the copy of every array into pinned host memory); the consumer's thread starts each batch's
host-to-device copies with ``non_blocking=True`` ``depth`` batches ahead of the step that
reads them, so the copies overlap the steps before. The copies run on the current stream, so
a step enqueued after them reads complete data.

A pinned buffer must stay alive while its copy is in flight: ``prefetch_to_device`` holds the
pinned tensors of each batch until the consumer asks for the batch after it, which is after
the step that read it was enqueued (and behind that step, on the same stream, the copy).

Not ported yet: ``InterleavedReaders`` (the round-robin merge of webdataset readers), with
the webdataset reader, ROADMAP Queue 1 item 8."""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def _producer(iterable, q: queue.Queue, stop: threading.Event):
    try:
        for item in iterable:
            if stop.is_set():
                return
            q.put(item)
    finally:
        q.put(_SENTINEL)


def background(iterable: Iterable, depth: int = 4) -> Iterator:
    """Run an iterable in a daemon thread behind a bounded queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    threading.Thread(target=_producer, args=(iterable, q, stop), daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a producer parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _host_tensors(batch: dict, pin: bool) -> dict:
    """numpy arrays -> CPU tensors, copied into pinned memory when ``pin``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin else t
    return out


def prefetch_to_device(iterable: Iterable, device="cuda", depth: int = 2,
                       decode_threads: int = 4) -> Iterator[dict]:
    """Yield the batches of ``iterable`` (dicts of numpy arrays) as tensors on ``device``,
    their copies started ``depth`` batches ahead of consumption. On the CPU the tensors share
    the arrays' memory."""
    device = torch.device(device)
    pin = device.type == "cuda"
    it = background((_host_tensors(b, pin) for b in iterable), depth=max(depth, decode_threads))
    staged: collections.deque = collections.deque()

    def stage(host: dict):
        if not pin:
            return host, host
        return host, {k: v.to(device, non_blocking=True) for k, v in host.items()}

    for host in it:
        staged.append(stage(host))
        if len(staged) > depth:
            pinned, batch = staged.popleft()
            yield batch
            del pinned  # the step that read ``batch`` is enqueued behind its copies
    while staged:
        pinned, batch = staged.popleft()
        yield batch
        del pinned


class DataInfo:
    """A batch source with its epoch bookkeeping, iterated onto ``device``."""

    def __init__(self, source, device="cuda", prefetch_depth: int = 2):
        self.source = source
        self.device = device
        self.prefetch_depth = prefetch_depth

    def set_epoch(self, epoch: int):
        if hasattr(self.source, "set_epoch"):
            self.source.set_epoch(epoch)

    @property
    def num_batches(self) -> Optional[int]:
        return getattr(self.source, "num_batches", None)

    def __iter__(self):
        return prefetch_to_device(self.source, self.device, self.prefetch_depth)
