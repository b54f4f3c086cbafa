"""The device feed: a background producer, the round-robin merge of reader workers and a
prefetch onto the device (port of ``multimodal_tpu/data/pipeline.py``: ``background``,
``InterleavedReaders``, ``prefetch_to_device`` and ``DataInfo``).

A daemon thread runs the host side of the stream (batch generation and, for a CUDA target,
the copy of every host array into pinned memory; a tensor a reader already decoded onto the
device passes through); the consumer's thread starts each batch's
host-to-device copies with ``non_blocking=True`` ``depth`` batches ahead of the step that
reads them, so the copies overlap the steps before. The copies run on the current stream, so
a step enqueued after them reads complete data.

A producer that raises ends its stream with that exception, which the consumer's thread raises
again with its traceback (the reference ends the stream quietly, as if it were complete).

A pinned buffer must stay alive while its copy is in flight: ``prefetch_to_device`` holds the
pinned tensors of each batch until the consumer asks for the batch after it, which is after
the step that read it was enqueued (and behind that step, on the same stream, the copy).
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


class _Failure:
    """What a producer raised, carried through the queue to the consumer."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


def _producer(iterable, q: queue.Queue, stop: threading.Event):
    """Put ``iterable``'s items on ``q``, then the end of the stream: the sentinel, or a
    ``_Failure`` holding what the iterable raised."""
    end = _SENTINEL
    try:
        for item in iterable:
            if stop.is_set():
                return
            q.put(item)
    except BaseException as e:  # noqa: BLE001 - raised again in the consumer's thread
        end = _Failure(e)
    finally:
        q.put(end)


def _end_of(item) -> bool:
    """True at a clean end of stream; raises what the producer raised (its traceback
    attached) at a failed one."""
    if isinstance(item, _Failure):
        raise item.error
    return item is _SENTINEL


def background(iterable: Iterable, depth: int = 4) -> Iterator:
    """Run an iterable in a daemon thread behind a bounded queue. What the iterable raises
    is raised here, in the consumer's thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    threading.Thread(target=_producer, args=(iterable, q, stop), daemon=True).start()
    try:
        while True:
            item = q.get()
            if _end_of(item):
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a producer parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break


class InterleavedReaders:
    """--workers N: N shard-disjoint readers (the reference's dataloader workers,
    data.py:467-469 split_by_worker) prefetching concurrently on daemon threads, merged
    STRICTLY ROUND-ROBIN (worker 0, 1, ..., skipping exhausted ones). The merge order is
    therefore fully deterministic given deterministic per-worker streams, which the mid-epoch
    resume fast-forward needs: it replays and skips a batch prefix by position. Read and decode
    still overlap across workers: each fills its own bounded queue ahead of its turn. Epochs
    plumb to every worker. A worker that raises ends the stream with its exception, at its
    turn; the others are stopped."""

    def __init__(self, readers, depth: int = 4):
        if not readers:
            raise ValueError("need at least one reader")
        self.readers = list(readers)
        self.depth = depth
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        for r in self.readers:
            if hasattr(r, "set_epoch"):
                r.set_epoch(epoch)

    @property
    def num_batches(self):
        counts = [getattr(r, "num_batches", None) for r in self.readers]
        return None if any(c is None for c in counts) else sum(counts)

    def __iter__(self):
        queues = [queue.Queue(maxsize=self.depth) for _ in self.readers]
        stop = threading.Event()
        for r, q in zip(self.readers, queues):
            threading.Thread(target=_producer, args=(iter(r), q, stop), daemon=True).start()
        live = list(queues)
        try:
            while live:
                for q in list(live):
                    item = q.get()
                    if _end_of(item):
                        live.remove(q)
                        continue
                    yield item
        finally:
            stop.set()
            for q in queues:  # unblock producers parked on a full queue
                while not q.empty():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break


def _host_tensors(batch: dict, pin: bool) -> dict:
    """numpy arrays -> CPU tensors, copied into pinned memory when ``pin``; a tensor already
    on a CUDA device stays where it is."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if pin and not t.is_cuda else t
    return out


def prefetch_to_device(iterable: Iterable, device="cuda", depth: int = 2,
                       decode_threads: int = 4) -> Iterator[dict]:
    """Yield the batches of ``iterable`` (dicts of numpy arrays or tensors) as tensors on
    ``device``, their copies started ``depth`` batches ahead of consumption. On the CPU the
    tensors share the arrays' memory."""
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
