"""Shard-list handling: brace expansion, deterministic shuffling, host/worker splitting,
with-replacement resampling (port of ``multimodal_tpu/data/shards.py``, pure Python).

Counterpart of the reference's webdataset plumbing (AlignCLIP/main/data.py): brace-expanded
shard lists (`expand_urls` :79), deterministic per-epoch shard shuffle (`detshuffle2` :338),
with-replacement `ResampledShards2` with per-source upsampling weights (:370), and
`split_by_node` / `split_by_worker` sharding (:467-469). The "node" split takes an explicit
(host_id, num_hosts) pair and the worker split an explicit (worker_id, num_workers) pair, so
the same code drives one host or many; every draw comes from a numpy generator seeded by
(seed, epoch[, host, worker]), so both packages walk the same shards in the same order.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

import numpy as np


def braceexpand(pattern: str) -> list[str]:
    """Expand ``{000..123}`` / ``{a,b,c}`` patterns (the webdataset shard-url convention),
    leftmost brace varying slowest (bash order)."""
    m = re.search(r"\{([^{}]*)\}", pattern)
    if not m:
        return [pattern]
    body = m.group(1)
    rng = re.fullmatch(r"(\d+)\.\.(\d+)", body)
    if rng:
        width = len(rng.group(1))
        parts = [str(v).zfill(width) for v in range(int(rng.group(1)), int(rng.group(2)) + 1)]
    elif "," in body:
        parts = body.split(",")
    else:
        return [pattern]
    out = []
    for part in parts:
        out.extend(braceexpand(pattern[: m.start()] + part + pattern[m.end():]))
    return out


def expand_shards(urls: str | Sequence[str], weights: Optional[str | Sequence[float]] = None):
    """'::'-separated multi-source spec with optional '::'-separated weights
    (main/data.py:79-98 expand_urls semantics). Returns (shards, per-shard weights|None)."""
    if isinstance(urls, str):
        sources = urls.split("::")
        if weights is not None and isinstance(weights, str):
            weights = [float(w) for w in weights.split("::")]
        if weights is not None and len(weights) != len(sources):
            raise ValueError(f"{len(weights)} weights for {len(sources)} url sources")
        all_shards, all_weights = [], []
        for i, src in enumerate(sources):
            expanded = braceexpand(src)
            all_shards.extend(expanded)
            if weights is not None:
                all_weights.extend([weights[i]] * len(expanded))
        return all_shards, (all_weights if weights is not None else None)
    return list(urls), (list(weights) if weights is not None else None)


@dataclass
class ShardSampler:
    """Deterministic shard scheduler over one epoch.

    * resampled=False: per-epoch deterministic shuffle seeded by (seed, epoch)
      (detshuffle2, data.py:338-368), then split across hosts and workers;
    * resampled=True: with-replacement weighted sampling (ResampledShards2, data.py:370-421)
      — every host/worker draws independently from the full list, seeded by
      (seed, epoch, host, worker) so draws differ but are reproducible.
    """

    shards: Sequence[str]
    weights: Optional[Sequence[float]] = None
    seed: int = 0
    resampled: bool = False
    num_hosts: int = 1
    host_id: int = 0
    num_workers: int = 1
    worker_id: int = 0
    epoch: int = field(default=0)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[str]:
        if self.resampled:
            rng = np.random.default_rng(
                [self.seed, self.epoch, self.host_id, self.worker_id]
            )
            p = None
            if self.weights is not None:
                w = np.asarray(self.weights, np.float64)
                p = w / w.sum()
            n = len(self.shards)
            for _ in range(max(n // (self.num_hosts * self.num_workers), 1)):
                yield self.shards[int(rng.choice(n, p=p))]
            return
        order = np.random.default_rng([self.seed, self.epoch]).permutation(len(self.shards))
        # host split then worker split, round-robin (split_by_node/worker semantics)
        mine = order[self.host_id :: self.num_hosts][self.worker_id :: self.num_workers]
        for idx in mine:
            yield self.shards[int(idx)]
