"""Shard distributors: which worker reads which tar shard (host code).

The port's copy of cosmos_predict2_tpu/data/distributors.py, after the
reference's webdataset distributors (distributors/basic.py and
multi_aspect_ratio_v2.py). A worker is (host process) x (loader thread),
named by explicit rank / worker arguments.

* :class:`BasicShardDistributor`: round-robin shard split by global worker
  with per-epoch shuffling.
* :class:`MultiAspectRatioDistributor`: each worker is pinned to one aspect
  ratio, so every batch it makes has one shape. Worker allocation follows
  the reference (multi_aspect_ratio_v2.py:123-160): at least one worker per
  aspect ratio, the rest assigned greedily toward the shard-count shares.
"""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Any, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TarShardInfo:
    """One tar shard plus its dataset metadata (reference
    webdataset/config/schema.py TarSample + DatasetInfo.opts)."""

    path: str
    root: str = ""
    dset_id: str = ""
    opts: tuple[tuple[str, Any], ...] = ()

    @property
    def url(self) -> str:
        return f"{self.root}{self.path}" if self.root else self.path

    def opt(self, key: str, default: Any = None) -> Any:
        return dict(self.opts).get(key, default)


class BasicShardDistributor:
    """Round-robin split of shards across (world_size x num_workers) global
    workers, reshuffled every epoch with a deterministic seed."""

    def __init__(
        self,
        shards: list[TarShardInfo] | list[str],
        rank: int = 0,
        world_size: int = 1,
        worker_id: int = 0,
        num_workers: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        infinite: bool = True,
    ):
        self.shards = sorted(shards, key=lambda s: s.url if isinstance(s, TarShardInfo) else s)
        self.global_worker = rank * num_workers + worker_id
        self.total_workers = world_size * num_workers
        self.shuffle = shuffle
        self.seed = seed
        self.infinite = infinite

    def urls(self, epoch: int = 0) -> list:
        shards = list(self.shards)
        if self.shuffle:
            random.Random(self.seed + epoch).shuffle(shards)
        return shards[self.global_worker :: self.total_workers]

    def __iter__(self) -> Iterator:
        epoch = 0
        while True:
            chunk = self.urls(epoch)
            if not chunk:
                # fewer shards than workers: wrap around rather than starve
                chunk = [self.shards[self.global_worker % len(self.shards)]]
            yield from chunk
            epoch += 1
            if not self.infinite:
                return


def split_by_aspect_ratio(shards: list[TarShardInfo]) -> dict[str, list[TarShardInfo]]:
    """Group shards by their dataset's aspect ratio (multi_aspect_ratio_v2
    .py:100-120). Shards must carry an ``aspect_ratio`` opt."""
    split: dict[str, list[TarShardInfo]] = defaultdict(list)
    for s in shards:
        ar = s.opt("aspect_ratio")
        if ar is None:
            raise ValueError(
                f"shard {s.url!r} has no aspect_ratio opt; required by the multi-aspect distributor"
            )
        split[ar].append(s)
    for ar in split:
        split[ar] = sorted(split[ar], key=lambda t: (t.path, t.root))
    return dict(split)


def allocate_workers_to_aspects(
    shard_counts: dict[str, int], num_workers_all: int
) -> list[tuple[str, int]]:
    """Assign workers to aspect ratios: every aspect gets >= 1 worker, the
    rest go greedily to the aspect whose current share most undershoots its
    shard-count share (multi_aspect_ratio_v2.py:123-160 semantics)."""
    num_aspects = len(shard_counts)
    if num_workers_all < num_aspects:
        raise ValueError(
            f"need >= {num_aspects} global workers (one per aspect ratio), got {num_workers_all}"
        )
    keys = list(shard_counts.keys())
    target = np.array([shard_counts[k] for k in keys], dtype=np.float64)
    target = target / target.sum()
    alloc = np.ones([num_aspects], dtype=np.int64)
    for _ in range(num_workers_all - num_aspects):
        current = alloc / alloc.sum()
        alloc[np.argmin(current - target)] += 1
    return list(zip(keys, alloc.tolist()))


class MultiAspectRatioDistributor:
    """Infinite multi-aspect-ratio shard iterator: each global worker sees
    exactly one aspect ratio (multi_aspect_ratio_v2.py
    ShardlistMultiAspectRatioInfinite)."""

    def __init__(
        self,
        shards: list[TarShardInfo],
        rank: int = 0,
        world_size: int = 1,
        worker_id: int = 0,
        num_workers: int = 1,
        shuffle: bool = True,
        seed: Optional[int] = None,
    ):
        self.by_aspect = split_by_aspect_ratio(shards)
        self.rank = rank
        self.world_size = world_size
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.shuffle = shuffle
        # unlike the reference's time_ns() reshuffle, default seeding is
        # deterministic per worker (reproducible runs; pass seed=None
        # explicitly through shuffle_seed plumbing if wall-clock entropy is
        # ever wanted)
        self.seed = seed if seed is not None else 0

    @property
    def aspect_ratio(self) -> str:
        """The single aspect ratio this worker is pinned to."""
        aspect, _, _ = self._assignment()
        return aspect

    def _assignment(self) -> tuple[str, int, int]:
        """(aspect_key, chunk_id, worker_count) for this worker
        (multi_aspect_ratio_v2.py:162-207)."""
        nworkers_all = self.world_size * self.num_workers
        allocation = allocate_workers_to_aspects(
            {k: len(v) for k, v in self.by_aspect.items()}, nworkers_all
        )
        global_worker = self.rank * self.num_workers + self.worker_id
        cumulative = 0
        for aspect_key, worker_count in allocation:
            cumulative += worker_count
            if global_worker < cumulative:
                return aspect_key, global_worker - cumulative + worker_count, worker_count
        raise AssertionError(f"global worker {global_worker} beyond allocation {allocation}")

    def urls(self) -> list[TarShardInfo]:
        aspect_key, chunk_id, worker_count = self._assignment()
        shards = self.by_aspect[aspect_key]
        if len(shards) >= worker_count:
            chunk = shards[chunk_id::worker_count]
        else:
            # more workers than shards on this aspect: each worker loops one
            chunk = shards[chunk_id % len(shards) : chunk_id % len(shards) + 1]
        if self.shuffle:
            global_worker = self.rank * self.num_workers + self.worker_id
            chunk = list(chunk)
            random.Random(self.seed + global_worker).shuffle(chunk)
        return chunk

    def __iter__(self) -> Iterator[TarShardInfo]:
        chunk = self.urls()
        assert chunk, "no shards assigned"
        epoch = 0
        while True:
            if self.shuffle:
                chunk = list(chunk)
                random.Random(self.seed + epoch * 100003 + 1).shuffle(chunk)
            yield from chunk
            epoch += 1
