"""Dataloader combinators: joint interleave, cached replay, sharded tar
("webdataset") loading and a stall watchdog (host-side).

The port's copy of cosmos_predict2_tpu/data/loaders.py, after the
reference's data plumbing:
* IterativeJointDataLoader (predict2/datasets/joint_dataloader.py): cycle
  through child loaders with per-loader ratios;
* CachedReplayDataLoader (predict2/datasets/cached_replay_dataloader.py):
  re-yield each batch, fetching the next one in a background thread;
* ShardedTarDataset (imaginaire/datasets/webdataset/): tar shards of
  (sample.ext) files through data/native_tar.py, split across hosts by
  index and shuffled per epoch; remote shards (s3:// gs:// msc://
  http(s)://) download ahead through a ShardSpool (utils/easy_io.py);
* OperationWatchdog (predict2/datasets/watchdog.py:27): a background
  thread that warns when an operation stalls.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import io
import json
import os
import queue
import tempfile
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

from cosmos_predict2_tpu_torch.utils import log


class IterativeJointDataLoader:
    """Interleaves child loaders by ratio: e.g. {image: 1, video: 3}."""

    def __init__(self, loaders: dict[str, tuple[Iterable, int]]):
        self.loaders = {name: (iter(loader), ratio) for name, (loader, ratio) in loaders.items()}

    def __iter__(self) -> Iterator[dict]:
        while True:
            for name, (it, ratio) in self.loaders.items():
                for _ in range(ratio):
                    batch = next(it)
                    if isinstance(batch, dict):
                        batch = dict(batch)
                        batch["dataset_name"] = name
                    yield batch


class CachedReplayDataLoader:
    """Yields each fetched batch ``duplicate_batches`` times, fetching the
    next batch in a background thread while replays are consumed."""

    def __init__(self, loader: Iterable, duplicate_batches: int = 2, prefetch: int = 2):
        self.loader = iter(loader)
        self.duplicate_batches = duplicate_batches
        self.queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for batch in self.loader:
                if self._stop.is_set():
                    return
                self.queue.put(batch)
        except Exception as e:  # propagate through the queue
            self.queue.put(e)

    def __iter__(self):
        while True:
            batch = self.queue.get()
            if isinstance(batch, Exception):
                raise batch
            for _ in range(self.duplicate_batches):
                yield batch

    def close(self):
        self._stop.set()


class ShardSpool:
    """Local-disk spool for REMOTE tar shards (s3:// gs:// msc:// http(s)://).

    Downloads shards through easy_io's backends into a spool directory,
    fetching the NEXT shard in a background thread (a pool of 2) while the
    current one feeds the native reader: the role the reference gives to
    webdataset's streaming S3 pipe (imaginaire/datasets/webdataset/), built
    as download-ahead + a local tar, since the native prefetcher reads at
    random offsets. A download lands in ``<name>.part`` and is renamed into
    place, so a reader never sees half a shard.
    """

    def __init__(self, spool_dir: Optional[str] = None):
        self.dir = spool_dir or tempfile.mkdtemp(prefix="cosmos_shard_spool_")
        os.makedirs(self.dir, exist_ok=True)
        self._futures: dict[str, concurrent.futures.Future] = {}
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=2)

    def _local(self, path: str) -> str:
        h = hashlib.sha1(path.encode()).hexdigest()[:16]
        return os.path.join(self.dir, f"{h}_{os.path.basename(path)}")

    def _download(self, path: str) -> str:
        from cosmos_predict2_tpu_torch.utils import easy_io

        local = self._local(path)
        if not os.path.exists(local):
            data = easy_io._read_bytes(path)
            tmp = local + ".part"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, local)
        return local

    def prefetch(self, path: str) -> None:
        if path not in self._futures:
            self._futures[path] = self._pool.submit(self._download, path)

    def get(self, path: str) -> str:
        """The local path of ``path``'s shard: the prefetch's result, or a
        download now."""
        fut = self._futures.pop(path, None)
        return fut.result() if fut is not None else self._download(path)

    def discard(self, path: str) -> None:
        try:
            os.remove(self._local(path))
        except OSError:
            pass


def _is_remote(path: str) -> bool:
    return "://" in path


class ShardedTarDataset:
    """webdataset-style loader: tar shards of grouped files.

    Files sharing a basename stem form one sample: ``0001.npy`` +
    ``0001.txt`` -> {"npy": array, "txt": str}. Shards are partitioned
    across hosts (process_index) and shuffled per epoch. Remote shard
    paths (s3:// gs:// msc:// http(s)://) stream through a
    :class:`ShardSpool` in ``spool_dir`` with one shard of download
    look-ahead; each is deleted once read, so the spool holds at most two.
    """

    def __init__(
        self,
        shard_paths: list[str],
        process_index: int = 0,
        process_count: int = 1,
        shuffle_seed: Optional[int] = 0,
        decoders: Optional[dict[str, Callable[[bytes], Any]]] = None,
        spool_dir: Optional[str] = None,
        augmentors: Optional[list] = None,
    ):
        self.shards = sorted(shard_paths)[process_index::process_count]
        self.shuffle_seed = shuffle_seed
        self.spool = ShardSpool(spool_dir) if any(_is_remote(s) for s in self.shards) else None
        # augmentor chain (data/augmentors.py zoo); an augmentor returning
        # None rejects the sample, matching the reference contract
        self.augmentors = augmentors or []
        from cosmos_predict2_tpu_torch.data import decoders as dz

        self.decoders = {
            "npy": lambda b: np.load(io.BytesIO(b)),
            "npz": lambda b: dict(np.load(io.BytesIO(b))),
            "txt": lambda b: b.decode("utf-8"),
            "json": lambda b: json.loads(b.decode("utf-8")),
            # decoder zoo defaults (data/decoders.py): images + pickle;
            # video decoders are sampling policies — pass one explicitly
            # via decoders={"mp4": get_video_decoder(...)}.
            **{e: (lambda ext: (lambda b: dz.pil_image_decoder(f"x.{ext}", b)))(e) for e in dz.IMG_EXTENSIONS},
            "pkl": lambda b: dz.pickle_decoder("x.pkl", b),
            "pickle": lambda b: dz.pickle_decoder("x.pickle", b),
            **(decoders or {}),
        }

    def _augment(self, sample: dict) -> Optional[dict]:
        if not self.augmentors:
            return sample
        from cosmos_predict2_tpu_torch.data.augmentors import apply_augmentors

        return apply_augmentors(sample, self.augmentors)

    def _iter_shard(self, path: str) -> Iterator[dict]:
        # native path: C++ index + threaded prefetch, IO off the GIL
        # (data/native_tar.py; falls back to tarfile internally)
        from cosmos_predict2_tpu_torch.data.native_tar import NativeTarShard

        shard = NativeTarShard(path)
        try:
            names = shard.names
            shard.prefetch(list(range(len(names))))
            current_key, sample = None, {}
            for i, name in enumerate(names):
                stem, _, ext = name.rpartition(".")
                if current_key is not None and stem != current_key and sample:
                    out = self._augment(sample)
                    if out is not None:
                        yield out
                    sample = {}
                current_key = stem
                data = shard.get_prefetched(i)
                sample[ext] = self.decoders.get(ext, lambda b: b)(data)
                sample["__key__"] = stem
            if sample:
                out = self._augment(sample)
                if out is not None:
                    yield out
        finally:
            shard.end_prefetch()
            shard.close()

    def __iter__(self) -> Iterator[dict]:
        epoch = 0
        while True:
            shards = list(self.shards)
            if self.shuffle_seed is not None:
                np.random.RandomState(self.shuffle_seed + epoch).shuffle(shards)
            for i, shard in enumerate(shards):
                if self.spool is not None and _is_remote(shard):
                    # download-ahead: the next remote shard fetches while this
                    # one is read; the spool holds at most 2 shards on disk
                    if i + 1 < len(shards) and _is_remote(shards[i + 1]):
                        self.spool.prefetch(shards[i + 1])
                    local = self.spool.get(shard)
                    try:
                        yield from self._iter_shard(local)
                    finally:
                        self.spool.discard(shard)
                else:
                    yield from self._iter_shard(shard)
            epoch += 1
            if not shards:
                return


class OperationWatchdog:
    """Background thread warning when an operation stalls
    (predict2/datasets/watchdog.py:27)."""

    def __init__(self, warn_after_s: float = 60.0, poll_s: float = 5.0):
        self.warn_after_s = warn_after_s
        self.poll_s = poll_s
        self._last_beat = time.monotonic()
        self._operation = "startup"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def beat(self, operation: str = "step"):
        self._last_beat = time.monotonic()
        self._operation = operation

    def _watch(self):
        while not self._stop.wait(self.poll_s):
            stalled = time.monotonic() - self._last_beat
            if stalled > self.warn_after_s:
                log.warning(f"watchdog: '{self._operation}' stalled for {stalled:.0f}s")

    def close(self):
        self._stop.set()
