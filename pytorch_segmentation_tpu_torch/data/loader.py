"""Data loading: threaded host loader + device-prefetching Fetcher (copy of
pytorch_segmentation_tpu/data/loader.py, which is numpy and the standard
library only; the port imports nothing of that package).

  - worker threads, not processes: the host work is only decode+resize
    (numpy releases the GIL); the heavy augmentation runs on the device.
  - fixed shapes: train batches drop the last partial batch; eval batches
    are padded to `batch_size` by repeating samples and carry a `valid`
    count so the eval step can mask padded samples out of the metrics.
  - the Fetcher overlaps host loading, the copy to the device and the
    augmentation's dispatch with the consumer's work by running
    `post_fetch_fn` in a producer thread, `prefetch` batches ahead. The
    producer's CUDA work goes to the same stream as the consumer's, so a
    batch handed across is never read before it is written or freed while
    it is read.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["DataLoader", "Fetcher", "Batch", "repeat_factors"]


def repeat_factors(presence, num_images: int, t: float) -> np.ndarray:
    """LVIS repeat-factor sampling (Gupta et al., CVPR 2019): per-image
    oversampling factor r(i) = max_{c in i} max(1, sqrt(t / f_c)) where
    f_c is the fraction of images containing class c. Images of classes
    rarer than threshold `t` repeat ~sqrt(t/f_c) times per epoch;
    common-class images keep factor 1. `presence` is the dataset's
    class_presence() list of per-image class-id sets."""
    from collections import Counter
    counts = Counter(c for s in presence for c in s)
    freq = {c: n / max(1, num_images) for c, n in counts.items()}
    rc = {c: max(1.0, np.sqrt(t / f)) for c, f in freq.items()}
    return np.asarray([max((rc[c] for c in s), default=1.0)
                       for s in presence], np.float64)


class Batch:
    """One host batch: images [B,H,W,3] u8, segs [B,H,W] u8, valid count."""

    __slots__ = ("images", "segs", "valid")

    def __init__(self, images, segs, valid):
        self.images = images
        self.segs = segs
        self.valid = valid


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4,
                 seed: int = 0, rank: int = 0, world_size: int = 1,
                 repeat_factors=None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, int(num_workers))
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        # per-sample oversampling factors >= 1 (see repeat_factors());
        # applied with per-epoch stochastic rounding, training only
        self.repeat_factors = (None if repeat_factors is None
                               else np.asarray(repeat_factors, np.float64))

    def __len__(self):
        n = len(self._local_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _local_indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            if self.repeat_factors is not None:
                # stochastic rounding per epoch (detectron2 semantics):
                # r = 2.3 -> 2 repeats always, a 3rd with prob 0.3
                r = self.repeat_factors
                reps = np.floor(r).astype(np.int64)
                reps += rng.random(n) < (r - reps)
                idx = np.repeat(idx, reps)
            idx = rng.permutation(idx)
        if self.world_size > 1:
            # equal per-rank shards, padded by wrap-around: the
            # DistributedSampler contract
            per_rank = (n + self.world_size - 1) // self.world_size
            padded = np.resize(idx, per_rank * self.world_size)
            idx = padded[self.rank::self.world_size]
        return idx

    def __iter__(self):
        indices = self._local_indices()
        bs = self.batch_size
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(indices), bs):
                chunk = indices[start:start + bs]
                if len(chunk) < bs:
                    if self.drop_last:
                        break
                    pad = bs - len(chunk)
                    chunk = np.concatenate([chunk, np.resize(chunk, pad)])
                    valid = bs - pad
                else:
                    valid = bs
                samples = list(pool.map(self.dataset.__getitem__, chunk))
                images = np.stack([s[0] for s in samples])
                segs = np.stack([s[1] for s in samples])
                yield Batch(images, segs, valid)
        self.epoch += 1


class Fetcher:
    """Device-prefetching iterator: wraps a loader, applies `post_fetch_fn`
    to each batch in a producer thread, exposes `.loader`."""

    def __init__(self, loader: DataLoader, post_fetch_fn=None, prefetch: int = 2):
        self.loader = loader
        self.post_fetch_fn = post_fetch_fn
        self.prefetch = prefetch

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()  # consumer abandoned the iteration
        err: list = []

        def put(item):
            # bounded put that gives up once the consumer is gone: a plain
            # q.put would block forever on a full queue and deadlock the
            # consumer's teardown join (early break / exception mid-epoch)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        break
                    out = (self.post_fetch_fn(batch)
                           if self.post_fetch_fn is not None else batch)
                    if not put(out):
                        break
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
        if err:
            raise err[0]
