"""Data loaders: the test side (raw samples in order) and the train side
(shuffled, sharded, collated batches).

Counterpart of ``rsprompter_tpu/data/loader.py`` (``DataLoader`` :19-97).

- :class:`DataLoader` is the test side (JAX's ``shuffle=False,
  drop_last=False``) with ``collate_batch``'s padded slots
  (``data/transforms.py:310-312``): the port resizes and pads on the device
  (``apis/inference.py``), so a batch is the dataset's raw samples (the
  uint8 BGR image and its GT at the original size) with one meta per slot;
  the last partial batch's empty slots get a copy of the last meta with
  ``img_id=-1``, which the metric skips. With ``num_shards`` > 1 (sharded
  evaluation, one shard a rank) shard ``shard_id`` is the ``shard_id``-th
  of ``num_shards`` contiguous blocks of the dataset, their sizes apart by
  at most one: no image is read twice, none is dropped, and the shards in
  rank order are the dataset in order.
- :class:`TrainLoader` is JAX's loader as ``tools/train.py`` uses it: the
  indices shuffled by ``RandomState(seed + epoch)``, ``epoch`` advancing on
  each iteration, every ``num_shards``-th index from ``shard_id``, batches
  collated (``max_gt``, ``pad_shape``, bit-packed masks). Where it is given
  the ``rng`` its dataset's transforms draw from, it re-seeds that rng with
  ``(seed, epoch)`` before each epoch (``(seed, epoch, shard_id)`` with more
  than one shard, so the ranks augment with their own streams), so a run
  resumed at an epoch draws the samples an uninterrupted one would. With
  more than one shard the shuffled indices are cut to a multiple of
  ``num_shards`` first (as ``DistributedSampler(drop_last=True)`` cuts
  them): every rank takes as many steps, which data-parallel training
  needs.

Both decode ``prefetch`` batches ahead in a background thread when asked
(the num_workers analogue of the reference's torch DataLoader); an error in
the thread is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from rsprompter_tpu_torch.data.transforms import collate_batch

META_KEYS = ("img_id", "img_path", "ori_shape")


def prefetched(make_iter: Callable[[], Iterator], depth: int) -> Iterator:
    """Run ``make_iter()`` in a background thread, ``depth`` items ahead;
    an error in the thread is raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()
    failure: List[BaseException] = []

    def worker():
        try:
            for item in make_iter():
                q.put(item)
        except BaseException as err:  # handed to the consumer below
            failure.append(err)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            t.join()
            if failure:
                raise failure[0]
            return
        yield item


class DataLoader:
    def __init__(self, dataset, batch_size: int = 2, prefetch: int = 0, shard_id: int = 0,
                 num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch
        block = np.array_split(np.arange(len(dataset)), num_shards)[shard_id]
        self.start = int(block[0]) if len(block) else len(dataset)  # the shard's first index
        self.stop = self.start + len(block)

    def __len__(self) -> int:
        return (self.stop - self.start + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[List[Dict], List[Dict]]]:
        if self.prefetch > 0:
            return prefetched(self._iter_sync, self.prefetch)
        return self._iter_sync()

    def _iter_sync(self):
        for start in range(self.start, self.stop, self.batch_size):
            samples = [self.dataset[i]
                       for i in range(start, min(start + self.batch_size, self.stop))]
            metas = [{k: s[k] for k in META_KEYS} for s in samples]
            while len(metas) < self.batch_size:
                metas.append(dict(metas[-1], img_id=-1))
            yield samples, metas


class TrainLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 2,
        shuffle: bool = True,
        seed: int = 0,
        max_gt: int = 100,
        pad_shape: Optional[Tuple[int, int]] = None,
        drop_last: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
        prefetch: int = 0,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.max_gt = max_gt
        self.pad_shape = pad_shape
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.prefetch = prefetch
        self.rng = rng
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards  # the cut shard's length
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], List[Dict]]]:
        if self.prefetch > 0:
            return prefetched(self._iter_sync, self.prefetch)
        return self._iter_sync()

    def _iter_sync(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rs = np.random.RandomState(self.seed + self.epoch)
            rs.shuffle(indices)
        if self.num_shards > 1:
            indices = indices[: len(indices) // self.num_shards * self.num_shards]
        indices = indices[self.shard_id :: self.num_shards]
        if self.rng is not None:
            self.rng.seed([self.seed, self.epoch] + ([self.shard_id] if self.num_shards > 1 else []))
        self.epoch += 1
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            samples = [self.dataset[int(i)] for i in chunk]
            yield collate_batch(
                samples,
                batch_size=self.batch_size,
                max_gt=self.max_gt,
                pad_shape=self.pad_shape,
            )
