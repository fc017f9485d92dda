"""Test-side data loader: decoded samples in a fixed order, in batches.

Counterpart of the test side of ``rsprompter_tpu/data/loader.py``
(``DataLoader`` :19 with ``shuffle=False, drop_last=False``; the background
decode of :56-79) and of ``collate_batch``'s padded slots
(``data/transforms.py:310-312``). The port resizes and pads on the device
(``apis/inference.py``), so a batch is the dataset's raw samples (the uint8
BGR image and its GT at the original size) with one meta per slot: the last
partial batch's empty slots get a copy of the last meta with ``img_id=-1``,
which the metric skips. The train side (shuffle, shards, the GT collate)
comes with the train loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Tuple

META_KEYS = ("img_id", "img_path", "ori_shape")


class DataLoader:
    def __init__(self, dataset, batch_size: int = 2, prefetch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.prefetch = prefetch

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[List[Dict], List[Dict]]]:
        if self.prefetch > 0:
            return self._iter_prefetch()
        return self._iter_sync()

    def _iter_sync(self):
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            samples = [self.dataset[i] for i in range(start, min(start + self.batch_size, n))]
            metas = [{k: s[k] for k in META_KEYS} for s in samples]
            while len(metas) < self.batch_size:
                metas.append(dict(metas[-1], img_id=-1))
            yield samples, metas

    def _iter_prefetch(self):
        """Decode up to ``prefetch`` batches ahead in a background thread (the
        num_workers analogue of the reference's torch DataLoader). An error
        in the thread is raised here."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        failure: List[BaseException] = []

        def worker():
            try:
                for item in self._iter_sync():
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
