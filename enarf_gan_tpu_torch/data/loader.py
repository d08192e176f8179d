"""Host-side batch loader with background prefetch (the port's own copy of
``enarf_gan_tpu/data/loader.py``): shuffling, drop-last numpy batches,
assembled ahead of time by a thread."""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


def collate(items) -> Dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]}


class DataLoader:
    """Shuffling, drop-last batch iterator with thread prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.num_prefetch = num_prefetch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _index_iter(self):
        n = len(self.dataset)
        idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
        stop = n - n % self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield idx[s:s + self.batch_size]

    def _make_batch(self, batch_idx):
        return collate([self.dataset[int(i)] for i in batch_idx])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_prefetch <= 0:
            for bi in self._index_iter():
                yield self._make_batch(bi)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        sentinel = object()

        def producer():
            try:
                for bi in self._index_iter():
                    q.put(self._make_batch(bi))
            finally:
                q.put(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
