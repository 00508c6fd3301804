"""Minimal multi-threaded DataLoader (host-side, framework-free).

Port-side copy of ``diner_tpu/data/loader.py`` (the port imports nothing of
the JAX package): shuffling with an explicit epoch-seeded numpy RNG, a
prefetching worker thread (image decode releases the GIL inside PIL/zlib),
and numpy collation. Non-array fields (names, ids) collate to lists. The
batches, and their order for a seed, are the JAX package's.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack a list of sample dicts into one batch dict (recurses into
    nested dicts, e.g. the MVS per-stage pyramids)."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(first, dict):
            out[key] = collate(vals)
        elif isinstance(first, (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = list(vals)
    return out


class DataLoader:
    """Iterate a map-style dataset in shuffled batches with prefetching.

    Args:
      dataset: object with ``__len__`` and ``__getitem__``.
      batch_size: samples per batch (last partial batch dropped if
        ``drop_last``).
      shuffle: permute sample order each epoch (seeded by ``seed + epoch``).
      num_workers: decode threads; 0 = synchronous.
      prefetch: max batches resident in the queue.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 2, seed: int = 0, drop_last: bool = False,
                 prefetch: int = 2, sample_indices: Optional[List[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self.sample_indices = sample_indices

    def _epoch_indices(self) -> np.ndarray:
        idcs = (np.asarray(self.sample_indices)
                if self.sample_indices is not None
                else np.arange(len(self.dataset)))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idcs = rng.permutation(idcs)
        return idcs

    def __len__(self) -> int:
        n = (len(self.sample_indices) if self.sample_indices is not None
             else len(self.dataset))
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        idcs = self._epoch_indices()
        self.epoch += 1
        batches = [idcs[i:i + self.batch_size]
                   for i in range(0, len(idcs), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        if self.num_workers == 0:
            for b in batches:
                yield collate([self.dataset[int(i)] for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    q.put(collate([self.dataset[int(i)] for i in b]))
            except Exception as e:  # surface decode errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
