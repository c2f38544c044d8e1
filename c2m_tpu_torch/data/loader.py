"""Batching loader with background prefetch and deterministic host sharding:
the port's copy of ``c2m_tpu/data/loader.py`` (``tests/test_torch_data.py``
holds the index orders to the original), with two additions for the
trainer:

- ``set_epoch(epoch, start)`` begins the epoch's iteration at batch
  ``start`` of the same shuffled order, so that a resumed run takes the
  batches an unbroken run would have taken next. The batches before it
  are skipped in the index list, never loaded.
- ``pin_memory=True`` hands out each array as a torch tensor in page-locked
  host memory, collated there by the worker thread, so that the step's copy
  to the card can be ``non_blocking``. ``"names"`` stays a list on the
  host.

Samples are padded dense numpy arrays, so collation is a plain stack; a
thread pool overlaps decode with device compute; shuffling is epoch-seeded
(``DistributedSampler.set_epoch`` parity); with several hosts each reads
its disjoint shard.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np
import torch


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    names = [s.get("name") for s in samples]
    for key in samples[0]:
        if key == "name":
            continue
        out[key] = np.stack([s[key] for s in samples])
    if names[0] is not None:
        out["names"] = names  # host-side metadata, stripped before device put
    return out


def collate_pinned(samples: List[Dict[str, np.ndarray]]) -> Dict[str, object]:
    """:func:`collate` into tensors in page-locked host memory: each key's
    batch is allocated pinned and filled by torch copies, which release the
    interpreter lock (``np.stack`` holds it for the whole copy, and the
    train step's host thread waits on it)."""
    out: Dict[str, object] = {}
    for key in samples[0]:
        if key == "name":
            continue
        rows = [torch.from_numpy(np.asarray(s[key])) for s in samples]
        buf = torch.empty((len(rows),) + tuple(rows[0].shape),
                          dtype=rows[0].dtype, pin_memory=True)
        for i, row in enumerate(rows):
            buf[i].copy_(row)
        out[key] = buf
    if samples[0].get("name") is not None:
        out["names"] = [s.get("name") for s in samples]
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, drop_last: bool = True,
                 host_id: int = 0, num_hosts: int = 1, prefetch: int = 2,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0
        self.start = 0

    def set_epoch(self, epoch: int, start: int = 0) -> None:
        """Shuffle for ``epoch``; iteration begins at batch ``start``."""
        self.epoch = epoch
        self.start = start

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # disjoint host shard (DistributedSampler parity): pad to a multiple
        # of num_hosts by wrapping, then stride.
        if self.num_hosts > 1:
            pad = (-n) % self.num_hosts
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.host_id::self.num_hosts]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def batch_indices(self) -> List[np.ndarray]:
        """The dataset indices of each batch this iteration yields, in
        order (the epoch's batches from ``start`` on)."""
        idx = self._indices()
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(self.start, len(self))]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self.batch_indices()
        nb = len(batches)

        def load_batch(batch_idx):
            samples = [self.dataset[int(i)] for i in batch_idx]
            return collate_pinned(samples) if self.pin_memory else \
                collate(samples)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = queue.Queue()
            it = iter(batches)
            for _ in range(min(self.prefetch, nb)):
                futures.put(pool.submit(load_batch, next(it)))
            produced = min(self.prefetch, nb)
            done = 0
            while done < nb:
                fut = futures.get()
                if produced < nb:
                    futures.put(pool.submit(load_batch, next(it)))
                    produced += 1
                done += 1
                yield fut.result()
