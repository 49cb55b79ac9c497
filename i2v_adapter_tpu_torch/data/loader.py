"""Threaded prefetching data loader (host side, numpy batches).

The port's copy of the JAX package's ``data/loader.py``: items are decoded
and preprocessed in a pool of Python threads (OpenCV and the native
library release the GIL), batched in order by ``default_collate``, and
handed out through a bounded queue.  The order is reshuffled each epoch
with ``np.random.default_rng(seed + epoch)``.  Batches stay numpy; the
training driver moves them to the card.

One deviation: the JAX loader's threads decode the whole epoch as fast as
they can, holding every batch the consumer has not taken yet (a WebVid
epoch would not fit in host memory); here at most ``prefetch +
num_workers`` batches are decoded ahead.  The batches and their order are
the same.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np


def default_collate(samples: Sequence[dict]) -> dict:
    """Stack array fields, list the others (captions)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = list(vals)
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        collate_fn: Callable = default_collate,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.collate_fn = collate_fn
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1

        batches = [
            order[i : i + self.batch_size]
            for i in range(0, n - (self.batch_size - 1 if self.drop_last else 0), self.batch_size)
        ]
        if not batches:
            return iter(())

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        idx_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            idx_q.put((bi, b))
        results: dict = {}
        results_lock = threading.Lock()
        stop = threading.Event()
        # batches decoded and not yet taken by the consumer: at most this many
        slots = threading.Semaphore(self.prefetch + self.num_workers)

        def worker():
            while not stop.is_set():
                if not slots.acquire(timeout=0.05):
                    continue
                try:
                    bi, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                batch = self.collate_fn([self.dataset[int(i)] for i in idxs])
                with results_lock:
                    results[bi] = batch

        for _ in range(self.num_workers):
            threading.Thread(target=worker, daemon=True).start()

        def emitter():
            next_bi = 0
            try:
                while next_bi < len(batches) and not stop.is_set():
                    with results_lock:
                        batch = results.pop(next_bi, None)
                    if batch is None:
                        stop.wait(0.005)
                        continue
                    out_q.put(batch)
                    next_bi += 1
            finally:
                out_q.put(None)

        threading.Thread(target=emitter, daemon=True).start()

        def gen():
            try:
                while True:
                    item = out_q.get()
                    if item is None:
                        return
                    slots.release()
                    yield item
            finally:
                stop.set()

        return gen()


class ShardedBatcher:
    """Per-process shards of a global batch: process i takes rows
    ``[i * b_local, (i + 1) * b_local)``."""

    def __init__(self, loader: DataLoader, process_index: int, process_count: int):
        if loader.batch_size % process_count != 0:
            raise ValueError("global batch not divisible by process count")
        self.loader = loader
        self.process_index = process_index
        self.process_count = process_count

    def __iter__(self):
        b = self.loader.batch_size // self.process_count
        lo = self.process_index * b
        for batch in self.loader:
            yield {k: v[lo : lo + b] for k, v in batch.items()}
