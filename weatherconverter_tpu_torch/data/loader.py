"""Host-side batching and prefetching loader (port of
weatherconverter_tpu/data/loader.py).

JAX's semantics, kept: the index order of each epoch is
`np.random.default_rng((seed, epoch)).shuffle(np.arange(n))`, where `epoch`
counts the `__iter__` calls; `drop_last` by default; a producer thread
decodes each batch (the dataset's `get_batch` fast path first, its
`__getitem__` on a thread pool when that returns None) into a bounded
prefetch queue; a producer error is raised in the consumer; a consumer that
stops mid-epoch stops the producer and drains the queue, so no thread
outlives the iteration.

The port's additions, which its loops need: batches arrive as CPU tensors
(pinned with `pin_memory`, so the copy to the card can be asynchronous);
`rows` keeps this rank's rows of every global batch
(parallel.sharding.local_rows), so each rank decodes only its rows of one
shared order; `pad_ragged` pads a ragged last batch to the global size by
repeating its last index and hands the dataset (index, is_pad) keys.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


def _stack(samples):
    if isinstance(samples[0], (tuple, list)):
        return tuple(_stack([s[i] for s in samples]) for i in range(len(samples[0])))
    if isinstance(samples[0], torch.Tensor):
        return torch.stack(samples)
    return np.stack(samples)


def _to_tensors(batch, pin: bool):
    if isinstance(batch, tuple):
        return tuple(_to_tensors(b, pin) for b in batch)
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(batch))
    return t.pin_memory() if pin else t


class _LoaderError:
    """Producer-thread exception carrier (unambiguous against tuple batches)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DataLoader:
    """Shuffling, batching, prefetching iterator over an indexable dataset.

    `batch_size` is the global batch. `rows` (None: all) are the positions of
    each global batch this process takes, in its order. A ragged last batch
    (drop_last False) is yielded as it is, which only a loader taking every
    row can do, unless `pad_ragged`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0, num_workers: int = 8,
                 prefetch: int = 4, drop_last: bool = True, rows: Optional[Sequence[int]] = None,
                 pad_ragged: bool = False, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rows = None if rows is None or list(rows) == list(range(batch_size)) else list(rows)
        self.pad_ragged = pad_ragged
        self.pin_memory = pin_memory
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> list[np.ndarray]:
        """This epoch's global batches of indices (JAX's order)."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        nb = len(self)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]

    def _keys(self, bidx: np.ndarray):
        """The dataset keys this process decodes of one global batch."""
        if self.pad_ragged:
            pad = self.batch_size - len(bidx)
            keys = [(int(i), False) for i in bidx] + [(int(bidx[-1]), True)] * pad
            return keys if self.rows is None else [keys[r] for r in self.rows]
        if self.rows is None:
            return bidx
        if len(bidx) < self.batch_size:
            raise ValueError("a ragged global batch over a mesh needs pad_ragged")
        return bidx[self.rows]

    def __iter__(self) -> Iterator:
        batches = [self._keys(b) for b in self._index_batches()]
        self.epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        get_batch = getattr(self.dataset, "get_batch", None)

        def put(item) -> bool:
            # a bounded-wait put, so that a consumer that stopped (break
            # mid-epoch) wakes the producer through `stop` instead of leaving
            # it parked in a blocking put forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for keys in batches:
                        if stop.is_set():
                            return
                        # the dataset's batch fast path (the native decoder's
                        # C++ threads); None: decode this batch on the pool
                        batch = get_batch(keys) if get_batch is not None else None
                        if batch is None:
                            batch = _stack(list(pool.map(self.dataset.__getitem__, keys)))
                        if not put(_to_tensors(batch, self.pin_memory)):
                            return
                put(None)
            except BaseException as e:  # re-raised in the consumer: a dead producer would hang it
                put(_LoaderError(e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _LoaderError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            # drain, so that a producer blocked in put() exits promptly
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.05)


def infinite_batches(loader: DataLoader) -> Iterator:
    """An epoch-crossing stream (each pass reshuffles with the epoch counter)."""
    while True:
        yield from loader
