"""Micro-batching executor for the server (port of
weatherconverter_tpu/serving/batcher.py; a copy, the port imports nothing of
the JAX package).

On the card a guided translation costs nearly the same at batch 1 as at
batch 4 while the host binds the step (PERF.md section 5: the device idles
most of each step), so the server groups requests: they queue; a worker
drains up to `max_batch` of them, waiting at most `max_wait_ms` for
stragglers, runs ONE batched chain and hands each request its own result.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence


@dataclass
class _Pending:
    args: tuple
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None


class MicroBatcher:
    """Groups concurrent single-item requests into device batches.

    `batch_fn(list_of_args) -> list_of_results` is called on the worker
    thread with 1..max_batch request-args tuples; it owns padding to a
    batch width and slicing the results back apart.
    """

    def __init__(
        self,
        batch_fn: Callable[[Sequence[tuple]], Sequence[Any]],
        max_batch: int = 8,
        max_wait_ms: float = 20.0,
    ):
        self._batch_fn = batch_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self.stats = {"requests": 0, "batches": 0, "batch_occupancy_sum": 0}
        self._thread.start()

    def submit(self, *args) -> Any:
        """Blocking call from a request-handler thread; returns the result."""
        p = _Pending(args=args)
        self._queue.put(p)
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self._batch_fn([p.args for p in batch])
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:  # propagate to every waiter
                for p in batch:
                    p.error = e
            finally:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["batch_occupancy_sum"] += len(batch)
                for p in batch:
                    p.event.set()
