"""Iterator batching engines: the async host->device feed pattern.

Reference: core stages/Batchers.scala:12-153 — `DynamicBufferedBatcher`
(background prefetch thread + BlockingQueue), `FixedBufferedBatcher`,
`FixedBatcher`, `TimeIntervalBatcher`.  A copy of the JAX package's
`core/batching.py` for this package: they drive double-buffered
host-to-device feeds, so that host batching overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, TypeVar

from .telemetry import gauge

T = TypeVar("T")

__all__ = [
    "fixed_batcher",
    "FixedBufferedBatcher",
    "DynamicBufferedBatcher",
    "time_interval_batcher",
    "buffered_prefetch",
]


def buffered_prefetch(it: Iterable[T], buffer_size: int = 2) -> Iterator[T]:
    """Run `it` on a background thread, keeping up to `buffer_size` items
    ready — the double-buffered host->device feed (Batchers.scala:65): host
    batch assembly overlaps device compute of the previous batch.
    """
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    err: List[BaseException] = []

    def run():
        try:
            for x in it:
                q.put(x)
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=run, daemon=True,
                     name="stream-iter-producer").start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def fixed_batcher(it: Iterable[T], batch_size: int) -> Iterator[List[T]]:
    """FixedBatcher (Batchers.scala:117): eager fixed-size chunks."""
    batch: List[T] = []
    for x in it:
        batch.append(x)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch


class _BufferedBatcherBase:
    _SENTINEL = object()

    def __init__(self, buffer_size: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._err: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._consumed = False

    def _mark_consumed(self):
        if self._consumed:
            raise RuntimeError(
                f"{type(self).__name__} is single-use and already consumed"
            )
        self._consumed = True

    def _start(self, producer):
        def run():
            try:
                producer()
            except BaseException as e:  # noqa: BLE001 — forwarded to consumer
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="stream-batch-prefetch")
        self._thread.start()

    def __iter__(self):
        self._mark_consumed()
        while True:
            item = self._q.get()
            # depth after the take: >0 sustained means the producer is
            # running ahead (prefetch working); pinned at 0 means the
            # consumer is starved
            gauge("core.batching.queue.depth").set(self._q.qsize())
            if item is self._SENTINEL:
                if self._err is not None:
                    raise self._err
                return
            yield item


class FixedBufferedBatcher(_BufferedBatcherBase):
    """Fixed-size batches built on a background thread (double buffering).

    Reference: Batchers.scala:65 (FixedBufferedBatcher).
    """

    def __init__(self, it: Iterable[T], batch_size: int, buffer_size: int = 2):
        super().__init__(buffer_size)
        self.batch_size = batch_size

        def produce():
            for b in fixed_batcher(it, batch_size):
                self._q.put(b)

        self._start(produce)


class DynamicBufferedBatcher(_BufferedBatcherBase):
    """Drain-queue batching: the producer thread enqueues single elements;
    the consumer drains everything currently available into one batch —
    batch size adapts to the consumer/producer speed ratio.

    Reference: Batchers.scala:12 (DynamicBufferedBatcher).
    """

    def __init__(self, it: Iterable[T], max_buffer: int = 1024):
        super().__init__(max_buffer)

        def produce():
            for x in it:
                self._q.put(x)

        self._start(produce)

    def __iter__(self):
        self._mark_consumed()
        done = False
        while not done:
            batch: List[T] = []
            item = self._q.get()  # block for at least one
            if item is self._SENTINEL:
                break
            batch.append(item)
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is self._SENTINEL:
                    done = True
                    break
                batch.append(item)
            if batch:
                yield batch
        if self._err is not None:
            raise self._err


def time_interval_batcher(
    it: Iterable[T], interval_ms: float, max_batch: Optional[int] = None
) -> Iterator[List[T]]:
    """TimeIntervalBatcher (Batchers.scala:131): flush every `interval_ms`."""
    batch: List[T] = []
    deadline = time.monotonic() + interval_ms / 1e3
    for x in it:
        batch.append(x)
        now = time.monotonic()
        if now >= deadline or (max_batch and len(batch) >= max_batch):
            yield batch
            batch = []
            deadline = now + interval_ms / 1e3
    if batch:
        yield batch
