"""DeviceFeed: the host->device transfer engine for one CUDA device.

Counterpart of the JAX package's `io/feed.py` for the transform path.
Chunks arrive from a producer (a plain iterable on one prefetch thread,
or a HostPipeline's assembly workers through the `FeedSource` protocol);
each is copied to the device, the consumer's `compute_fn` is enqueued on
it, and its result is fetched back asynchronously:

  * **uint8 wire.**  The engine is dtype-preserving: image paths feed
    uint8 end to end (4x fewer bytes than f32) and the consumer does the
    cast/resize/normalize on the device (ImagePreprocess).
  * **Pinned staging ring.**  Each chunk is written into a page-locked
    host slot taken round robin from a ring of `depth + 1` slots per
    chunk shape — no per-batch pinned allocation — and copied with a
    `non_blocking` copy on a side stream, so the copy of chunk N+1
    overlaps the forward of chunk N.  A CUDA event recorded after the
    copy fences both ends: the compute stream waits on it before using
    the chunk, and the host waits on it before rewriting the slot.
  * **Bounded depth.**  `depth` chunks are in flight (enqueued, their
    device-to-host result copy started); the oldest drains when the
    window fills.
  * **Telemetry.**  Bytes moved, transfer calls/seconds, stall seconds
    and compute dispatch seconds accumulate in `FEED_TELEMETRY`.
    `transfer_s` is host-visible time (slot write + copy enqueue),
    `compute_s` the dispatch time of `compute_fn`, and `stall_drain_s`
    the time the host waits for results — the device time the host did
    not hide.
  * **Fault tolerance.**  Every transfer sits behind the
    `feed.device_put` fault point with a bounded retry
    (`core.flow.StagePolicy`, tiny backoff).

`put_group` is the decode tick's upload: several small host arrays
(token, positions, page table) byte-pack into ONE pinned ring slot at
the JAX package's 128-byte alignment, move in one copy, and are sliced
and bitcast apart on the device.  Unlike the JAX package it never
degrades to per-array puts: a copy that still fails after the retry
ladder raises.  `stream` is the train loops' feed: one `put_group` per
item (a slice of stacked minibatches and their labels), `depth` items
ahead of the consumer.

On a CPU device the same code runs with `torch.from_numpy` in place of
the copies (the path the CPU tests drive).  The JAX package's coalescing
of several chunks into one transfer, its sharded multi-device puts and
its compressed (RLE) wire are not ported: on one card a pinned copy per
chunk costs microseconds, and the compressed wire waits for its decode
kernel (B3, ROADMAP slice 5).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import telemetry as core_telemetry
from ..core.flow import StagePolicy
from ..utils.faults import fault_point
from ..utils.sync import make_lock

__all__ = ["DeviceFeed", "FeedTelemetry", "FEED_TELEMETRY", "FeedSource",
           "FEED_END"]

# terminal marker a FeedSource returns once its stream is exhausted
FEED_END = object()

_ALIGN = 128  # put_group's byte-pack offset alignment (the JAX package's)


class FeedSource:
    """Protocol for multi-producer chunk sources driving `DeviceFeed.run`.

      * ``start()``    — begin producing (called once by `run`).
      * ``get()``      — block until the next (chunk, n_valid) item, or
                         return ``FEED_END`` when the stream is done
                         (terminal: keep returning it).
      * ``error()``    — the producer-side exception to re-raise after
                         in-flight work drains, or None.

    Plain iterables passed to `run()` are wrapped in `_IterSource`."""

    def start(self) -> None:
        raise NotImplementedError

    def get(self):
        raise NotImplementedError

    def error(self) -> Optional[BaseException]:
        return None


class _IterSource(FeedSource):
    """One daemon thread drains `chunk_iter` into a bounded queue
    (assembly overlaps device compute; backpressure via maxsize)."""

    def __init__(self, chunk_iter: Iterable, maxsize: int):
        self._it = chunk_iter
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._err: List[BaseException] = []

    def start(self):
        threading.Thread(target=self._produce, daemon=True,
                         name="device-feed-producer").start()

    def _produce(self):
        try:
            for item in self._it:
                self._q.put(item)
                core_telemetry.gauge("io.feed.queue.depth").set(
                    self._q.qsize())
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            self._err.append(e)
        finally:
            self._q.put(FEED_END)

    def _terminal(self, item):
        if item is FEED_END:
            self._q.put(FEED_END)  # stay terminal for later gets
        return item

    def get(self):
        return self._terminal(self._q.get())

    def error(self) -> Optional[BaseException]:
        return self._err[0] if self._err else None


class FeedTelemetry:
    """Thread-safe monotonic counters for the feed engine."""

    _FIELDS = ("bytes_moved", "transfer_calls", "transfer_s", "chunks_fed",
               "stall_decode_s", "stall_drain_s", "compute_s", "wall_s")

    def __init__(self):
        self._lock = make_lock("io.feed.telemetry")
        self._c: Dict[str, float] = {f: 0.0 for f in self._FIELDS}  #: guarded-by self._lock

    def add(self, **kw: float):
        with self._lock:
            for k, v in kw.items():
                self._c[k] += v

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._c)

    def delta(self, since: Dict[str, float]) -> Dict[str, float]:
        now = self.snapshot()
        return {k: now[k] - since.get(k, 0.0) for k in now}


# process-wide default sink: tests and measurement scripts read deltas off this
FEED_TELEMETRY = FeedTelemetry()


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Slot:
    """One pinned staging buffer and the event that fences its reuse."""

    __slots__ = ("host", "fence")

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype):
        self.host = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.fence: Optional[torch.cuda.Event] = None


class DeviceFeed:
    """One host->device feed: pinned ring staging + side-stream copies +
    a bounded in-flight window.  Instances are cheap (rings allocate
    lazily); consumers create one per transform and share the
    process-wide telemetry sink."""

    def __init__(self, device: torch.device, depth: int = 2,
                 telemetry: Optional[FeedTelemetry] = None,
                 transfer_retries: int = 3):
        self.device = torch.device(device)
        self.depth = max(1, int(depth))
        self.telemetry = telemetry if telemetry is not None else FEED_TELEMETRY
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._rings: Dict[Any, List[_Slot]] = {}
        self._ring_pos: Dict[Any, int] = {}
        self._put_policy = StagePolicy(retries=max(1, int(transfer_retries)),
                                       backoff_s=0.001, backoff_cap_s=0.05,
                                       retry_counter="feed.transfer_retry")

    def _obs_transfer(self, nbytes: float, dt: float) -> None:
        core_telemetry.histogram("io.feed.transfer.latency").observe(dt)
        core_telemetry.histogram(
            "io.feed.transfer.bytes",
            boundaries=core_telemetry.BYTE_BUCKETS).observe(nbytes)
        ctx = core_telemetry.current_context()
        if ctx is not None:
            core_telemetry.record_span("feed.transfer", ctx, dt,
                                       bytes=int(nbytes))

    def _acquire_slot(self, shape: Tuple[int, ...], dtype: np.dtype) -> _Slot:
        """The next ring slot for this shape and dtype: `depth + 1` slots,
        reused round robin; a slot's host buffer is rewritten only after
        its previous copy has finished."""
        key = (tuple(shape), np.dtype(dtype).str)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [_Slot(shape, _torch_dtype(dtype))
                                       for _ in range(self.depth + 1)]
        pos = self._ring_pos.get(key, 0)
        self._ring_pos[key] = (pos + 1) % len(ring)
        slot = ring[pos]
        if slot.fence is not None:
            t0 = time.perf_counter()
            slot.fence.synchronize()
            self.telemetry.add(stall_drain_s=time.perf_counter() - t0)
        return slot

    def put(self, chunk: np.ndarray) -> torch.Tensor:
        """One host chunk -> a tensor on the device, ordered before any
        later work on the current stream."""
        chunk = np.ascontiguousarray(chunk)
        t0 = time.perf_counter()
        if not self._cuda:
            def attempt(_):
                fault_point("feed.device_put")
                return torch.from_numpy(chunk)

            x = self._put_policy.run(attempt, None)
        else:
            slot = self._acquire_slot(chunk.shape, chunk.dtype)
            np.copyto(slot.host.numpy(), chunk)
            x = self._copy_in(slot)
        dt = time.perf_counter() - t0
        self.telemetry.add(bytes_moved=chunk.nbytes, transfer_calls=1,
                           transfer_s=dt, chunks_fed=1)
        self._obs_transfer(chunk.nbytes, dt)
        return x

    def _copy_in(self, slot: _Slot) -> torch.Tensor:
        """The slot's host buffer -> a new device tensor: one non-blocking
        copy on the side stream (retried by the transfer policy), fenced
        so the compute stream waits for it and the slot is rewritten only
        after it."""
        def attempt(_):
            fault_point("feed.device_put")
            with torch.cuda.stream(self._stream):
                dev = torch.empty(slot.host.shape, dtype=slot.host.dtype,
                                  device=self.device)
                dev.copy_(slot.host, non_blocking=True)
                fence = torch.cuda.Event()
                fence.record(self._stream)
            return dev, fence

        x, slot.fence = self._put_policy.run(attempt, None)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(slot.fence)
        # allocated on the side stream, used on the compute stream
        x.record_stream(compute)
        return x

    def put_group(self, arrays: Sequence[np.ndarray]
                  ) -> Tuple[torch.Tensor, ...]:
        """Several host arrays -> device tensors in ONE transfer.

        The arrays byte-pack into one uint8 buffer (each at an offset
        aligned to 128 bytes) — on the card a pinned ring slot — which
        moves in one copy and is sliced and `.view(dtype)`'d apart on the
        device.  The arrays are copied into the buffer before the call
        returns, so the caller may mutate them right after."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        layout = []
        off = 0
        for a in arrays:
            layout.append((off, a))
            off += -(-a.nbytes // _ALIGN) * _ALIGN
        total = max(off, _ALIGN)
        t0 = time.perf_counter()
        if self._cuda:
            slot = self._acquire_slot((total,), np.uint8)
            host = slot.host.numpy()
        else:
            host = np.zeros(total, np.uint8)
        for o, a in layout:
            host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        if self._cuda:
            packed = self._copy_in(slot)
        else:
            def attempt(_):
                fault_point("feed.device_put")
                return torch.from_numpy(host)

            packed = self._put_policy.run(attempt, None)
        outs = tuple(packed[o:o + a.nbytes].view(_torch_dtype(a.dtype))
                     .reshape(a.shape) for o, a in layout)
        dt = time.perf_counter() - t0
        self.telemetry.add(bytes_moved=total, transfer_calls=1,
                           transfer_s=dt, chunks_fed=len(arrays))
        self._obs_transfer(total, dt)
        return outs

    def stream(self, items: Iterable[Sequence[np.ndarray]]):
        """Prefetching transfer stream for sequential consumers (train
        loops): yields each item's device tensors (one `put_group`
        transfer per item, a tuple) while up to `depth` later items'
        copies are already enqueued — slice t+1 moves while the steps of
        slice t compute."""
        buf: deque = deque()
        t0 = time.perf_counter()
        for item in items:
            buf.append(self.put_group(tuple(item)))
            while len(buf) > self.depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
        self.telemetry.add(wall_s=time.perf_counter() - t0)

    def run(self, chunk_iter, compute_fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> List[np.ndarray]:
        """Drive (chunk, n_valid) pairs through transfer + compute with
        assembly/transfer/compute overlap; returns each chunk's output as
        a host array trimmed to n_valid, in feed order."""
        tel = self.telemetry
        t_wall = time.perf_counter()
        if isinstance(chunk_iter, FeedSource):
            source = chunk_iter
        else:
            source = _IterSource(chunk_iter, maxsize=2 * self.depth + 2)
        source.start()

        results: List[np.ndarray] = []
        # (host result, n_valid, event marking its copy done) per chunk
        inflight: deque = deque()

        def drain():
            host, n, done = inflight.popleft()
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            results.append(host.numpy()[:n])
            tel.add(stall_drain_s=time.perf_counter() - t0)

        while True:
            t0 = time.perf_counter()
            item = source.get()
            tel.add(stall_decode_s=time.perf_counter() - t0)
            if item is FEED_END:
                break
            chunk, n = item
            x = self.put(chunk)
            t0 = time.perf_counter()
            y = compute_fn(x)
            if self._cuda:
                # start the device->host copy at dispatch so it overlaps
                # later chunks instead of serializing at drain
                host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
                host.copy_(y, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                inflight.append((host, n, done))
            else:
                inflight.append((y, n, None))
            tel.add(compute_s=time.perf_counter() - t0)
            while len(inflight) > self.depth:
                drain()
        while inflight:
            drain()
        tel.add(wall_s=time.perf_counter() - t_wall)
        src_err = source.error()
        if src_err is not None:
            raise src_err
        return results
