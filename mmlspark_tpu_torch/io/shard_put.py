"""Sharded direct-to-device transfers: each rank moves its own shard.

Counterpart of the JAX package's `io/shard_put.py`.  The JAX package is
single-controller: one process splits a host batch along its shard
boundaries and dispatches one `device_put` per addressable device.  The
port is SPMD (parallel/mesh.py): one process a rank, each driving one
device, every rank passing the same host batch.  So here a rank's
"addressable shards" are one — its own block — and the engine moves
exactly those rows:

  * **Per-shard puts.**  `shard_layout(sharding, shape)` gives this
    rank's (device, index); the block is staged and copied to the
    rank's device, and the global tensor is a `DTensor` built with
    `DTensor.from_local` over that block — no gather, no second copy.
    The ranks' copies run at once across processes: one transfer stream
    per card instead of one for the host.
  * **A transfer pool.**  The copies run on a process-wide pool of
    daemon threads (`feed-shard-<i>`, one per device this process
    drives, a bounded task queue), so a feed's host thread never blocks
    on the link; `run_all` re-raises the first error only after every
    task has settled.
  * **Pinned, size-bucketed staging.**  A shard is copied into a
    reusable power-of-two bucket (from 64 KiB) of page-locked host
    memory and moved with one `non_blocking` copy on the engine's side
    stream.  A CUDA event recorded after the copy fences the bucket: it
    is rewritten only after that copy is done.  On a CPU device
    `torch.from_numpy` aliases host memory for the life of the tensor,
    so there a used bucket is discarded, never recycled
    (`_host_aliasing`) — a fence orders a copy, it cannot un-alias.
  * **The ladder underneath.**  Every shard put crosses the
    `feed.shard_put` fault point behind a `core.flow.StagePolicy` retry
    rung; a shard that exhausts its retries raises `ShardTransferError`
    and the owning `DeviceFeed` degrades the group (then itself) to the
    coalesced single-put path.

Telemetry rides the declared `io.feed.shard.*` series; per-shard
bandwidth lands in `FeedTelemetry` (`shard_gbps`, `transfer_concurrency`).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import telemetry as core_telemetry
from ..utils.faults import fault_point
from ..utils.sync import make_lock

__all__ = ["ShardEngine", "ShardTransferError", "StagingBuckets",
           "transfer_pool", "shard_layout"]

_BUCKET_MIN = 1 << 16  # smallest staging bucket: 64 KiB


class ShardTransferError(Exception):
    """A shard transfer failed after its full retry ladder; the caller
    (DeviceFeed) degrades the group to the coalesced path."""


# ---------------------------------------------------------------------------
# The transfer pool: shared process-wide (every DeviceFeed's shard copies
# ride it).
# ---------------------------------------------------------------------------
class _Task:
    """One submitted transfer: callable + completion latch.  Hand-rolled
    (not concurrent.futures) so the queue stays bounded and the shared
    state is lockset-visible to graftsan."""

    __slots__ = ("fn", "result", "error", "done")

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()


class _TransferPool:
    """Bounded pool of `workers` daemon transfer threads.  Submissions
    block when the task queue is full (backpressure, never unbounded
    memory); `run_all` dispatches a group and waits for every member,
    re-raising the first error AFTER all have settled so no shard's
    device buffer is abandoned mid-flight."""

    def __init__(self, workers: int):
        self.workers = max(1, int(workers))
        self._q: "queue.Queue[_Task]" = queue.Queue(maxsize=4 * self.workers)
        self._lock = make_lock("io.feed.shard.pool")
        self._inflight = 0  #: guarded-by self._lock
        self._inflight_hw = 0  #: guarded-by self._lock
        for i in range(self.workers):
            threading.Thread(target=self._work, daemon=True,
                             name=f"feed-shard-{i}").start()

    def _work(self):
        while True:
            task = self._q.get()
            try:
                task.result = task.fn()
            except BaseException as e:  # noqa: BLE001 — relayed to submitter
                task.error = e
            finally:
                with self._lock:
                    self._inflight -= 1
                task.done.set()

    def submit(self, fn: Callable[[], Any]) -> _Task:
        task = _Task(fn)
        with self._lock:
            self._inflight += 1
            if self._inflight > self._inflight_hw:
                self._inflight_hw = self._inflight
        self._q.put(task)
        core_telemetry.gauge("io.feed.shard.queue.depth").set(
            self._q.qsize())
        return task

    def concurrency_high_water(self) -> int:
        with self._lock:
            return self._inflight_hw

    def run_all(self, fns: List[Callable[[], Any]]) -> List[Any]:
        tasks = [self.submit(fn) for fn in fns]
        for t in tasks:
            t.done.wait()
        for t in tasks:
            if t.error is not None:
                raise t.error
        return [t.result for t in tasks]


_POOL_LOCK = make_lock("io.feed.shard.pool_registry")
_POOL: Dict[str, _TransferPool] = {}  #: guarded-by _POOL_LOCK


def transfer_pool(workers: Optional[int] = None) -> _TransferPool:
    """The process-wide transfer pool, sized on first use to the devices
    this process drives — one: a rank drives one device — or `workers`.
    One pool for every feed: the link's parallelism is a host resource,
    not a per-consumer one."""
    with _POOL_LOCK:
        pool = _POOL.get("pool")
        if pool is None:
            pool = _TransferPool(1 if workers is None else workers)
            _POOL["pool"] = pool
        return pool


# ---------------------------------------------------------------------------
# Size-bucketed staging buffers (the pinned host side of the path).
# ---------------------------------------------------------------------------
def _bucket_size(nbytes: int) -> int:
    b = _BUCKET_MIN
    while b < nbytes:
        b <<= 1
    return b


class _StagingBuf:
    """One staging buffer: `host` (page-locked on the card's path) and
    `buf`, its numpy view; `fence` is the event of the last copy out of
    it (anything with `.synchronize()`), waited on before reuse."""

    __slots__ = ("host", "buf", "pinned", "fence")

    def __init__(self, nbytes: int, pinned: bool):
        self.pinned = bool(pinned)
        self.host = torch.empty(nbytes, dtype=torch.uint8,
                                pin_memory=self.pinned)
        self.buf = self.host.numpy()
        self.fence: Any = None


class StagingBuckets:
    """Reusable power-of-two-bucketed host staging buffers.

    `acquire(nbytes, pinned)` hands out a buffer of the next bucket size
    up (free-listed per bucket; steady state allocates nothing) and
    `release(buf, fence)` returns it carrying the event of the copy that
    must complete before the bytes may be rewritten.  Page-locked pages
    are what a `non_blocking` host-to-device copy needs, and what makes
    reuse (not reallocation) matter: pinning is the expensive part."""

    def __init__(self, max_per_bucket: int = 16):
        self.max_per_bucket = int(max_per_bucket)
        self._lock = make_lock("io.feed.shard.staging")
        self._free: Dict[Tuple[int, bool], List[_StagingBuf]] = {}  #: guarded-by self._lock
        self._allocated = 0  #: guarded-by self._lock

    def discard(self, sb: _StagingBuf) -> None:
        """Drop a buffer whose bytes now BACK a live tensor (a CPU
        device's `torch.from_numpy` alias): it must never re-enter a free
        list — a fence orders the copy but cannot un-alias the memory."""
        with self._lock:
            self._allocated -= 1

    def acquire(self, nbytes: int, pinned: bool = False) -> _StagingBuf:
        size = _bucket_size(nbytes)
        with self._lock:
            free = self._free.get((size, bool(pinned)))
            if free:
                sb = free.pop()
            else:
                sb = None
                self._allocated += 1
        if sb is None:
            sb = _StagingBuf(size, pinned)
        if sb.fence is not None:
            sb.fence.synchronize()
            sb.fence = None
        return sb

    def release(self, sb: _StagingBuf, fence: Any = None) -> None:
        sb.fence = fence
        key = (len(sb.buf), sb.pinned)
        with self._lock:
            self._free.setdefault(key, []).append(sb)
            # bound the pool: beyond max_per_bucket the oldest buffer is
            # dropped to the allocator (bursts must not pin memory forever)
            if len(self._free[key]) > self.max_per_bucket:
                self._free[key].pop(0)
                self._allocated -= 1

    def allocated(self) -> int:
        with self._lock:
            return self._allocated


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------
def _host_aliasing(device: torch.device) -> bool:
    """True when a "copy" to `device` aliases host memory for the life of
    the tensor (a CPU device: `torch.from_numpy`) rather than moving the
    bytes.  Staged buffers must then be discarded, never recycled —
    rewriting one would rewrite the shard it backs."""
    return device.type == "cpu"


def shard_layout(sharding, shape) -> Optional[List[Tuple[Any, tuple]]]:
    """[(device, index)] of this rank's shard, or None when `shape` does
    not divide evenly — `parallel.mesh.addressable_shard_layout`,
    re-exported at the transfer engine's door."""
    from ..parallel.mesh import addressable_shard_layout

    return addressable_shard_layout(sharding, shape)


def _global_tensor(local: torch.Tensor, sharding, shape) -> Any:
    """The DTensor over `sharding`'s mesh whose local block is `local`
    (no copy: `from_local` keeps the block's storage)."""
    from torch.distributed.tensor import DTensor

    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, step)
        step *= int(n)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=tuple(shape),
                              stride=tuple(stride))


class ShardEngine:
    """This rank's shard put under a retry ladder.

    One engine per `DeviceFeed`; the transfer pool and staging buckets
    it uses are process-wide.  `put_sharded` raises
    `ShardTransferError` when the shard exhausts its retries — the
    owning feed degrades that group (and then itself) to the coalesced
    single-put path."""

    def __init__(self, policy=None, telemetry=None,
                 staging: Optional[StagingBuckets] = None,
                 min_shard_bytes: int = 1 << 12):
        from .feed import FEED_TELEMETRY

        self.policy = policy
        self.telemetry = telemetry if telemetry is not None else FEED_TELEMETRY
        self.staging = staging if staging is not None else _STAGING
        # below this per-shard size the fixed per-put cost dominates the
        # parallelism win; the caller should coalesce instead
        self.min_shard_bytes = int(min_shard_bytes)
        self._streams: Dict[Any, Any] = {}

    # ---- planning ------------------------------------------------------
    def plan(self, arr: np.ndarray, sharding) -> Optional[List[Tuple[Any, tuple]]]:
        """This rank's shard layout when the sharded path applies: an
        evenly-divisible batch and a shard big enough that the per-put
        overhead stays amortized."""
        if sharding is None:
            return None
        layout = shard_layout(sharding, arr.shape)
        if layout is None:
            return None
        if arr[layout[0][1]].nbytes < self.min_shard_bytes:
            return None
        return layout

    def _stream(self, device: torch.device):
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device)
        return s

    def _copy(self, view: np.ndarray, host: Optional[torch.Tensor],
              device: torch.device):
        """One shard's bytes to `device`: (tensor, fence event or None)."""
        if device.type == "cpu":
            return torch.from_numpy(view), None
        stream = self._stream(device)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            out = torch.empty(view.shape, dtype=host.dtype, device=device)
            out.copy_(host, non_blocking=True)
            fence = torch.cuda.Event()
            fence.record(stream)
        return out, fence

    # ---- the guarded per-shard put -------------------------------------
    def _put_shard(self, view: np.ndarray, host: Optional[torch.Tensor],
                   device: torch.device):
        """One shard's transfer: the `feed.shard_put` fault point behind
        the engine's StagePolicy retry rung; exhaustion surfaces as
        ShardTransferError for the feed's degrade rung."""
        def attempt(v):
            fault_point("feed.shard_put")
            return self._copy(v, host, device)

        t0 = time.perf_counter()
        try:
            if self.policy is not None:
                out = self.policy.run(attempt, view)
            else:
                out = attempt(view)
        except Exception as e:  # noqa: BLE001 — mapped to the degrade rung
            raise ShardTransferError(
                f"shard transfer to {device} failed after retries: {e}"
            ) from e
        dt = time.perf_counter() - t0
        core_telemetry.incr("io.feed.shard.puts")
        core_telemetry.histogram("io.feed.shard.latency").observe(dt)
        core_telemetry.histogram(
            "io.feed.shard.bytes",
            boundaries=core_telemetry.BYTE_BUCKETS).observe(view.nbytes)
        return out, dt

    # ---- the sharded group put -----------------------------------------
    def put_sharded(self, arr: np.ndarray, sharding,
                    layout: Optional[List[Tuple[Any, tuple]]] = None):
        """`arr` (the same host batch on every rank) -> one DTensor under
        `sharding`: this rank's block moved to its device through the
        pool, assembled with `DTensor.from_local` (no further copy)."""
        from .feed import _torch_dtype

        if layout is None:
            layout = self.plan(arr, sharding)
        if layout is None:
            raise ShardTransferError(
                f"shape {arr.shape} does not shard evenly under {sharding}")
        pool = transfer_pool()
        staged: List[Tuple[np.ndarray, Optional[torch.Tensor],
                           Optional[_StagingBuf]]] = []
        for dev, idx in layout:
            piece = arr[idx]
            if dev.type == "cpu" and piece.flags["C_CONTIGUOUS"] \
                    and piece.base is None:
                # already its own contiguous buffer: stage-free
                staged.append((piece, None, None))
                continue
            sb = self.staging.acquire(piece.nbytes,
                                      pinned=dev.type == "cuda")
            view = sb.buf[:piece.nbytes].view(piece.dtype).reshape(piece.shape)
            np.copyto(view, piece)
            host = (sb.host[:piece.nbytes].view(_torch_dtype(piece.dtype))
                    .view(piece.shape) if dev.type == "cuda" else None)
            staged.append((view, host, sb))
        t0 = time.perf_counter()
        try:
            results = pool.run_all([
                (lambda v=view, h=host, d=dev: self._put_shard(v, h, d))
                for (dev, _idx), (view, host, _sb) in zip(layout, staged)])
        except ShardTransferError:
            for _view, _host, sb in staged:
                if sb is not None:
                    self.staging.release(sb)
            raise
        wall = time.perf_counter() - t0
        shards = [r[0][0] for r in results]
        put_s = sum(r[1] for r in results)
        for (dev, _idx), (_view, _host, sb), ((shard, fence), _dt) in zip(
                layout, staged, results):
            if fence is not None:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(fence)
                # allocated on the side stream, used on the compute stream
                shard.record_stream(compute)
            if sb is None:
                continue
            if _host_aliasing(dev):
                self.staging.discard(sb)
            else:
                self.staging.release(sb, fence=fence)
        out = _global_tensor(shards[0], sharding, arr.shape)
        nbytes = sum(s.nbytes for s, _h, _b in staged)
        hw = pool.concurrency_high_water()
        self.telemetry.add(bytes_moved=nbytes, transfer_calls=len(shards),
                           transfer_s=wall, shard_puts=len(shards),
                           shard_bytes=nbytes, shard_wall_s=wall,
                           shard_put_s=put_s, sharded_groups=1)
        self.telemetry.note_max(transfer_concurrency=min(len(shards), hw))
        core_telemetry.gauge("io.feed.shard.concurrency").set(hw)
        return out


# process-wide staging buckets: the pinned pages are a host resource
_STAGING = StagingBuckets()
