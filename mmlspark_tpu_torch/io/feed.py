"""DeviceFeed: the host->device transfer engine.

Counterpart of the JAX package's `io/feed.py`.  Chunks arrive from a
producer (a plain iterable on one prefetch thread, or a HostPipeline's
assembly workers through the `FeedSource` protocol); ready chunks are
copied to the device, the consumer's `compute_fn` is enqueued on each,
and its result is fetched back asynchronously:

  * **Transfer coalescing.**  `run` drains whatever the producer has
    ready (`greedy=True`: it never waits for a fuller pack) and packs up
    to `coalesce` chunks (at most `coalesce_bytes`) into ONE copy: same
    shape and dtype into a `[k, bs, ...]` slot, mixed ones byte-packed
    at 128-byte offsets; the chunks are sliced apart on the device.  A
    decode-bound producer degrades to one chunk a copy with no added
    latency.  Packing needs a data-parallel degree of 1 (`_dp() == 1`).
  * **uint8 wire.**  The engine is dtype-preserving: image paths feed
    uint8 end to end (4x fewer bytes than f32) and the consumer does the
    cast/resize/normalize on the device (ImagePreprocess).
  * **Pinned staging ring.**  A copy's host side is a page-locked slot
    taken round robin from a ring of `depth + 1` slots per wire shape —
    no per-batch pinned allocation — moved with a `non_blocking` copy on
    a side stream, so the copy of group N+1 overlaps the compute of
    group N.  A CUDA event recorded after the copy fences both ends: the
    compute stream waits on it before using the chunks, and the host
    waits on it before rewriting the slot.  On a CPU device
    `torch.from_numpy` aliases host memory, so each copy there gets a
    buffer of its own (the JAX package's `_host_aliasing` rule).
  * **Bounded depth.**  `depth` groups are in flight (enqueued, their
    device-to-host result copies started); the oldest drains when the
    window fills.
  * **A data mesh.**  `DeviceFeed(mesh=...)` feeds a `DeviceMesh` of the
    SPMD substrate (parallel/mesh.py): every rank passes the same host
    chunks and each moves only its own rows — a chunk arrives as a
    `DTensor` sharded on its batch axis over `data`.  A compute result
    that is a `DTensor` is gathered whole (`full_tensor`, rank order)
    before its host copy, so every rank returns every row.  `put` hands
    a data-sharded batch to `io.shard_put.ShardEngine` when the data
    axis holds more than one shard (`shard_strategy="auto"`), or always
    when the strategy is `"sharded"`.
  * **Telemetry.**  Bytes moved, transfer calls/seconds, stall and
    compute dispatch seconds, groups, the sharded path's counters and
    the compressed wire's accumulate in `FEED_TELEMETRY`;
    `FeedTelemetry.summarize` derives the JAX package's fields.  On the
    card each side-stream copy is also timed on the device, by a timing
    event recorded before it and its fence after it, read only once the
    fence is known complete (where a slot's reuse already waits for it,
    or by `query()` when `stream` or `run` ends): `h2d_device_s` and the
    `io.feed.transfer.device_latency` histogram.
  * **Fault tolerance.**  Every copy sits behind the `feed.device_put`
    fault point with a bounded retry (`core.flow.StagePolicy`, tiny
    backoff); every shard put behind `feed.shard_put`.  Two sticky rungs
    of the JAX package's ladder, each counted and warned, keep the work
    on the device: a PACKED transfer of `run` that exhausts its retries
    degrades the feed to unpipelined single puts (`degraded`), and a
    shard group that exhausts its retries degrades it to coalesced puts
    (`shard_degraded`).
  * **A registered flow stage.**  `DeviceFeed.stage()` exposes the h2d
    hop as an `H2DStage` for credit-bounded FlowGraphs.

`put_group` is the decode tick's upload: several small host arrays
(token, positions, page table) byte-pack into ONE pinned ring slot, move
in one copy, and are sliced and viewed apart on the device.  Unlike the
JAX package it never degrades to per-array puts: a copy that still
fails after the retry ladder raises.  `stream` is the train loops' feed:
one `put_group` per item, `depth` items ahead of the consumer.

`put_group` also takes a group of `ops.wire_codec.RLEPayload`s, the
compressed wire: the payloads' values and cumulative-ends tables pack
into one slot and one copy, and kernel B3 decodes each chunk back to its
raw bytes on the card (`compressed_groups`, `wire_bytes_raw` and
`wire_bytes_sent` count it).  A compressed copy that still fails after
its retries raises, like any other.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import warnings
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import telemetry as core_telemetry
from ..core.flow import Stage, StagePolicy
from ..device import resolve_device
from ..parallel.mesh import data_size
from ..utils.faults import fault_point
from ..utils.sync import make_lock

__all__ = ["DeviceFeed", "H2DStage", "FeedTelemetry", "FEED_TELEMETRY",
           "default_depth", "FeedSource", "FEED_END", "FEED_FAULT_POINTS",
           "load_tuned", "host_local_feed"]

# every fault point the feed engine can cross — the chaos soak enumerates
# this alongside flow_fault_points() so its coverage plan cannot go stale
FEED_FAULT_POINTS = ("feed.device_put", "feed.shard_put")

# terminal marker a FeedSource returns once its stream is exhausted
FEED_END = object()

_ALIGN = 128  # byte-pack offset alignment (the JAX package's)


class FeedSource:
    """Protocol for multi-producer chunk sources driving `DeviceFeed.run`.

      * ``start()``     — begin producing (called once by `run`).
      * ``get()``       — block until the next (chunk, n_valid) item, or
                          return ``FEED_END`` when the stream is done
                          (terminal: keep returning it).
      * ``get_nowait()``— same, but raise ``queue.Empty`` instead of
                          blocking when nothing is ready yet.
      * ``error()``     — the producer-side exception to re-raise after
                          in-flight work drains, or None.

    Plain iterables passed to `run()` are wrapped in `_IterSource`."""

    def start(self) -> None:
        raise NotImplementedError

    def get(self):
        raise NotImplementedError

    def get_nowait(self):
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

    def get_nowait(self):
        return self._terminal(self._q.get_nowait())

    def error(self) -> Optional[BaseException]:
        return self._err[0] if self._err else None


def default_depth() -> int:
    """Pipeline depth: groups in flight (MMLSPARK_FEED_DEPTH overrides
    for experiments; the knob every consumer inherits)."""
    try:
        return max(1, int(os.environ.get("MMLSPARK_FEED_DEPTH", "2")))
    except ValueError:
        return 2


_TUNED_LOCK = make_lock("io.feed.tuned")
_TUNED_CACHE: Dict[str, Dict[str, Any]] = {}  #: guarded-by _TUNED_LOCK


def load_tuned() -> Dict[str, Any]:
    """The tuned feed config, read from the MMLSPARK_FEED_TUNED path once
    per process.  Keys: `depth`, `coalesce`, `strategy` — DeviceFeed
    consults them for any knob the caller left at None.  A missing or
    corrupt file is an empty config, not an error: tuning is an
    optimization, never a dependency."""
    path = os.environ.get("MMLSPARK_FEED_TUNED", "")
    if not path:
        return {}
    with _TUNED_LOCK:
        cfg = _TUNED_CACHE.get(path)
        if cfg is None:
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.load(f)
                cfg = doc if isinstance(doc, dict) else {}
            except (OSError, ValueError):
                cfg = {}
            _TUNED_CACHE[path] = cfg
        return cfg


def host_local_feed(model: int = 1, seq: int = 1, device=None,
                    **kwargs) -> "DeviceFeed":
    """A DeviceFeed over this rank's group: `make_mesh(model=, seq=)`
    with every remaining rank on the data axis.  Each rank feeds only the
    device it drives, running its own transfer rings and shard pool —
    the per-host half of the elastic runtime (parallel/distributed.py)."""
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(model=model, seq=seq, device=device)
    return DeviceFeed(device=device, mesh=mesh, **kwargs)


class FeedTelemetry:
    """Thread-safe monotonic counters for the feed engine.

    `transfer_s` is the host-visible transfer time: the slot write and
    the copy's enqueue (a `non_blocking` copy from pinned memory returns
    at once, so on the card this is dispatch, not the copy itself).
    `_DEVICE_FIELDS` are the port's own, with no JAX counterpart: the
    copies' seconds on the card and the bytes of the copies so timed
    (`h2d_device_s`, `h2d_device_bytes`)."""

    _FIELDS = ("bytes_moved", "transfer_calls", "transfer_s", "chunks_fed",
               "coalesced_chunks", "groups", "stall_decode_s",
               "stall_drain_s", "compute_s", "wall_s",
               # the sharded direct-to-device path (io/shard_put.py)
               "sharded_groups", "fallback_groups", "shard_puts",
               "shard_bytes", "shard_wall_s", "shard_put_s",
               # the compressed wire path (ops/wire_codec.py)
               "compressed_groups", "wire_bytes_raw", "wire_bytes_sent")
    _DEVICE_FIELDS = ("h2d_device_s", "h2d_device_bytes")
    # high-water marks, not sums (note_max; delta reports the mark itself)
    _MAX_FIELDS = ("transfer_concurrency",)

    def __init__(self):
        self._lock = make_lock("io.feed.telemetry")
        self._c: Dict[str, float] = {f: 0.0 for f in self._FIELDS}  #: guarded-by self._lock
        self._c.update({f: 0.0 for f in self._DEVICE_FIELDS})
        self._c.update({f: 0.0 for f in self._MAX_FIELDS})

    def add(self, **kw: float):
        with self._lock:
            for k, v in kw.items():
                self._c[k] += v

    def note_max(self, **kw: float):
        """Raise high-water fields (`_MAX_FIELDS`) to at least `kw`."""
        with self._lock:
            for k, v in kw.items():
                if v > self._c[k]:
                    self._c[k] = v

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._c)

    def transfer_seconds(self) -> float:
        """Cumulative host-visible H2D seconds: copy dispatch plus the
        sharded per-shard puts (the goodput ledger's `h2d` segment)."""
        with self._lock:
            return self._c["transfer_s"] + self._c["shard_put_s"]

    def delta(self, since: Dict[str, float]) -> Dict[str, float]:
        now = self.snapshot()
        return {k: (now[k] if k in self._MAX_FIELDS
                    else now[k] - since.get(k, 0.0)) for k in now}

    @staticmethod
    def summarize(d: Dict[str, float]) -> Dict[str, Any]:
        """Derived metrics from a counter delta (the JAX package's fields).

        overlap_frac: fraction of feed wall time NOT spent blocked on
        host-side feeding (producer stalls + transfer dispatch).
        h2d_gbps: the bytes of the copies timed on the card over their
        device seconds (None without such copies: a CPU feed)."""
        wall = d.get("wall_s", 0.0)
        stall = d.get("stall_decode_s", 0.0) + d.get("stall_drain_s", 0.0)
        blocked = d.get("stall_decode_s", 0.0) + d.get("transfer_s", 0.0)
        out = {
            "feed_bytes": int(d.get("bytes_moved", 0)),
            "transfer_calls": int(d.get("transfer_calls", 0)),
            "chunks_fed": int(d.get("chunks_fed", 0)),
            "stall_s": round(stall, 4),
            "overlap_frac": (round(max(0.0, min(1.0, 1.0 - blocked / wall)), 4)
                             if wall > 0 else None),
            "h2d_gbps": (round(d["h2d_device_bytes"] / d["h2d_device_s"]
                               / 1e9, 4)
                         if d.get("h2d_device_s", 0) > 0 else None),
        }
        # which transfer path the window took, its per-shard bandwidth,
        # and the transfer pool's concurrency high-water
        sharded = int(d.get("sharded_groups", 0))
        fallback = int(d.get("fallback_groups", 0))
        if sharded > 0 and sharded >= fallback:
            out["h2d_path"] = "sharded"
        elif fallback > 0:
            out["h2d_path"] = "fallback"
        else:
            out["h2d_path"] = "coalesced"
        out["shard_gbps"] = (
            round(d["shard_bytes"] / d["shard_wall_s"] / 1e9, 4)
            if d.get("shard_wall_s", 0) > 0 else None)
        out["transfer_concurrency"] = (
            int(d.get("transfer_concurrency", 0)) or None)
        sent = d.get("wire_bytes_sent", 0.0)
        out["wire_ratio"] = (round(d.get("wire_bytes_raw", 0.0) / sent, 3)
                             if sent > 0 else None)
        # mirror the derived numbers onto the registry so /metrics and
        # export_snapshot() carry the latest feed summary
        core_telemetry.gauge("io.feed.stall_s").set(out["stall_s"])
        if out["overlap_frac"] is not None:
            core_telemetry.gauge("io.feed.overlap_frac").set(
                out["overlap_frac"])
        if out["wire_ratio"] is not None:
            core_telemetry.gauge("io.feed.shard.wire_ratio").set(
                out["wire_ratio"])
        return out


# process-wide default sink: tests and measurement scripts read deltas off this
FEED_TELEMETRY = FeedTelemetry()


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _byte_layout(arrays: Sequence[np.ndarray]) -> Tuple[List[int], int]:
    """Each array's offset in a byte-packed buffer (128-byte aligned) and
    the buffer's size."""
    offsets, off = [], 0
    for a in arrays:
        offsets.append(off)
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    return offsets, max(off, _ALIGN)


class _Slot:
    """One pinned staging buffer, the event that fences its reuse, and the
    timing event recorded before its last copy (None once that copy's
    device time was read)."""

    __slots__ = ("host", "fence", "start")

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype):
        self.host = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.fence: Optional[torch.cuda.Event] = None
        self.start: Optional[torch.cuda.Event] = None


class DeviceFeed:
    """One host->device feed: coalescing + pinned ring staging + a
    bounded in-flight window, on one device or over a data mesh.

    `device=None` is the card (`device.resolve_device`); with a `mesh`
    the device is the mesh's (this rank's card, or the CPU of a gloo
    mesh).  Instances are cheap (rings allocate lazily); consumers create
    one per transform or fit and share the process-wide telemetry sink."""

    def __init__(self, device=None, mesh=None, depth: Optional[int] = None,
                 coalesce: Optional[int] = None,
                 coalesce_bytes: int = 64 << 20,
                 telemetry: Optional[FeedTelemetry] = None,
                 transfer_retries: int = 3,
                 shard_strategy: Optional[str] = None):
        tuned = load_tuned()
        if mesh is not None:
            from ..parallel.mesh import as_device_mesh

            mesh = as_device_mesh(mesh)
            if device is None:
                device = mesh.device_type
        self.mesh = mesh
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if depth is None:
            depth = tuned.get("depth") or default_depth()
        self.depth = max(1, int(depth))
        if coalesce is None:
            coalesce = tuned.get("coalesce") or 4
        self.coalesce = max(1, int(coalesce))
        self.coalesce_bytes = int(coalesce_bytes)
        self.telemetry = telemetry if telemetry is not None else FEED_TELEMETRY
        self.transfer_retries = max(1, int(transfer_retries))
        # sharded-path strategy: explicit arg > env > tuned > auto.
        # "auto" routes data-sharded puts through ShardEngine when the
        # data axis holds more than one shard; "sharded" always does;
        # "coalesced" pins the single-put path; "compressed" also
        # advertises the RLE wire to consumers that ask
        if shard_strategy is None:
            shard_strategy = (os.environ.get("MMLSPARK_FEED_SHARD")
                              or tuned.get("strategy") or "auto")
        if shard_strategy not in ("auto", "sharded", "coalesced",
                                  "compressed"):
            raise ValueError(f"unknown shard_strategy {shard_strategy!r}")
        self.shard_strategy = shard_strategy
        # a shard group that exhausted its retries flips this: the feed
        # stays on the coalesced single-put path for the rest of its life
        self.shard_degraded = False
        self._shard_engine = None
        self._shard_policy = StagePolicy(retries=self.transfer_retries,
                                         backoff_s=0.001, backoff_cap_s=0.05,
                                         retry_counter="feed.shard_retry")
        # the retry rung of every copy; the terminal degrade rung stays at
        # the call sites, which know whether the failed copy was packed
        # (degrade the feed) or already a single one (raise)
        self._put_policy = StagePolicy(retries=self.transfer_retries,
                                       backoff_s=0.001, backoff_cap_s=0.05,
                                       retry_counter="feed.transfer_retry")
        # a packed transfer of `run` that failed all its retries flips
        # this: the feed stays on unpipelined single puts for the rest of
        # its life (feeds are per transform/fit, so the blast radius of a
        # flaky link is one consumer, not the process)
        self.degraded = False
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._rings: Dict[Any, List[_Slot]] = {}
        self._ring_pos: Dict[Any, int] = {}
        # materialize the degraded-engines gauge at 0 so a /metrics scrape
        # sees the series before (and whether or not) anything degrades
        core_telemetry.gauge("io.feed.degraded_engines")

    def _obs_transfer(self, nbytes: float, dt: float, chunks: int = 1) -> None:
        core_telemetry.histogram("io.feed.transfer.latency").observe(dt)
        core_telemetry.histogram(
            "io.feed.transfer.bytes",
            boundaries=core_telemetry.BYTE_BUCKETS).observe(nbytes)
        ctx = core_telemetry.current_context()
        if ctx is not None:
            core_telemetry.record_span("feed.transfer", ctx, dt,
                                       bytes=int(nbytes), chunks=chunks)

    # ---- the guarded copy ----------------------------------------------
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
            self._read_copy_time(slot)
        return slot

    def _read_copy_time(self, slot: _Slot) -> None:
        """The slot's last copy's seconds on the card, from its start and
        fence events; only once the fence is known complete."""
        if slot.start is None:
            return
        dt = slot.start.elapsed_time(slot.fence) * 1e-3
        slot.start = None
        self.telemetry.add(h2d_device_s=dt,
                           h2d_device_bytes=slot.host.nbytes)
        core_telemetry.histogram(
            "io.feed.transfer.device_latency").observe(dt)

    def _read_finished_copies(self) -> None:
        """Read the device time of every copy whose fence has completed
        (`query()`, which never waits); a copy still running is read when
        its slot is next reused."""
        for ring in self._rings.values():
            for slot in ring:
                if slot.start is not None and slot.fence.query():
                    self._read_copy_time(slot)

    def _copy_in(self, slot: _Slot) -> torch.Tensor:
        """The slot's host buffer -> a new device tensor: one non-blocking
        copy on the side stream (retried by the transfer policy), fenced
        so the compute stream waits for it and the slot is rewritten only
        after it."""
        def attempt(_):
            fault_point("feed.device_put")
            # no-op unless enable_device_annotations() armed the profiler
            # hook: the transfer span itself is recorded after the fact
            with core_telemetry.device_annotation("feed.transfer"), \
                    torch.cuda.stream(self._stream):
                dev = torch.empty(slot.host.shape, dtype=slot.host.dtype,
                                  device=self.device)
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._stream)
                dev.copy_(slot.host, non_blocking=True)
                fence = torch.cuda.Event(enable_timing=True)
                fence.record(self._stream)
            return dev, start, fence

        x, slot.start, slot.fence = self._put_policy.run(attempt, None)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(slot.fence)
        # allocated on the side stream, used on the compute stream
        x.record_stream(compute)
        return x

    def _copy(self, shape: Tuple[int, ...], dtype, fill: Callable) -> torch.Tensor:
        """One guarded copy of a host buffer of `shape`/`dtype` that
        `fill(np_buffer)` writes: a pinned ring slot on the card; on a CPU
        device a buffer of its own, which the tensor aliases."""
        if self._cuda:
            slot = self._acquire_slot(shape, dtype)
            fill(slot.host.numpy())
            return self._copy_in(slot)
        host = np.empty(shape, dtype)
        fill(host)

        def attempt(_):
            fault_point("feed.device_put")
            return torch.from_numpy(host)

        return self._put_policy.run(attempt, None)

    def _degrade(self, why: str):
        if not self.degraded:
            self.degraded = True
            core_telemetry.incr("feed.degraded")
            core_telemetry.gauge("io.feed.degraded_engines").inc()
            warnings.warn(f"DeviceFeed degraded to unpipelined transfers: {why}",
                          RuntimeWarning, stacklevel=3)

    # ---- the sharded direct-to-device path (io/shard_put.py) -----------
    def _engine(self):
        if self._shard_engine is None:
            from .shard_put import ShardEngine

            # an explicit "sharded" strategy is a directive, not a hint:
            # drop the per-shard size floor so even small batches take the
            # per-shard path
            floor = 0 if self.shard_strategy == "sharded" else 1 << 12
            self._shard_engine = ShardEngine(policy=self._shard_policy,
                                             telemetry=self.telemetry,
                                             min_shard_bytes=floor)
        return self._shard_engine

    def _degrade_shard(self, why: str):
        """The shard rung of the ladder: sticky per-feed fall-back to the
        coalesced single-put path (which keeps ITS retry rung)."""
        if not self.shard_degraded:
            self.shard_degraded = True
            core_telemetry.incr("feed.shard_degraded")
            warnings.warn(
                f"DeviceFeed sharded path degraded to coalesced: {why}",
                RuntimeWarning, stacklevel=3)

    def _try_sharded(self, arr: np.ndarray, sharding):
        """`arr` through the sharded engine, or None when this put is not
        eligible (strategy, degraded, uneven batch, one data shard under
        "auto") — the caller continues on the coalesced path.  An uneven
        batch on a mesh of several ranks is counted as a fallback group:
        the `h2d_path="fallback"` signal."""
        from .shard_put import ShardTransferError, shard_layout

        if self.shard_degraded or self.shard_strategy == "coalesced":
            return None
        if sharding is None:
            return None
        eng = self._engine()
        layout = shard_layout(sharding, arr.shape)
        if layout is None:
            if sharding.mesh.size() > 1:
                self.telemetry.add(fallback_groups=1)
                core_telemetry.incr("io.feed.shard.fallback")
            return None
        # the SPMD reading of "more than one addressable shard": the
        # global shard count is the data axis's size (each rank holds one)
        if self.shard_strategy != "sharded" and data_size(sharding.mesh) <= 1:
            return None
        if arr[layout[0][1]].nbytes < eng.min_shard_bytes:
            # below the per-shard floor the fixed per-put cost wins:
            # coalescing is the DELIBERATE choice here, not a fallback
            return None
        try:
            out = eng.put_sharded(arr, sharding, layout)
        except ShardTransferError as e:
            self._degrade_shard(f"shard put failed after retries: {e}")
            self.telemetry.add(fallback_groups=1)
            core_telemetry.incr("io.feed.shard.fallback")
            return None
        self.telemetry.add(chunks_fed=1, groups=1)
        return out

    # ---- sharding helpers ----------------------------------------------
    def _dp(self) -> int:
        return data_size(self.mesh) if self.mesh is not None else 1

    def _chunk_sharding(self, ndim: int):
        if self.mesh is None:
            return None
        from ..parallel.mesh import batch_sharding

        return batch_sharding(self.mesh, ndim)

    def _local(self, arr: np.ndarray, sharding) -> np.ndarray:
        """This rank's block of `arr` under `sharding` (all of it without
        one)."""
        if sharding is None:
            return arr
        from .shard_put import shard_layout

        layout = shard_layout(sharding, arr.shape)
        if layout is None:
            raise ValueError(f"shape {arr.shape} does not divide evenly "
                             f"under {sharding}")
        return arr[layout[0][1]]

    # ---- single transfers ----------------------------------------------
    def put(self, arr, sharding=None, block: bool = False):
        """One counted copy.  `block=True` waits for it (bandwidth
        probes); otherwise it is ordered before later work on the current
        stream.  With a `sharding` (a `parallel.mesh.NamedSharding`) the
        result is a DTensor whose local block is this rank's rows: a
        data-sharded batch rides the per-shard engine when eligible,
        everything else one coalesced copy of the rank's block."""
        arr = np.asarray(arr)
        out = self._try_sharded(arr, sharding)
        if out is None:
            local = np.ascontiguousarray(self._local(arr, sharding))
            t0 = time.perf_counter()
            x = self._copy(local.shape, local.dtype,
                           lambda h: np.copyto(h, local))
            dt = time.perf_counter() - t0
            self.telemetry.add(bytes_moved=local.nbytes, transfer_calls=1,
                               transfer_s=dt, chunks_fed=1, groups=1)
            self._obs_transfer(local.nbytes, dt)
            out = x if sharding is None else _wrap(x, sharding, arr.shape)
        if block and self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def put_group(self, arrays: Sequence[Any], shardings=None
                  ) -> Tuple[Any, ...]:
        """Several host arrays -> device tensors in ONE transfer.

        The arrays byte-pack into one uint8 buffer (each at an offset
        aligned to 128 bytes) — on the card a pinned ring slot — which
        moves in one copy and is sliced and `.view(dtype)`'d apart on the
        device.  The arrays are copied into the buffer before the call
        returns, so the caller may mutate them right after.  With
        `shardings` (one a array, None for a plain tensor), a group with
        any sharding rides per-array `put`s — each rank moves its own
        blocks; a packed buffer cannot carry mixed batch axes.

        A group of `ops.wire_codec.RLEPayload`s (still-encoded chunks)
        rides the compressed wire instead (`_put_compressed`); a group
        that mixes payloads and arrays is a caller's error and raises."""
        from ..ops.wire_codec import RLEPayload

        n_rle = sum(isinstance(a, RLEPayload) for a in arrays)
        if n_rle:
            if n_rle != len(arrays):
                raise TypeError("put_group: a group mixes RLEPayloads and "
                                "arrays; encode all of them or none")
            return self._put_compressed(list(arrays))
        if shardings is not None and any(s is not None for s in shardings):
            return tuple(self.put(a, s) for a, s in zip(arrays, shardings))
        arrays = [np.ascontiguousarray(a) for a in arrays]
        t0 = time.perf_counter()
        packed, offsets, total = self._put_packed(arrays)
        outs = tuple(packed[o:o + a.nbytes].view(_torch_dtype(a.dtype))
                     .reshape(a.shape) for o, a in zip(offsets, arrays))
        dt = time.perf_counter() - t0
        self.telemetry.add(bytes_moved=total, transfer_calls=1,
                           transfer_s=dt, chunks_fed=len(arrays), groups=1,
                           coalesced_chunks=len(arrays))
        self._obs_transfer(total, dt, len(arrays))
        return outs

    def _put_packed(self, arrays: Sequence[np.ndarray]
                    ) -> Tuple[torch.Tensor, List[int], int]:
        """Byte-pack contiguous arrays into one buffer at 128-byte aligned
        offsets and move it in one copy: (device uint8 buffer, each
        array's offset, the buffer's size)."""
        offsets, total = _byte_layout(arrays)

        def fill(host):
            for o, a in zip(offsets, arrays):
                host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)

        return self._copy((total,), np.uint8, fill), offsets, total

    def _put_compressed(self, payloads) -> Tuple[torch.Tensor, ...]:
        """RLE-encoded chunks over the compressed wire: every payload's
        values and ends tables byte-pack into ONE buffer (`_put_packed`:
        one pinned slot, one copy, the same retry ladder), then one
        decode per payload rebuilds its raw bytes on the device
        (`ops.wire_codec.decode_bytes`: kernel B3 on the card), viewed
        back to the chunk's dtype and shape.  The wire is values + ends
        only, byte for byte what the JAX package sends and counts."""
        from ..ops import wire_codec

        wire: List[np.ndarray] = []
        for p in payloads:
            wire += [p.values, p.ends]
        t0 = time.perf_counter()
        packed, offsets, total = self._put_packed(wire)
        outs = []
        for i, p in enumerate(payloads):
            ov, oe = offsets[2 * i], offsets[2 * i + 1]
            values = packed[ov:ov + p.values.nbytes]
            ends = packed[oe:oe + p.ends.nbytes].view(torch.int32)
            raw = wire_codec.decode_bytes(values, ends, p.n_pad)
            outs.append(raw[:p.nbytes_raw].view(_torch_dtype(p.dtype))
                        .reshape(p.shape))
        dt = time.perf_counter() - t0
        self.telemetry.add(bytes_moved=total, transfer_calls=1,
                           transfer_s=dt, chunks_fed=len(payloads),
                           groups=1, coalesced_chunks=len(payloads),
                           compressed_groups=1,
                           wire_bytes_raw=sum(p.nbytes_raw for p in payloads),
                           wire_bytes_sent=total)
        self._obs_transfer(total, dt, len(payloads))
        core_telemetry.incr("io.feed.shard.compressed_groups")
        return tuple(outs)

    def stream(self, items: Iterable[Sequence[np.ndarray]], shardings=None):
        """Prefetching transfer stream for sequential consumers (train
        loops): yields each item's device tensors (one `put_group`
        transfer per item, a tuple) while up to `depth` later items'
        copies are already enqueued — slice t+1 moves while the steps of
        slice t compute."""
        buf: deque = deque()
        t0 = time.perf_counter()
        for item in items:
            buf.append(self.put_group(tuple(item), shardings))
            while len(buf) > self.depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
        self.telemetry.add(wall_s=time.perf_counter() - t0)
        self._read_finished_copies()

    # ---- the pipelined chunk engine ------------------------------------
    def run(self, chunk_iter, compute_fn: Callable, greedy: bool = True
            ) -> List[np.ndarray]:
        """Drive (chunk, n_valid) pairs through transfer + compute with
        assembly/transfer/compute overlap; returns each chunk's output as
        a host array trimmed to n_valid, in feed order.

        Ready chunks coalesce into packed groups (`_can_pack`), each ONE
        copy split apart on the device; `compute_fn` is dispatched per
        chunk and its device-to-host copy started at once.  Up to `depth`
        groups are in flight; the oldest drains when the window fills.
        On a mesh each chunk is a DTensor of this rank's rows, and a
        DTensor result is gathered whole before its host copy.

        greedy=True never waits for a fuller pack (latency first; the
        transform path).  greedy=False waits until `coalesce` chunks are
        queued (or the producer is done) before forming each group."""
        tel = self.telemetry
        t_wall = time.perf_counter()
        if isinstance(chunk_iter, FeedSource):
            source = chunk_iter
        else:
            source = _IterSource(chunk_iter,
                                 maxsize=max(4 * self.coalesce,
                                             2 * self.depth + 2))
        source.start()

        results: List[np.ndarray] = []
        # (host results, n_valid per chunk, events marking their copies)
        inflight: deque = deque()
        done = False
        leftover: Optional[Tuple[np.ndarray, int]] = None

        def drain_group():
            hosts, ns, events = inflight.popleft()
            t0 = time.perf_counter()
            for host, n, ev in zip(hosts, ns, events):
                if ev is not None:
                    ev.synchronize()
                results.append(host.numpy()[:n])
            tel.add(stall_drain_s=time.perf_counter() - t0)

        while not done or leftover is not None:
            # ---- collect the next group of ready chunks ----
            # a degraded feed forms single-chunk groups and keeps nothing
            # in flight (the safe unpipelined rung; may flip mid-run when
            # a packed transfer exhausts its retries)
            coalesce_now = 1 if self.degraded else self.coalesce
            group: List[Tuple[np.ndarray, int]] = []
            gbytes = 0
            if leftover is not None:
                group.append(leftover)
                gbytes = leftover[0].nbytes
                leftover = None
            while len(group) < coalesce_now and gbytes < self.coalesce_bytes:
                if not group or (not greedy and not done):
                    t0 = time.perf_counter()
                    item = source.get()
                    tel.add(stall_decode_s=time.perf_counter() - t0)
                else:
                    try:
                        item = source.get_nowait()
                    except queue.Empty:
                        break
                if item is FEED_END:
                    done = True
                    break
                chunk, n = item
                chunk = np.asarray(chunk)
                if group and not self._can_pack(group[0][0], chunk):
                    leftover = (chunk, n)
                    break
                group.append((chunk, n))
                gbytes += chunk.nbytes
            if not group:
                continue

            # ---- one transfer for the whole group ----
            xs = self._transfer_group(group)
            t0 = time.perf_counter()
            hosts, events = [], []
            for x in xs:
                y = compute_fn(x)
                if hasattr(y, "full_tensor"):
                    y = y.full_tensor()  # every rank's rows, rank order
                if self._cuda:
                    # start the device->host copy at dispatch so it
                    # overlaps later groups instead of serializing at drain
                    host = torch.empty(y.shape, dtype=y.dtype,
                                       pin_memory=True)
                    host.copy_(y, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(self.device))
                    hosts.append(host)
                    events.append(ev)
                else:
                    hosts.append(y)
                    events.append(None)
            tel.add(compute_s=time.perf_counter() - t0)
            inflight.append((hosts, [n for _c, n in group], events))
            while len(inflight) > (0 if self.degraded else self.depth):
                drain_group()
        while inflight:
            drain_group()
        tel.add(wall_s=time.perf_counter() - t_wall)
        self._read_finished_copies()
        src_err = source.error()
        if src_err is not None:
            raise src_err
        return results

    # ---- packing internals ---------------------------------------------
    def _can_pack(self, a: np.ndarray, b: np.ndarray) -> bool:
        """Chunks pack together only at a data-parallel degree of 1: same
        shape and dtype (array pack) or, on a single device, any shapes
        via the byte-packed wire."""
        if self._dp() != 1:
            return False
        if a.shape == b.shape and a.dtype == b.dtype:
            return True
        return self.mesh is None or self.mesh.size() == 1

    def _put_one(self, c: np.ndarray):
        """One chunk, one copy (of this rank's rows on a mesh)."""
        sh = self._chunk_sharding(c.ndim)
        local = np.ascontiguousarray(self._local(c, sh))
        t0 = time.perf_counter()
        x = self._copy(local.shape, local.dtype,
                       lambda h: np.copyto(h, local))
        dt = time.perf_counter() - t0
        self.telemetry.add(bytes_moved=local.nbytes, transfer_calls=1,
                           transfer_s=dt, chunks_fed=1, groups=1)
        self._obs_transfer(local.nbytes, dt)
        return x if sh is None else _wrap(x, sh, c.shape)

    def _transfer_group(self, group) -> List[Any]:
        """ONE copy for the group; returns its device chunks.  A single
        chunk skips packing (no host copy beyond its slot).  A packed
        transfer that fails all its retries degrades the feed and the
        group falls back to single-chunk transfers."""
        chunks = [c for c, _n in group]
        k = len(chunks)
        if k == 1 or self.degraded:
            return [self._put_one(c) for c in chunks]
        first = chunks[0]
        homogeneous = all(c.shape == first.shape and c.dtype == first.dtype
                          for c in chunks)
        t0 = time.perf_counter()
        try:
            if homogeneous:
                def fill(host):
                    for i, c in enumerate(chunks):
                        host[i] = c

                packed = self._copy((k,) + first.shape, first.dtype, fill)
                nbytes = k * first.nbytes
                xs = [packed[i] for i in range(k)]
            else:
                packed, offsets, nbytes = self._put_packed(
                    [np.ascontiguousarray(c) for c in chunks])
                xs = [packed[o:o + c.nbytes].view(_torch_dtype(c.dtype))
                      .reshape(c.shape) for o, c in zip(offsets, chunks)]
        except Exception as e:  # noqa: BLE001 — degrade, then the safe path
            self._degrade(f"packed transfer failed after retries: {e}")
            return [self._put_one(c) for c in chunks]
        dt = time.perf_counter() - t0
        self.telemetry.add(bytes_moved=nbytes, transfer_calls=1,
                           transfer_s=dt, chunks_fed=k, groups=1,
                           coalesced_chunks=k)
        self._obs_transfer(nbytes, dt, k)
        if self.mesh is not None:
            # data degree 1: each chunk is the whole of its own block
            xs = [_wrap(x, self._chunk_sharding(c.ndim), c.shape)
                  for x, c in zip(xs, chunks)]
        return xs

    # ---- the flow adapter ----------------------------------------------
    def stage(self, workers: int = 1,
              credits: Optional[int] = None) -> "H2DStage":
        """This feed's h2d hop as a flow `Stage`, for credit-bounded
        decode -> assemble -> h2d graphs (core/flow.py)."""
        return H2DStage(self, workers=workers, credits=credits)


def _wrap(local: torch.Tensor, sharding, shape):
    from .shard_put import _global_tensor

    return _global_tensor(local, sharding, shape)


class H2DStage(Stage):
    """DeviceFeed's h2d hop as a registered flow stage: each item is one
    host array (or a tuple of arrays packed into one transfer) moved
    through the feed's guarded put path — the `feed.device_put`
    StagePolicy retry ladder rides underneath unchanged.  A meshed feed's
    stage additionally shards data-divisible batches over the mesh (each
    rank its own rows; the per-shard engine in io/shard_put.py), so the
    `feed.shard_put` ladder and the sticky shard->coalesced degrade rung
    are exercised by credit-bounded graphs too.  The credit budget is
    the staging discipline as a declared number: at most `credits`
    chunks staged host-side per graph."""

    name = "h2d"
    credits = 4

    def __init__(self, feed: Optional[DeviceFeed] = None,
                 workers: int = 1, credits: Optional[int] = None):
        super().__init__(workers=workers, credits=credits)
        self.feed = feed if feed is not None else DeviceFeed()

    def process(self, value):
        if isinstance(value, (tuple, list)):
            return self.feed.put_group(
                tuple(np.asarray(a) for a in value))
        arr = np.asarray(value)
        sharding = None
        if self.feed.mesh is not None and arr.ndim \
                and arr.shape[0] % self.feed._dp() == 0:
            sharding = self.feed._chunk_sharding(arr.ndim)
        return self.feed.put(arr, sharding)
