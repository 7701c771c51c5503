"""HostPipeline: the streaming input pipeline engine.

A copy of the JAX package's `io/pipeline.py` for this package.  The host
stages (decode -> assemble -> h2d -> forward) overlap instead of running
serially per batch, so end-to-end throughput is bounded by the slowest
stage rather than the sum of all of them (the pipelined-prefetch argument
of tf.data, Murray et al., VLDB 2021).

HostPipeline is a thin adapter over the credit-based `FlowGraph` runtime
(core/flow.py):

  * **Stages with worker pools.**  A `HostPipeline` is an ordered list
    of `PipelineStage(name, fn, workers)` map stages.  Each stage owns
    `workers` threads pulling from a credit-bounded input queue; codecs
    and numpy copies release the GIL, so N workers assemble N chunks
    concurrently while the device runs ahead on earlier ones.
  * **Credit budgets = backpressure.**  Every stage boundary is bounded
    by the stage's credit budget; a slow device stalls assembly —
    memory stays O(queue_size x chunk), never O(dataset).
  * **Order-preserving emission.**  Workers finish out of order; the
    runtime's per-stage reorder buffer re-emits results in sequence so
    chunk results land in feed order.
  * **Feeds DeviceFeed directly.**  `feed_source(items)` adapts the
    pipeline's ordered output to the feed engine's `FeedSource`
    protocol (io/feed.py), so assembly of chunk N+2, h2d of N+1, and
    the forward of N are in flight together.
  * **Telemetry.**  Per-stage busy seconds and item counts accumulate
    in `PIPELINE_TELEMETRY`; each item observes
    `io.pipeline.stage.latency{stage=...}` and queue depths mirror to
    `io.pipeline.queue.depth.<stage>` gauges.

Failure semantics are the runtime's: a stage exception (or a producer
exception) cancels the pipeline, and the consumer re-raises the
ORIGINAL error — no deadlock, no silent truncation.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

from ..core import telemetry as core_telemetry
from ..core.flow import _EOF, Expired, FlowGraph, FlowItem, Stage
from ..utils.sync import make_lock
from .feed import FEED_END, FeedSource

__all__ = ["PipelineStage", "HostPipeline", "PipelineTelemetry",
           "PIPELINE_TELEMETRY", "pipeline_workers"]


def pipeline_workers(default: Optional[int] = None) -> int:
    """Decode/assembly worker count: MMLSPARK_PIPELINE_WORKERS overrides
    (the knob every adopter inherits); otherwise `default`, otherwise a
    conservative min(4, cores) — decode threads beyond the core count
    only add queue contention."""
    env = os.environ.get("MMLSPARK_PIPELINE_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    if default is not None:
        return max(1, int(default))
    return max(1, min(4, os.cpu_count() or 2))


class PipelineTelemetry:
    """Thread-safe per-stage busy-seconds / item counters.

    `busy_s` for a stage is the sum of wall time its workers spend
    inside the stage fn — items/busy_s is the stage's standalone
    throughput bound, which is exactly what `e2e_bound` attribution
    needs (the pipeline's steady-state rate is min over stages of
    items/busy_s x workers)."""

    def __init__(self):
        self._lock = make_lock("io.pipeline.telemetry")
        self._stages: Dict[str, Dict[str, float]] = {}  #: guarded-by self._lock

    def add(self, stage: str, busy_s: float = 0.0, items: int = 0):
        with self._lock:
            rec = self._stages.setdefault(stage,
                                          {"busy_s": 0.0, "items": 0.0})
            rec["busy_s"] += busy_s
            rec["items"] += items

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._stages.items()}

    def delta(self, since: Dict[str, Dict[str, float]]
              ) -> Dict[str, Dict[str, float]]:
        now = self.snapshot()
        out = {}
        for k, v in now.items():
            base = since.get(k, {})
            out[k] = {f: v[f] - base.get(f, 0.0) for f in v}
        return out


# process-wide default sink: tests and measurement scripts read deltas off this
PIPELINE_TELEMETRY = PipelineTelemetry()


class PipelineStage:
    """One map stage spec: `fn(value) -> value`, run by `workers`
    threads.  A plain spec holder, NOT a `core.flow.Stage` subclass —
    pipeline stage names are per-call dynamic (decode/assemble/...), so
    HostPipeline materializes anonymous base `Stage`s from these specs
    at construction.

    `fn` must be thread-safe for workers > 1 (the decode/assembly fns
    here close over read-only inputs and write disjoint outputs)."""

    def __init__(self, name: str, fn: Callable[[Any], Any],
                 workers: int = 1):
        self.name = str(name)
        self.fn = fn
        self.workers = max(1, int(workers))


class HostPipeline:
    """Bounded multi-stage streaming pipeline over an item iterable —
    a thin wrapper binding the flow runtime (core/flow.py) to the
    historical io.pipeline surface and metric names.

    Drive it one of three ways:
      * `run(items)` — iterate the ordered final-stage outputs;
      * `feed_source(items)` — a `FeedSource` for `DeviceFeed.run`
        (the chunk path: stage outputs must be (chunk, n_valid) pairs);
      * `start(items)` + manual draining (tests).

    One pipeline instance is single-use (queues and counters are per
    run); instances are cheap — threads spawn at `start`."""

    def __init__(self, stages: Sequence[PipelineStage],
                 queue_size: Optional[int] = None,
                 telemetry: Optional[PipelineTelemetry] = None):
        if not stages:
            raise ValueError("HostPipeline needs at least one stage")
        self.stages = list(stages)
        self.telemetry = (telemetry if telemetry is not None
                          else PIPELINE_TELEMETRY)
        self._graph = FlowGraph(
            [Stage(name=s.name, fn=s.fn, workers=s.workers)
             for s in self.stages],
            queue_size=queue_size,
            span_prefix="pipeline",
            telemetry=self.telemetry,
            on_depth=self._mirror_depth,
            on_item=self._mirror_item,
            label="HostPipeline")
        self.queue_size = self._graph.queue_size

    # legacy metric names, alongside the runtime's flow.* series
    @staticmethod
    def _mirror_depth(name: str, depth: int) -> None:
        core_telemetry.gauge(f"io.pipeline.queue.depth.{name}").set(depth)

    @staticmethod
    def _mirror_item(name: str, seq: int, dt: float) -> None:
        core_telemetry.histogram("io.pipeline.stage.latency",
                                 stage=name).observe(dt)
        core_telemetry.incr(f"io.pipeline.items.{name}")

    # ---- lifecycle -----------------------------------------------------
    def start(self, items: Iterable[Any]):
        """Spawn the producer and every stage's workers (all daemon)."""
        self._graph.start(items)

    def cancel(self):
        """Stop all workers promptly; safe to call repeatedly."""
        self._graph.cancel()

    @property
    def error(self) -> Optional[BaseException]:
        return self._graph.error

    @property
    def _cancelled(self) -> threading.Event:
        return self._graph._cancelled

    def high_water(self) -> Dict[str, int]:
        """Max observed depth per hand-off queue (keyed by the stage the
        queue feeds, plus 'out') — the structural overlap witness: a
        stage queue that reached depth >= 2 had the previous stage
        running ahead while this one was still busy."""
        return self._graph.high_water()

    def _note_depth(self, name: str, depth: int) -> None:
        self._graph._note_depth(name, depth)

    # ---- consumption ---------------------------------------------------
    def _next_out(self, block: bool = True):
        """Next ordered (seq, value) from the out queue; `_EOF` at clean
        end; raises the pipeline's error (or queue.Empty when
        non-blocking and nothing is ready)."""
        item = self._graph._next_out(block=block)
        if isinstance(item, _EOF):
            return item
        seq, payload = item
        if isinstance(payload, (FlowItem, Expired)):
            payload = payload.value
        return (seq, payload)

    def run(self, items: Iterable[Any]):
        """Start and iterate the ordered final-stage outputs."""
        self.start(items)
        try:
            while True:
                item = self._next_out()
                if isinstance(item, _EOF):
                    return
                yield item[1]
        finally:
            # an abandoned/broken consumer must not strand the workers
            self.cancel()

    def feed_source(self, items: Iterable[Any]) -> "FeedSource":
        """Adapt to DeviceFeed's `FeedSource` protocol: the feed engine
        pulls ready (chunk, n_valid) pairs straight off the pipeline's
        ordered out queue — N decode workers drive the feed without an
        extra hand-off thread."""
        return _PipelineFeedSource(self, items)


class _PipelineFeedSource(FeedSource):
    """FeedSource over a HostPipeline's ordered output (see
    io/feed.py for the protocol DeviceFeed.run consumes)."""

    def __init__(self, pipe: HostPipeline, items: Iterable[Any]):
        self._pipe = pipe
        self._items = items
        self._done = False

    def start(self):
        self._pipe.start(self._items)

    def _translate(self, block: bool):
        if self._done:
            return FEED_END
        try:
            item = self._pipe._next_out(block=block)
        except queue.Empty:
            raise
        except BaseException:  # noqa: BLE001 — surfaced via error()
            # feed.run raises source.error() after draining in-flight
            # work, so the error still propagates — without deadlocking
            # the transfer window mid-group
            self._done = True
            return FEED_END
        if isinstance(item, _EOF):
            self._done = True
            return FEED_END
        return item[1]

    def get(self):
        return self._translate(block=True)

    def get_nowait(self):
        return self._translate(block=False)

    def error(self) -> Optional[BaseException]:
        return self._pipe.error
