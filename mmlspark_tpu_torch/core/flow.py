"""The credit-based staged-dataflow runtime.

A copy of the JAX package's `core/flow.py` for this package, holding the
parts the host input pipeline runs on (HostPipeline, io/pipeline.py, and
the DeviceFeed transfer retry ladder, io/feed.py) and the serving
intake (`AdmissionStage`, which ContinuousBatcher rides):

  * **Stages with credit budgets.**  A `FlowGraph` is an ordered list of
    `Stage`s, each with a named worker pool and a bounded CREDIT budget
    instead of an ad-hoc `Queue(maxsize=...)`.  An upstream hop acquires
    one of the downstream stage's credits before enqueueing and the
    credit is released only when the item is handed onward — so a
    stage's budget bounds its queued + in-worker + reorder-parked items
    together.  Backpressure is the credit wait: a slow stage stalls its
    producer, memory stays O(credits x item), never O(stream).
  * **Order-restoring emission.**  Workers finish out of order; a
    per-stage reorder buffer re-emits in sequence.
  * **One deadline model.**  Items carry an absolute monotonic deadline.
    A budget that lapses mid-graph sheds at the NEXT stage boundary: the
    item's slot becomes an `Expired` marker that keeps riding the
    reorder buffers (ordering is never lost) while no further stage fn
    runs on it.
  * **Chaos-injectable everywhere.**  Every stage auto-registers a
    `flow.<stage>` fault point at graph construction
    (`flow_fault_points()` lists them).  A `StagePolicy` gives a stage a
    retry-then-degrade ladder, with backoff sleeps through the
    injectable clock (utils/faults.py) so chaos runs resolve in
    milliseconds.
  * **Declared telemetry on every queue.**  Depths mirror to
    `flow.queue.depth.<stage>` gauges, expiries count into
    `flow.expired[.<stage>]`, per-item work into `flow.items.<stage>`
    and the `flow.stage.latency{stage=}` histogram; worker threads
    attach `<span_prefix>.<stage>` spans to the trace active where the
    graph was started.

Failure semantics: a stage or producer exception cancels the graph and
the consumer re-raises the ORIGINAL error; all waits are cancel-aware
`_POLL_S` loops, so an abandoned consumer can never strand a worker.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils.fault_tolerance import Overloaded
from ..utils.faults import fault_point
from ..utils.faults import monotonic as _clock_monotonic
from ..utils.faults import sleep as _clock_sleep
from ..utils.sync import make_lock
from . import telemetry as core_telemetry

__all__ = ["Stage", "StagePolicy", "FlowGraph", "FlowItem", "Expired",
           "AdmissionStage", "deadline_from_ms", "deadline_expired",
           "flow_fault_points", "set_sanitizer"]

_POLL_S = 0.05  # cancel-aware queue/credit wait quantum


# ---------------------------------------------------------------------------
# Fault-point auto-registration: every queue in the system becomes
# chaos-injectable the moment a graph is built around it.
# ---------------------------------------------------------------------------
# A runtime sanitizer's observer, or None.  Installed via
# set_sanitizer(); every hook site below is a plain attribute read plus a
# None check.
_SAN = None


def set_sanitizer(observer) -> None:
    """Install (or, with None, remove) the credit/EOF conservation
    observer: it is told of every credit acquire and release
    (`on_credit_acquire(credits)` / `on_credit_release(credits)`), every
    graph built (`on_graph(graph)`), every end-of-stream marker enqueued
    (`on_eof(graph, idx)`) and every clean end of a graph's stream
    (`on_graph_eof(graph)`)."""
    global _SAN
    _SAN = observer


_REG_LOCK = make_lock("flow.registry")
_FLOW_FAULT_POINTS: Dict[str, None] = {}  #: guarded-by _REG_LOCK


def _register_fault_point(point: str) -> None:
    with _REG_LOCK:
        _FLOW_FAULT_POINTS.setdefault(point, None)


def flow_fault_points() -> Tuple[str, ...]:
    """Every `flow.<stage>` fault point registered so far, in first-seen
    order."""
    with _REG_LOCK:
        return tuple(_FLOW_FAULT_POINTS)


# ---------------------------------------------------------------------------
# The deadline model (shared with serving: X-Deadline-Ms -> monotonic).
# ---------------------------------------------------------------------------
def deadline_from_ms(dl_ms) -> Optional[float]:
    """Parse a deadline budget in milliseconds (the `X-Deadline-Ms`
    header value) into an absolute monotonic deadline; malformed or
    missing values mean no deadline — a bad header must not fail a
    request that never asked for a budget."""
    if dl_ms is None:
        return None
    try:
        budget_ms = float(dl_ms)
    except (TypeError, ValueError):
        return None
    return _clock_monotonic() + budget_ms / 1000.0


def deadline_expired(deadline: Optional[float],
                     now: Optional[float] = None) -> bool:
    """True when an absolute monotonic `deadline` has lapsed."""
    if deadline is None:
        return False
    return (_clock_monotonic() if now is None else now) >= deadline


class FlowItem:
    """One item's envelope through the graph: the value plus its
    absolute monotonic deadline (None = no budget)."""

    __slots__ = ("value", "deadline")

    def __init__(self, value: Any, deadline: Optional[float] = None):
        self.value = value
        self.deadline = deadline

    def expired(self) -> bool:
        return deadline_expired(self.deadline)


class Expired:
    """An item whose deadline lapsed mid-graph: it keeps its sequence
    slot through every remaining reorder buffer (ordering is preserved)
    but no further stage fn runs on it.  `stage` names the boundary that
    shed it."""

    __slots__ = ("value", "deadline", "stage")

    def __init__(self, value: Any, deadline: Optional[float], stage: str):
        self.value = value
        self.deadline = deadline
        self.stage = stage


class _EOF:
    """End-of-stream marker carrying the total item count; re-put by the
    worker that pops it so every sibling sees it, forwarded downstream
    by the reorder buffer only after all `total` items emitted.  Rides
    credit-free: credits budget ITEMS, the marker just needs a slot."""

    __slots__ = ("total",)

    def __init__(self, total: int):
        self.total = total


class _Credits:
    """One stage's bounded credit budget: a counting semaphore with
    cancel-aware acquisition.  Holding a credit means the stage is
    accountable for one item — queued, in a worker's hands, or parked in
    its reorder buffer — until it is handed downstream."""

    __slots__ = ("limit", "_sem")

    def __init__(self, limit: int):
        self.limit = max(1, int(limit))
        self._sem = threading.Semaphore(self.limit)

    def acquire(self, cancelled: threading.Event) -> bool:
        """Block for a credit; False when the graph cancelled first."""
        while not cancelled.is_set():
            if self._sem.acquire(timeout=_POLL_S):
                if _SAN is not None:
                    _SAN.on_credit_acquire(self)
                return True
        return False

    def release(self) -> None:
        if _SAN is not None:
            _SAN.on_credit_release(self)
        self._sem.release()


class _Reorder:
    """Order-restoring emitter between a stage's workers and the next
    hop: out-of-order completions park in `pending` until their turn.
    `put` may block on the downstream credit while the lock is held —
    that IS the backpressure (siblings stall on the lock instead of
    racing further ahead); the consumer side never takes this lock, so
    there is no cycle to deadlock on."""

    def __init__(self, put: Callable[[Any], None]):
        self._put = put
        self._lock = make_lock("flow.reorder")
        self._pending: Dict[int, Any] = {}  #: guarded-by self._lock
        self._next = 0  #: guarded-by self._lock
        self._total: Optional[int] = None  #: guarded-by self._lock
        self._eof_sent = False  #: guarded-by self._lock

    def emit(self, seq: int, value: Any):
        with self._lock:
            self._pending[seq] = value
            self._flush()

    def close(self, total: int):
        with self._lock:
            self._total = total
            self._flush()

    def _flush(self):
        while self._next in self._pending:
            self._put((self._next, self._pending.pop(self._next)))
            self._next += 1
        if (self._total is not None and self._next >= self._total
                and not self._eof_sent):
            self._eof_sent = True
            self._put(_EOF(self._total))


class StagePolicy:
    """The retry-then-degrade ladder as a reusable stage policy:
    `retries` total attempts, each behind the stage's fault point; a tiny
    exponential backoff between attempts (through the injectable clock,
    so chaos tests cost no wall time); `degrade(value, error)` as the
    terminal rung — when set, exhausted retries fall back instead of
    raising.  Injected crashes (`InjectedCrash`, a BaseException) skip
    the ladder entirely: a process death is the supervisor's problem,
    not a retry's.
    """

    def __init__(self, retries: int = 1, backoff_s: float = 0.001,
                 backoff_cap_s: float = 0.05,
                 retry_counter: Optional[str] = None,
                 degrade: Optional[Callable[[Any, BaseException], Any]] = None):
        self.retries = max(1, int(retries))
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.retry_counter = retry_counter
        self.degrade = degrade

    def run(self, fn: Callable[[Any], Any], value: Any,
            point: Optional[str] = None) -> Any:
        last: Optional[BaseException] = None
        for attempt in range(self.retries):
            try:
                if point is not None:
                    fault_point(point)
                return fn(value)
            except Exception as e:  # noqa: BLE001 — retried, then raised
                last = e
                if attempt == self.retries - 1:
                    break
                if self.retry_counter is not None:
                    core_telemetry.incr(self.retry_counter)
                _clock_sleep(min(self.backoff_s * (2 ** attempt),
                                 self.backoff_cap_s))
        if self.degrade is not None:
            return self.degrade(value, last)
        raise last  # type: ignore[misc]


class Stage:
    """One named map stage: `fn(value) -> value`, run by `workers`
    threads under a bounded credit budget.

    Registered subclasses (AdmissionStage here, io.feed.H2DStage)
    declare a static class-level `name` and a bounded positive `credits`
    budget, and their `flow.<name>.*` rows appear in DECLARED_METRICS.
    Anonymous per-graph stages (built from a dynamic name, e.g. by
    HostPipeline) instantiate this base class directly and inherit the
    graph's default budget.  `fn` must be thread-safe for workers > 1;
    `policy` wires the retry-then-degrade ladder around every call."""

    name: str = "stage"
    credits: Optional[int] = None  # None: the graph's default budget
    workers: int = 1
    policy: Optional[StagePolicy] = None

    def __init__(self, name: Optional[str] = None,
                 fn: Optional[Callable[[Any], Any]] = None,
                 workers: Optional[int] = None,
                 credits: Optional[int] = None,
                 policy: Optional[StagePolicy] = None):
        if name is not None:
            self.name = str(name)
        self.fn = fn
        if workers is not None:
            self.workers = max(1, int(workers))
        if credits is not None:
            self.credits = max(1, int(credits))
        if policy is not None:
            self.policy = policy

    def process(self, value: Any) -> Any:
        """The stage's work on one value; subclasses override this (or
        pass `fn`)."""
        if self.fn is None:
            return value
        return self.fn(value)

    def run_item(self, value: Any, point: str) -> Any:
        """One item through the fault point (+ policy ladder if set)."""
        if self.policy is not None:
            return self.policy.run(self.process, value, point)
        fault_point(point)
        return self.process(value)


class FlowGraph:
    """Bounded multi-stage streaming dataflow over an item iterable.

    Drive it one of three ways:
      * `run(items)` — iterate the ordered final-stage outputs
        (`yield_expired=True` to receive `Expired` markers instead of
        skipping them);
      * `start(items)` + manual `_next_out()` draining (tests, the
        HostPipeline/FeedSource adapters);
      * as the engine under `io.pipeline.HostPipeline`, which adds the
        `io.pipeline.*` metric mirror.

    One graph instance is single-use (credits and counters are per run);
    instances are cheap — threads spawn at `start`, named `flow-*` and
    daemon."""

    def __init__(self, stages: Sequence[Stage],
                 queue_size: Optional[int] = None,
                 deadline: Optional[float] = None,
                 span_prefix: str = "flow",
                 telemetry: Optional[Any] = None,
                 on_depth: Optional[Callable[[str, int], None]] = None,
                 on_item: Optional[Callable[[str, int, float], None]] = None,
                 on_expired: Optional[Callable[[str, FlowItem], None]] = None,
                 label: Optional[str] = None):
        if not stages:
            raise ValueError("FlowGraph needs at least one stage")
        self.stages = list(stages)
        # default budget: deep enough that every worker of the widest
        # stage can have one item in hand and one queued; small enough
        # to bound host memory
        self.queue_size = max(2, int(
            queue_size if queue_size is not None
            else 2 * max(s.workers for s in self.stages)))
        self.deadline = deadline
        self.span_prefix = span_prefix
        self.telemetry = telemetry  # optional PipelineTelemetry-style sink
        self._on_depth = on_depth
        self._on_item = on_item
        self._on_expired = on_expired
        self._label = label if label is not None else "FlowGraph"
        # one credit budget per stage (declared or the graph default),
        # plus the out queue's; hand-off queues are bounded to exactly
        # the budget, so depth can never exceed it
        self._budgets = [int(s.credits) if s.credits else self.queue_size
                         for s in self.stages] + [self.queue_size]
        self._credits = [_Credits(b) for b in self._budgets]
        self._queues: List["queue.Queue"] = []
        self._qnames = [s.name for s in self.stages] + ["out"]
        self._cancelled = threading.Event()
        self._err_lock = make_lock("flow.err")
        self._error: Optional[BaseException] = None
        # every stage worker and the producer race through _enqueue; the
        # read-modify-write max-merge below needs its own (tiny) lock
        self._hw_lock = make_lock("flow.high_water")
        self._high_water: Dict[str, int] = {}  #: guarded-by self._hw_lock
        self._started = False
        self._ctx = None  # (trace_id, span_id) captured at start
        for s in self.stages:
            _register_fault_point(f"flow.{s.name}")
        if _SAN is not None:
            _SAN.on_graph(self)

    # ---- lifecycle -----------------------------------------------------
    def start(self, items: Iterable[Any]):
        """Spawn the producer and every stage's workers (all daemon)."""
        if self._started:
            raise RuntimeError(f"{self._label} instances are single-use")
        self._started = True
        # spans from worker threads attach to the trace active where the
        # graph was STARTED (the transform caller), the same cross-thread
        # hop record_span exists for
        self._ctx = core_telemetry.current_context()
        self._queues = [queue.Queue(maxsize=b) for b in self._budgets]
        threading.Thread(target=self._produce, args=(items,), daemon=True,
                         name="flow-producer").start()
        for i, stage in enumerate(self.stages):
            reorder = _Reorder(lambda item, j=i: self._handoff(j, item))
            for w in range(stage.workers):
                threading.Thread(
                    target=self._worker, args=(stage, i, reorder),
                    daemon=True,
                    name=f"flow-{stage.name}-{w}").start()

    def cancel(self):
        """Stop all workers promptly; safe to call repeatedly."""
        self._cancelled.set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def high_water(self) -> Dict[str, int]:
        """Max observed depth per hand-off queue (keyed by the stage the
        queue feeds, plus 'out') — the structural overlap witness: a
        stage queue that reached depth >= 2 had the previous stage
        running ahead while this one was still busy."""
        with self._hw_lock:
            return dict(self._high_water)

    def _note_depth(self, name: str, depth: int) -> None:
        """Max-merge one depth observation; lost updates here would
        under-report overlap."""
        with self._hw_lock:
            if depth > self._high_water.get(name, 0):
                self._high_water[name] = depth

    # ---- credit plumbing -----------------------------------------------
    def _enqueue(self, idx: int, item: Any):
        """Cancel-aware put + depth observation (no credit handling)."""
        q = self._queues[idx]
        while not self._cancelled.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                break
            except queue.Full:
                continue
        if _SAN is not None and isinstance(item, _EOF):
            _SAN.on_eof(self, idx)
        name = self._qnames[idx]
        depth = q.qsize()
        self._note_depth(name, depth)
        core_telemetry.gauge(f"flow.queue.depth.{name}").set(depth)
        if self._on_depth is not None:
            self._on_depth(name, depth)

    def _put_into(self, idx: int, item: Any) -> bool:
        """Acquire one of hop idx's credits, then enqueue; False when the
        graph cancelled while waiting (the item is dropped — teardown)."""
        if not self._credits[idx].acquire(self._cancelled):
            return False
        self._enqueue(idx, item)
        return True

    def _handoff(self, idx: int, item: Any):
        """Reorder emission of stage idx to the next hop.  The
        downstream credit is acquired BEFORE this stage's releases, so
        every in-flight item is accounted to exactly one budget."""
        if isinstance(item, _EOF):
            self._enqueue(idx + 1, item)  # the marker rides credit-free
            return
        if self._put_into(idx + 1, item):
            self._credits[idx].release()

    def _fail(self, e: BaseException):
        with self._err_lock:
            if self._error is None:
                self._error = e
        self.cancel()

    # ---- threads -------------------------------------------------------
    def _produce(self, items: Iterable[Any]):
        n = 0
        try:
            for item in items:
                fi = (item if isinstance(item, FlowItem)
                      else FlowItem(item, self.deadline))
                if not self._put_into(0, (n, fi)):
                    return  # cancelled while waiting for a credit
                n += 1
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            self._fail(e)
            return
        self._enqueue(0, _EOF(n))

    def _expire(self, stage: Stage, seq: int, fi: FlowItem,
                reorder: _Reorder):
        """Shed a lapsed item at this stage boundary: count it, tell the
        graph owner, and keep its slot moving so ordering survives."""
        core_telemetry.incr("flow.expired")
        core_telemetry.incr(f"flow.expired.{stage.name}")
        if self._on_expired is not None:
            self._on_expired(stage.name, fi)
        reorder.emit(seq, Expired(fi.value, fi.deadline, stage.name))

    def _worker(self, stage: Stage, idx: int, reorder: _Reorder):
        in_q = self._queues[idx]
        point = f"flow.{stage.name}"
        while not self._cancelled.is_set():
            try:
                item = in_q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            if isinstance(item, _EOF):
                # sibling workers need the marker too
                self._enqueue(idx, item)
                reorder.close(item.total)
                return
            seq, fi = item
            if isinstance(fi, Expired):
                reorder.emit(seq, fi)  # already shed upstream: pass through
                continue
            if fi.expired():
                self._expire(stage, seq, fi, reorder)
                continue
            t0 = time.perf_counter()
            try:
                # the stage's work on a profiler capture's timeline when
                # enable_device_annotations() armed the hook
                with core_telemetry.device_annotation(
                        f"{self.span_prefix}.{stage.name}"):
                    out = stage.run_item(fi.value, point)
            except BaseException as e:  # noqa: BLE001 — forwarded
                self._fail(e)
                return
            dt = time.perf_counter() - t0
            if self.telemetry is not None:
                self.telemetry.add(stage.name, busy_s=dt, items=1)
            core_telemetry.histogram("flow.stage.latency",
                                     stage=stage.name).observe(dt)
            core_telemetry.incr(f"flow.items.{stage.name}")
            if self._on_item is not None:
                self._on_item(stage.name, seq, dt)
            if self._ctx is not None:
                core_telemetry.record_span(
                    f"{self.span_prefix}.{stage.name}", self._ctx, dt,
                    seq=seq)
            reorder.emit(seq, FlowItem(out, fi.deadline))

    # ---- consumption ---------------------------------------------------
    def _next_out(self, block: bool = True):
        """Next ordered (seq, FlowItem-or-Expired) from the out queue;
        `_EOF` at clean end; raises the graph's error, or queue.Empty
        when non-blocking and nothing is ready."""
        q = self._queues[-1]
        while True:
            try:
                item = q.get(block=block, timeout=_POLL_S if block else None)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if self._cancelled.is_set():
                    raise RuntimeError(f"{self._label} cancelled")
                if block:
                    continue
                raise
            if isinstance(item, _EOF):
                if self._error is not None:
                    raise self._error
                if _SAN is not None:
                    # clean end-of-stream: every credit must be home —
                    # the sanitizer audits the ledger at this instant
                    _SAN.on_graph_eof(self)
                return item
            self._credits[-1].release()
            return item

    def run(self, items: Iterable[Any], yield_expired: bool = False):
        """Start and iterate the ordered final-stage outputs.  Expired
        items are skipped by default (a lapsed budget sheds the work,
        order is preserved); `yield_expired=True` yields the `Expired`
        markers in their slots instead."""
        self.start(items)
        try:
            while True:
                item = self._next_out()
                if isinstance(item, _EOF):
                    return
                payload = item[1]
                if isinstance(payload, Expired):
                    if yield_expired:
                        yield payload
                    continue
                yield payload.value
        finally:
            # an abandoned/broken consumer must not strand the workers
            self.cancel()


class AdmissionStage(Stage):
    """The serving intake as a flow stage: credit-bounded admission with
    shed, expired-deadline reaping, and graceful drain as ONE code path
    (ContinuousBatcher rides this; WorkerServer shares the deadline
    helpers and counters).

    The intake is two-phase like the batcher always was: client threads
    `offer()`/`put()` into the pending queue; the single loop thread
    moves it into the loop-owned `buffer` FIFO (`drain_to_buffer`),
    reaps lapsed deadlines (`reap_expired`) and admits from the head.
    `max_pending=None` keeps the seed's unbounded never-shedding intake
    while the class still declares a bounded default budget."""

    name = "admission"
    credits = 64  # bounded default intake budget

    def __init__(self, max_pending: Optional[int] = None,
                 label: str = "admission",
                 shed_counter: Optional[str] = None,
                 expired_counter: Optional[str] = None,
                 depth_gauge: Optional[str] = None):
        super().__init__()
        self.max_pending = (None if max_pending is None
                            else int(max_pending))
        self._intake_label = label
        self._shed_counter = shed_counter
        self._expired_counter = expired_counter
        self._depth_gauge = depth_gauge
        # intake is bounded at offer(): past max_pending it sheds with
        # Overloaded/503 instead of blocking the client thread on a full
        # put
        self._pending: "queue.Queue" = queue.Queue()  # graftlint: disable=G403
        # loop-thread-only FIFO between intake and admission (the owner
        # may defer the head, e.g. paged mode waiting for pages)
        self.buffer: deque = deque()
        _register_fault_point("flow.admission")

    # ---- depth ---------------------------------------------------------
    def depth(self) -> int:
        return self._pending.qsize() + len(self.buffer)

    def _note_depth(self) -> int:
        d = self.depth()
        core_telemetry.gauge("flow.queue.depth.admission").set(d)
        if self._depth_gauge is not None:
            core_telemetry.gauge(self._depth_gauge).set(d)
        return d

    # ---- client side ---------------------------------------------------
    def shed_check(self) -> None:
        """Raise Overloaded when the bounded intake is full (the caller
        maps it to 503 + Retry-After).  Also the stage's fault point: a
        chaos plan can shed or stall admissions on demand."""
        fault_point("flow.admission")
        if self.max_pending is not None and self.depth() >= self.max_pending:
            core_telemetry.incr("flow.shed")
            core_telemetry.incr("flow.shed.admission")
            if self._shed_counter is not None:
                core_telemetry.incr(self._shed_counter)
            raise Overloaded(
                f"{self._intake_label} intake full "
                f"({self.max_pending} pending)")

    def put(self, item: Any) -> None:
        """Enqueue after a passed shed_check (the caller may validate in
        between — the batcher holds its submit lock across the gap)."""
        self._pending.put(item)
        self._note_depth()

    def offer(self, item: Any) -> None:
        """shed_check + put in one step, for callers with no validation
        between the two."""
        self.shed_check()
        self.put(item)

    # ---- loop side -----------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> Any:
        """Blocking pop from the raw intake (the idle-loop path); raises
        queue.Empty on timeout."""
        return self._pending.get(timeout=timeout)

    def drain_to_buffer(self) -> None:
        """Move everything pending into the loop-owned buffer FIFO."""
        while True:
            try:
                self.buffer.append(self._pending.get_nowait())
            except queue.Empty:
                break
        self._note_depth()

    def reap_expired(self, deadline_of: Callable[[Any], Optional[float]],
                     on_expired: Callable[[Any], None],
                     now: Optional[float] = None) -> int:
        """Fail-fast pass over the buffered FIFO: an expired item must
        not consume admission work — its client has already given up.
        `on_expired` settles each dropped item (504 / TimeoutError on
        its stream); returns the number reaped."""
        now = _clock_monotonic() if now is None else now
        kept = [item for item in self.buffer
                if not deadline_expired(deadline_of(item), now)]
        reaped = [item for item in self.buffer
                  if deadline_expired(deadline_of(item), now)]
        if reaped:
            self.buffer.clear()
            self.buffer.extend(kept)
            for item in reaped:
                core_telemetry.incr("flow.expired")
                core_telemetry.incr("flow.expired.admission")
                if self._expired_counter is not None:
                    core_telemetry.incr(self._expired_counter)
                on_expired(item)
            self._note_depth()
        return len(reaped)

    def drain_all(self, on_item: Callable[[Any], None]) -> None:
        """Graceful drain: hand every queued item (buffer then pending)
        to `on_item` so stop() paths settle them consistently."""
        for item in self.buffer:
            on_item(item)
        self.buffer.clear()
        while True:
            try:
                on_item(self._pending.get_nowait())
            except queue.Empty:
                break
        self._note_depth()
