"""Deterministic fault injection: named fault points + seeded plans.

A copy of the JAX package's `utils/faults.py` for this package.  Code
declares **named fault points** (`fault_point("feed.device_put")`) at
every site that can fail in the field — a host-to-device transfer, a
pipeline stage.  By default a fault point is a no-op costing one
attribute load and one branch.  Tests arm a seeded `FaultPlan` through
the process-global injector:

    from mmlspark_tpu_torch.utils.faults import FAULTS, FaultPlan

    plan = FaultPlan(seed=7)
    plan.on("feed.device_put", probability=0.15, max_failures=20)
    with FAULTS.arm(plan):
        ...drive traffic...
    assert FAULTS.fires["feed.device_put"] > 0

Determinism: each point draws from its OWN `random.Random` seeded with
`(plan.seed, point_name)`, so the fire pattern of one point is a pure
function of how many times *that point* was reached — concurrency or
reordering elsewhere cannot shift it.  `nth` plans fire on exact call
indices (0-based) for fully scripted scenarios.

Every fire increments the `core.telemetry` counter `faults.injected` (and
`faults.injected.<point>`), so chaos runs leave the same audit trail as
real failures.

**Injectable clock.**  Every sleep on a failure path (injected latency
here, retry backoff in fault_tolerance.py, stage retry ladders in
core/flow.py) goes through module-level `sleep()` / `monotonic()`,
which delegate to a swappable clock.  Tests install a `VirtualClock` via
`use_clock()` so seeded latency faults and exponential backoff ladders
resolve in microseconds of wall time while still *observing* the full
virtual delay.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, Optional, Set

__all__ = ["InjectedFault", "InjectedCrash", "FaultRule", "FaultPlan",
           "FaultInjector", "FAULTS", "fault_point",
           "sleep", "monotonic", "use_clock", "VirtualClock"]


# ---------------------------------------------------------------------------
# Injectable clock: failure-path sleeps delegate here so chaos tests of
# retry/backoff ladders run in milliseconds, not wall-time.
# ---------------------------------------------------------------------------
class _SystemClock:
    """Default clock: real wall time."""

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)


class VirtualClock:
    """Deterministic test clock: `sleep` advances virtual time and
    returns immediately.  Coarse by design — concurrent sleepers each
    advance the shared clock, which is exactly what a chaos soak wants
    (total injected latency stays observable in `monotonic()` without
    costing wall time)."""

    def __init__(self, start: float = 0.0):
        self._lock = threading.Lock()
        self._now = float(start)  #: guarded-by self._lock

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._lock:
            self._now += max(0.0, float(seconds))

    def advance(self, seconds: float) -> None:
        self.sleep(seconds)


_CLOCK = _SystemClock()


def monotonic() -> float:
    """Monotonic time from the active (swappable) clock."""
    return _CLOCK.monotonic()


def sleep(seconds: float) -> None:
    """Failure-path sleep through the active (swappable) clock."""
    _CLOCK.sleep(seconds)


@contextlib.contextmanager
def use_clock(clock):
    """Install `clock` (anything with .monotonic()/.sleep()) for the
    duration of the block — the chaos-soak fast path."""
    global _CLOCK
    prev = _CLOCK
    _CLOCK = clock
    try:
        yield clock
    finally:
        _CLOCK = prev


class InjectedFault(Exception):
    """A recoverable injected failure (derives from Exception, so it rides
    the same handling as a real transfer/HTTP/model error)."""


class InjectedCrash(BaseException):
    """An injected *crash*: escapes `except Exception` handlers, killing
    the consumer thread the way a real process/task death would — the
    supervisor/replay path must recover, not the error path."""


class FaultRule:
    """When one named point fires.

    probability: per-call chance drawn from the point's seeded RNG.
    nth: exact 0-based call indices that fire (overrides probability).
    latency_s: sleep injected on fire (None/0 = none) — models a stall
        rather than (or in addition to) an error.
    error: exception CLASS raised on fire; None = latency-only fault.
    max_failures: total fires allowed (None = unlimited).
    """

    def __init__(self, probability: float = 0.0,
                 nth: Optional[Iterable[int]] = None,
                 latency_s: float = 0.0,
                 error: Optional[type] = InjectedFault,
                 max_failures: Optional[int] = None):
        if not 0.0 <= probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got {probability}")
        self.probability = float(probability)
        self.nth: Optional[Set[int]] = (None if nth is None
                                        else {int(i) for i in nth})
        self.latency_s = float(latency_s)
        self.error = error
        self.max_failures = (None if max_failures is None
                             else int(max_failures))


class FaultPlan:
    """A seeded set of rules, armed via FAULTS.arm(plan)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rules: Dict[str, FaultRule] = {}

    def on(self, point: str,
           probability: float = 0.0,
           nth: Optional[Iterable[int]] = None,
           latency_s: float = 0.0,
           error: Optional[type] = InjectedFault,
           max_failures: Optional[int] = None) -> "FaultPlan":
        self.rules[point] = FaultRule(probability, nth, latency_s, error,
                                      max_failures)
        return self


class FaultInjector:
    """Process-global fault-point evaluator.

    `calls` counts every arrival at an armed point; `fires` counts
    injections.  Both are plain dicts snapshot-readable after a run.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._plan: Optional[FaultPlan] = None  #: guarded-by self._lock
        self._rngs: Dict[str, "object"] = {}  #: guarded-by self._lock
        self.calls: Dict[str, int] = {}  #: guarded-by self._lock
        self.fires: Dict[str, int] = {}  #: guarded-by self._lock
        # the fast-path flag read (unlocked) by fault_point(); plain
        # attribute reads/writes are atomic under the GIL
        self.active = False

    @contextlib.contextmanager
    def arm(self, plan: FaultPlan):
        """Install `plan` for the duration of the block.  Non-reentrant:
        one plan at a time keeps the seeded draws deterministic."""
        import random

        with self._lock:
            if self._plan is not None:
                raise RuntimeError("a fault plan is already armed")
            self._plan = plan
            # str seeds hash via sha512 (stable across processes; a tuple
            # seed would ride the randomized str hash)
            self._rngs = {p: random.Random(f"{plan.seed}:{p}")
                          for p in plan.rules}
            self.calls = {p: 0 for p in plan.rules}
            self.fires = {p: 0 for p in plan.rules}
            self.active = True
        try:
            yield self
        finally:
            with self._lock:
                self._plan = None
                self._rngs = {}
                self.active = False

    def check(self, point: str):
        """Evaluate an armed point; raises the rule's error on fire."""
        with self._lock:
            plan = self._plan
            if plan is None:
                return
            rule = plan.rules.get(point)
            if rule is None:
                return
            idx = self.calls.get(point, 0)
            self.calls[point] = idx + 1
            if rule.max_failures is not None and \
                    self.fires.get(point, 0) >= rule.max_failures:
                return
            if rule.nth is not None:
                fire = idx in rule.nth
            else:
                fire = (rule.probability > 0.0
                        and self._rngs[point].random() < rule.probability)
            if not fire:
                return
            self.fires[point] = self.fires.get(point, 0) + 1
            latency = rule.latency_s
            error = rule.error
        # outside the lock: a sleeping fault must not serialize every
        # other point in the process
        from ..core import telemetry

        telemetry.incr("faults.injected")
        telemetry.incr(f"faults.injected.{point}")
        if latency > 0:
            sleep(latency)
        if error is not None:
            raise error(f"injected fault at {point!r} (call #{idx})")


FAULTS = FaultInjector()


def fault_point(name: str):
    """Declare a named fault point.  No-op unless a plan is armed — the
    disarmed cost is one attribute read and one branch, cheap enough for
    per-transfer and per-tick hot paths."""
    if FAULTS.active:
        FAULTS.check(name)
