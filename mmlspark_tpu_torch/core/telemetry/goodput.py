"""Goodput ledger: per-step timelines and lost-time attribution.

Answers the question the elastic 3D trainer raises and the counter
plane cannot: of the wall-clock spent inside `fit_epochs_resumable`,
what fraction was *productive* step compute, and where did the rest go?

    goodput = productive_step_time / wall_time

Every step the training loop records a `StepTimeline` entry — compute
seconds plus any attributed segment seconds (h2d from feed telemetry,
checkpoint writes, guard rollbacks, ...) — and the rest of the stack
feeds one-off losses through `note_lost()`: `run_with_deadline`
attributes collective overruns, the compile sentry attributes steady-
state recompiles, the elastic shrink path attributes the host-loss
ladder (detection -> restore -> resume).  `summary()` folds the ledger
into a goodput fraction, a lost-time table keyed by `LOST_KINDS`, and a
*windowed* goodput over the last few steps — the windowed form is what
"has this host recovered" means after an elastic shrink, since a
whole-run fraction can never climb back after a multi-second loss.

The ledger arms itself on the first recorded step; `note_lost()` before
that is dropped on purpose so warm-up compiles and the initial
rendezvous (which precede training) don't read as lost *training* time.

Straggler detection (`detect_straggler`) is a pure function over
per-host step timelines — the fleet merge plane runs it on the
federated view and surfaces the slowest host as a `training.straggler`
counter + `training.straggler.ratio` gauge.  Timestamps use the
injectable `utils.faults` clock, so chaos soaks under `VirtualClock`
attribute virtual seconds consistently.
"""
from __future__ import annotations

import os
import statistics
from contextlib import contextmanager
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence)

from ...utils.faults import monotonic as _monotonic
from ...utils.sync import make_lock
from .metrics import REGISTRY, MetricsRegistry

__all__ = ["LOST_KINDS", "StepTimeline", "GoodputLedger", "LEDGER",
           "detect_straggler", "merge_goodput_exports"]

#: The lost-time taxonomy (docs/observability.md "The goodput plane").
#: Everything measurable lands in one of these; wall time nobody
#: claimed shows up as `unattributed` in the summary, never silently.
LOST_KINDS = (
    "h2d",          # host->device transfer + shard put (feed telemetry)
    "collective",   # collective overrun budget (run_with_deadline)
    "checkpoint",   # autosave write + verify
    "rollback",     # guard rollback: restore + verify + rebuild
    "recompile",    # steady-state recompilation (compile sentry)
    "rendezvous",   # elastic re-rendezvous / membership epochs
    "host_loss",    # elastic shrink ladder: detection -> restore -> resume
    "quarantine",   # steps skipped while a batch is quarantined
    "other",        # explicitly attributed, fits no bucket above
)


class StepTimeline:
    """Fixed-capacity ring of per-step records for one host.

    Each record: ``{"step": int, "t_start": float, "wall_s": float,
    "segments": {"compute": s, <lost kind>: s, ...}}``.  Not
    self-locking — the owning ledger's lock guards access."""

    __slots__ = ("capacity", "_recs", "_head", "_size")

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._recs: List[Optional[Dict[str, object]]] = [None] * capacity
        self._head = 0
        self._size = 0

    def add(self, rec: Dict[str, object]) -> None:
        self._recs[self._head] = rec
        self._head = (self._head + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def records(self) -> List[Dict[str, object]]:
        start = (self._head - self._size) % self.capacity
        return [self._recs[(start + i) % self.capacity]  # type: ignore
                for i in range(self._size)]

    def last(self, n: int) -> List[Dict[str, object]]:
        recs = self.records()
        return recs[-n:] if n > 0 else []


class GoodputLedger:
    """Per-host goodput accounting: productive vs lost wall-clock.

    `record_step()` is the per-step hot path (a few dict updates and
    two gauge writes under one lock — far under the 1% step-time
    budget); everything else is read-side."""

    def __init__(self, host_id: Optional[str] = None, capacity: int = 256,
                 window_steps: int = 8,
                 clock: Optional[Callable[[], float]] = None,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = make_lock("telemetry.goodput")
        self._clock = clock if clock is not None else _monotonic
        self._registry = registry if registry is not None else REGISTRY
        self.window_steps = window_steps
        #: guarded-by self._lock (all mutable state below)
        self._host_id = host_id or f"pid{os.getpid()}"
        self._t0: Optional[float] = None
        self._productive_s = 0.0
        self._lost: Dict[str, float] = {}
        self._steps = 0
        self._timeline = StepTimeline(capacity)

    # ---- identity / lifecycle ------------------------------------------
    @property
    def host_id(self) -> str:
        with self._lock:
            return self._host_id

    def set_host(self, host_id: str) -> None:
        with self._lock:
            self._host_id = host_id

    def start(self, t: Optional[float] = None) -> None:
        """Arm the ledger (idempotent).  Normally implicit on the first
        recorded step; explicit for tests and for attributing losses
        that precede step 0 on purpose."""
        t = self._clock() if t is None else float(t)
        with self._lock:
            if self._t0 is None:
                self._t0 = t

    def reset(self, host_id: Optional[str] = None) -> None:
        with self._lock:
            if host_id is not None:
                self._host_id = host_id
            self._t0 = None
            self._productive_s = 0.0
            self._lost = {}
            self._steps = 0
            self._timeline = StepTimeline(self._timeline.capacity)

    # ---- write side ----------------------------------------------------
    def record_step(self, step: int, compute_s: float,
                    t_start: Optional[float] = None,
                    **segments: float) -> None:
        """One finished step: `compute_s` of productive time plus any
        attributed lost segments (kwargs keyed by `LOST_KINDS`)."""
        for kind in segments:
            if kind not in LOST_KINDS:
                raise ValueError(
                    f"unknown lost-time kind {kind!r} (LOST_KINDS)")
        compute_s = max(0.0, float(compute_s))
        wall = compute_s + sum(max(0.0, float(v))
                               for v in segments.values())
        t_end = self._clock()
        if t_start is None:
            t_start = t_end - wall
        seg: Dict[str, float] = {"compute": compute_s}
        with self._lock:
            if self._t0 is None:
                self._t0 = t_start
            self._productive_s += compute_s
            for kind, v in segments.items():
                v = max(0.0, float(v))
                if v > 0.0:
                    self._lost[kind] = self._lost.get(kind, 0.0) + v
                    seg[kind] = v
            self._steps += 1
            self._timeline.add({"step": int(step),
                                "t_start": round(float(t_start), 6),
                                "wall_s": round(wall, 6),
                                "segments": seg})
            frac = self._frac_locked(t_end)
            wfrac = self._window_frac_locked()
        if frac is not None:
            self._registry.gauge("training.goodput.frac").set(frac)
        if wfrac is not None:
            self._registry.gauge("training.goodput.window_frac").set(wfrac)

    def note_lost(self, kind: str, seconds: float) -> None:
        """Attribute lost wall-clock outside any step record.  Dropped
        when the ledger hasn't started (pre-training warm-up)."""
        if kind not in LOST_KINDS:
            raise ValueError(f"unknown lost-time kind {kind!r} (LOST_KINDS)")
        seconds = float(seconds)
        if seconds <= 0.0:
            return
        with self._lock:
            if self._t0 is None:
                return
            self._lost[kind] = self._lost.get(kind, 0.0) + seconds
            total = sum(self._lost.values())
        self._registry.gauge("training.goodput.lost_s").set(total)
        self._registry.gauge(f"training.goodput.lost_s.{kind}").set(
            self._lost_value(kind))

    def _lost_value(self, kind: str) -> float:
        with self._lock:
            return self._lost.get(kind, 0.0)

    @contextmanager
    def attribute(self, kind: str) -> Iterator[None]:
        """Time a block and attribute its wall to `kind`."""
        t0 = self._clock()
        try:
            yield
        finally:
            self.note_lost(kind, self._clock() - t0)

    # ---- read side -----------------------------------------------------
    def _frac_locked(self, now: float) -> Optional[float]:
        if self._t0 is None:
            return None
        wall = now - self._t0
        if wall <= 0:
            return None
        return min(1.0, self._productive_s / wall)

    def _window_frac_locked(self) -> Optional[float]:
        recs = self._timeline.last(self.window_steps)
        if len(recs) < 2:
            return None
        first, last = recs[0], recs[-1]
        span = (float(last["t_start"]) + float(last["wall_s"])
                - float(first["t_start"]))
        if span <= 0:
            return None
        productive = sum(float(r["segments"].get("compute", 0.0))  # type: ignore
                         for r in recs)
        return min(1.0, productive / span)

    def summary(self, now: Optional[float] = None) -> Dict[str, object]:
        now = self._clock() if now is None else float(now)
        with self._lock:
            lost = dict(self._lost)
            wall = (now - self._t0) if self._t0 is not None else 0.0
            accounted = self._productive_s + sum(lost.values())
            return {
                "host_id": self._host_id,
                "steps": self._steps,
                "wall_s": round(max(0.0, wall), 6),
                "productive_s": round(self._productive_s, 6),
                "lost": {k: round(v, 6) for k, v in sorted(lost.items())},
                "unattributed_s": round(max(0.0, wall - accounted), 6),
                "goodput_frac": self._frac_locked(now),
                "window": {
                    "steps": min(len(self._timeline.records()),
                                 self.window_steps),
                    "goodput_frac": self._window_frac_locked(),
                },
            }

    def export(self) -> Dict[str, object]:
        """The wire block served under `/metrics.json` `"goodput"`."""
        with self._lock:
            steps = self._timeline.records()
        out = self.summary()
        return {"host_id": out["host_id"], "summary": out, "steps": steps}


#: Process-wide ledger the training loop and attribution hooks feed.
LEDGER = GoodputLedger()


# ---------------------------------------------------------------------------
# Straggler detection over merged per-host timelines
def detect_straggler(timelines: Mapping[str, Sequence[Mapping[str, object]]],
                     ratio: float = 2.0,
                     streak: int = 3) -> Optional[Dict[str, object]]:
    """Name the slowest host from per-host step timelines, or None.

    For every step index present on ALL hosts, compute
    `p_max / p_median` of the step wall times.  A host is a straggler
    only when it is the argmax AND over threshold for `streak`
    consecutive common steps — a single jittery step never names
    anybody.  Needs >= 3 hosts to be meaningful: with two, the median
    is the mean of the pair, so `ratio >= 2` can never fire (by design
    — two hosts can't tell you *which* one is slow).

    `timelines`: host -> step records (each with "step" and "wall_s"),
    i.e. the `steps` lists from merged goodput exports.
    """
    by_step: Dict[int, Dict[str, float]] = {}
    for host, recs in timelines.items():
        for r in recs:
            by_step.setdefault(int(r["step"]), {})[host] = float(r["wall_s"])  # type: ignore
    hosts = set(timelines)
    run_host: Optional[str] = None
    run_len = 0
    found: Optional[Dict[str, object]] = None
    for g in sorted(by_step):
        by = by_step[g]
        if set(by) != hosts or len(by) < 2:
            # a step some host never reported breaks any streak: skew
            # against a missing host is not evidence
            run_host, run_len = None, 0
            continue
        med = statistics.median(by.values())
        slow = max(by, key=lambda h: by[h])
        r = (by[slow] / med) if med > 0 else 0.0
        if r >= ratio:
            run_len = run_len + 1 if slow == run_host else 1
            run_host = slow
            if run_len >= streak:
                found = {"host": slow, "ratio": round(r, 3),
                         "streak": run_len, "step": g}
        else:
            run_host, run_len = None, 0
    return found


# copied from the JAX package's core/telemetry/fleet.py, beside the
# export it merges
def merge_goodput_exports(sources: Mapping[str, Mapping[str, Any]],
                          straggler_ratio: float = 2.0,
                          straggler_streak: int = 3) -> Dict[str, Any]:
    """Fold per-host `GoodputLedger.export()` blocks into the federated
    goodput view: per-host summaries, a fleet lost-time table (summed —
    lost seconds are additive across hosts, like counters), the fleet
    goodput fraction (Σ productive / Σ wall), and straggler detection
    over the per-host step timelines.

    A named straggler is surfaced on THIS process's registry — a
    ``training.straggler`` (+ ``.<host>``) counter and the
    ``training.straggler.ratio`` gauge — so the SLOEngine and scrapers
    of the merging process (gateway or soak parent) see it without
    consuming the merged dict."""
    hosts: Dict[str, Any] = {}
    lost: Dict[str, float] = {}
    productive = wall = 0.0
    timelines: Dict[str, Sequence[Mapping[str, Any]]] = {}
    for host in sorted(sources):
        exp = sources[host] or {}
        summ = dict(exp.get("summary") or {})
        steps = list(exp.get("steps") or [])
        hosts[host] = {"summary": summ, "steps": steps}
        for kind, v in (summ.get("lost") or {}).items():
            lost[kind] = lost.get(kind, 0.0) + float(v)
        productive += float(summ.get("productive_s") or 0.0)
        wall += float(summ.get("wall_s") or 0.0)
        timelines[host] = steps
    straggler = detect_straggler(timelines, ratio=straggler_ratio,
                                 streak=straggler_streak)
    if straggler is not None:
        REGISTRY.incr("training.straggler")
        REGISTRY.incr(f"training.straggler.{straggler['host']}")
        REGISTRY.gauge("training.straggler.ratio").set(
            float(straggler["ratio"]))
    return {
        "hosts": hosts,
        "fleet": {
            "productive_s": round(productive, 6),
            "wall_s": round(wall, 6),
            "lost": {k: round(v, 6) for k, v in sorted(lost.items())},
            "goodput_frac": (round(productive / wall, 6)
                             if wall > 0 else None),
        },
        "straggler": straggler,
    }
