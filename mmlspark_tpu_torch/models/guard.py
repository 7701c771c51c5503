"""Training anomaly guard: detect → quarantine → rollback → abort.

A copy of the JAX package's `models/guard.py` (which imports no JAX) for
this package, with its imports pointed at the port's own
`core.telemetry` and `utils.sync`; `models/training.py`'s
`fit_epochs_resumable` drives it.

The serving stack (PR 4) degrades instead of dying — retry, shed,
breaker, drain.  This module is the training-side twin.  A long run
must survive the failures large-scale training logbooks actually
report (OPT-175B-style loss spikes, NaN batches, hung steps) without
a human watching the curve:

* **Health probes.**  The jitted step already computes loss and (after
  this PR) the global gradient norm, so per-step health is two floats
  the host was pulling anyway — no extra dispatch.
* **Spike detection.**  A rolling median/MAD window over recent
  finite losses; a step whose loss exceeds
  ``median + spike_mads * max(1.4826*MAD, spike_floor)`` is an
  anomaly.  Median/MAD (not mean/std) so the detector itself is not
  dragged by the outliers it must catch.
* **Escalation ladder.**  Non-finite loss/grad ⇒ quarantine the batch
  immediately and roll back.  A spike ⇒ record it; ``spike_patience``
  *consecutive* spikes ⇒ quarantine + rollback (one noisy batch is
  normal SGD; a run of them is divergence).  Each rollback multiplies
  ``lr_scale`` by ``lr_backoff``; after ``max_rollbacks`` rollbacks
  the guard says ABORT — at that point the run needs a human.
* **Quarantine.**  Batches are named by their deterministic schedule
  position (the global batch index, a pure function of
  ``(seed, epoch)`` — see fit_epochs_resumable), so a replay after
  rollback skips exactly the poisoned batches and no others.  The set
  persists to ``quarantine.json`` next to the checkpoints, surviving
  process death.
* **Hung-step watchdog.**  A non-daemon thread (name
  ``train-guard-watchdog``, covered by the conftest leak check) that
  fires when a step exceeds its wall-clock budget — by default
  ``hang_multiplier`` × the warm ``models.training.step_latency`` p95
  already in the telemetry registry — emitting a loud
  ``training.hang`` record + counter.  It observes; it cannot
  un-wedge a stuck XLA call, but it makes the hang visible to the
  fleet instead of looking like slow training.

Every decision leaves a trail: ``training.anomaly[.<kind>]``,
``training.quarantine``, ``training.rollback``, ``training.abort``,
``training.hang`` counters, a ``training.guard.anomaly`` span per
anomaly, and the ``training.guard.lr_scale`` gauge.  Semantics are
documented in docs/robustness.md ("Training reliability ladder").
"""
from __future__ import annotations

import json
import math
import os
import statistics
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..core import telemetry as core_telemetry
from ..utils.sync import make_lock

__all__ = ["GuardAction", "TrainingAborted", "TrainingGuard"]

BatchId = Union[int, Tuple[int, ...]]


class GuardAction:
    """What the loop must do after ``observe()`` (string constants, so
    soak scripts can log/compare them without importing an enum)."""

    OK = "ok"              # healthy step: keep the new state
    RECORD = "record"      # anomaly noted; keep going (spike, patience not hit)
    ROLLBACK = "rollback"  # discard step, restore last verified checkpoint
    ABORT = "abort"        # rollback budget exhausted: stop the run


class TrainingAborted(RuntimeError):
    """Raised by the training loop when the guard's rollback budget is
    exhausted — the run is diverging faster than rollbacks can save it."""


class TrainingGuard:
    """Per-step anomaly detector + escalation ladder + hang watchdog.

    Use as a context manager (or ``start()``/``stop()``) so the
    watchdog thread is always joined — the conftest thread-leak check
    fails any test that leaves ``train-guard-*`` threads alive.

    ``observe(batch_id, loss, grad_norm)`` is the whole per-step API:
    it returns a :class:`GuardAction` telling the loop whether to keep
    the step, record-and-continue, roll back, or abort.
    """

    def __init__(
        self,
        window: int = 64,
        min_history: int = 16,
        spike_mads: float = 8.0,
        spike_floor: float = 0.25,
        spike_patience: int = 3,
        max_rollbacks: int = 4,
        lr_backoff: float = 0.5,
        hang_timeout_s: Optional[float] = None,
        hang_multiplier: float = 20.0,
        hang_min_s: float = 5.0,
        watchdog: bool = True,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window < 2 or min_history < 2:
            raise ValueError("window and min_history must be >= 2")
        if min_history > window:
            raise ValueError(
                f"min_history {min_history} > window {window}")
        self.window = int(window)
        self.min_history = int(min_history)
        self.spike_mads = float(spike_mads)
        self.spike_floor = float(spike_floor)
        self.spike_patience = int(spike_patience)
        self.max_rollbacks = int(max_rollbacks)
        self.lr_backoff = float(lr_backoff)
        self.hang_timeout_s = hang_timeout_s
        self.hang_multiplier = float(hang_multiplier)
        self.hang_min_s = float(hang_min_s)
        self._use_watchdog = bool(watchdog)
        self._clock = clock

        self._history: deque = deque(maxlen=self.window)
        self._spike_streak = 0
        self.quarantined: set = set()
        # corrupt CHECKPOINT directories walked past on restore — a
        # separate ledger from poisoned batches (different lifecycle:
        # these are filesystem paths, recorded by restore_verified's
        # on_corrupt hook, never re-admitted)
        self.quarantined_checkpoints: set = set()
        self.rollbacks = 0
        self.lr_scale = 1.0
        self.anomalies: List[Dict] = []
        # peers declared dead by the elastic runtime (PR 19): each loss
        # is one ledgered record — it rides quarantine.json so a
        # post-mortem can line the mesh shrink up against the rollbacks
        self.lost_hosts: List[Dict] = []

        # watchdog heartbeat: a monotonically increasing step sequence
        # plus a begin timestamp; the reported-latch keeps one hung step
        # from firing the alarm every poll tick.  Everything the
        # watchdog thread and the training thread both touch is guarded.
        self._lock = make_lock("models.guard.state")
        self._wd_thread: Optional[threading.Thread] = None
        self._wd_stop = threading.Event()
        self.hangs = 0  #: guarded-by self._lock
        self._hb_seq = 0  #: guarded-by self._lock
        self._hb_begin: Optional[float] = None  #: guarded-by self._lock
        self._hb_batch: Optional[BatchId] = None  #: guarded-by self._lock
        self._hb_reported = -1  #: guarded-by self._lock

    # ------------------------------------------------------ lifecycle

    @property
    def running(self) -> bool:
        return self._wd_thread is not None and self._wd_thread.is_alive()

    def start(self) -> "TrainingGuard":
        if self._use_watchdog and not self.running:
            self._wd_stop.clear()
            self._wd_thread = threading.Thread(
                target=self._watch, name="train-guard-watchdog",
                daemon=False)
            self._wd_thread.start()
        return self

    def stop(self) -> None:
        """Join the watchdog.  Idempotent; the same contract serving
        threads have — a guard that was started MUST be stopped."""
        self._wd_stop.set()
        t = self._wd_thread
        if t is not None:
            t.join(timeout=10.0)
            self._wd_thread = None

    def __enter__(self) -> "TrainingGuard":
        return self.start()

    def __exit__(self, *_exc) -> None:
        self.stop()

    # ------------------------------------------------------- watchdog

    def hang_budget_s(self) -> float:
        """Wall-clock budget for one step: the explicit override, else
        ``hang_multiplier`` × warm step-latency p95 from the registry
        (floored at ``hang_min_s`` for cold starts / empty registry)."""
        if self.hang_timeout_s is not None:
            return float(self.hang_timeout_s)
        p95 = core_telemetry.histogram(
            "models.training.step_latency").percentile(0.95)
        if p95 is None or not math.isfinite(p95) or p95 <= 0:
            return self.hang_min_s
        return max(self.hang_min_s, self.hang_multiplier * p95)

    def step_begin(self, batch_id: BatchId) -> None:
        with self._lock:
            self._hb_seq += 1
            self._hb_begin = self._clock()
            self._hb_batch = batch_id

    def step_end(self) -> None:
        with self._lock:
            self._hb_begin = None
            self._hb_batch = None

    def _watch(self) -> None:
        # poll fast relative to hang_min_s; the budget itself is
        # re-derived every tick so a warming registry tightens it live
        while not self._wd_stop.wait(timeout=0.05):
            with self._lock:
                begin, seq, batch = (self._hb_begin, self._hb_seq,
                                     self._hb_batch)
                already = self._hb_reported == seq
            if begin is None or already:
                continue
            elapsed = self._clock() - begin
            budget = self.hang_budget_s()
            if elapsed <= budget:
                continue
            with self._lock:
                if self._hb_reported == self._hb_seq:
                    continue
                self._hb_reported = seq
                # under the lock: the training thread reads this counter
                # (hang_count/report) concurrently with the watchdog, and
                # += on an attribute is not atomic
                self.hangs += 1
            core_telemetry.incr("training.hang")
            with core_telemetry.log_verb(
                    self, "training.hang", batch_id=repr(batch),
                    elapsed_s=round(elapsed, 3),
                    budget_s=round(budget, 3)):
                pass

    # ------------------------------------------------------- observe

    def observe(self, batch_id: BatchId, loss: float,
                grad_norm: Optional[float] = None) -> str:
        """Classify one completed step.  Returns a GuardAction."""
        loss = float(loss)
        kind = None
        if not math.isfinite(loss):
            kind = "loss_nonfinite"
        elif grad_norm is not None and not math.isfinite(float(grad_norm)):
            kind = "grad_nonfinite"

        if kind is not None:
            self._spike_streak = 0
            return self._escalate(batch_id, kind, loss, grad_norm)

        if len(self._history) >= self.min_history:
            med = statistics.median(self._history)
            mad = statistics.median(abs(x - med) for x in self._history)
            sigma = max(1.4826 * mad, self.spike_floor)
            if loss > med + self.spike_mads * sigma:
                self._spike_streak += 1
                if self._spike_streak >= self.spike_patience:
                    self._spike_streak = 0
                    return self._escalate(batch_id, "loss_spike", loss,
                                          grad_norm)
                self._anomaly(batch_id, "loss_spike", loss, grad_norm,
                              action=GuardAction.RECORD)
                return GuardAction.RECORD

        self._spike_streak = 0
        self._history.append(loss)
        return GuardAction.OK

    def _anomaly(self, batch_id: BatchId, kind: str, loss, grad_norm,
                 action: str) -> None:
        rec = {"batch_id": batch_id, "kind": kind, "loss": float(loss),
               "grad_norm": (None if grad_norm is None
                             else float(grad_norm)),
               "action": action}
        self.anomalies.append(rec)
        core_telemetry.incr("training.anomaly")
        core_telemetry.incr(f"training.anomaly.{kind}")
        with core_telemetry.span("training.guard.anomaly") as sp:
            sp.attrs.update(rec)

    def _escalate(self, batch_id: BatchId, kind: str, loss,
                  grad_norm) -> str:
        """Quarantine the batch, then rollback — or abort when the
        rollback budget is spent."""
        if batch_id not in self.quarantined:
            self.quarantined.add(batch_id)
            core_telemetry.incr("training.quarantine")
        if self.rollbacks >= self.max_rollbacks:
            self._anomaly(batch_id, kind, loss, grad_norm,
                          action=GuardAction.ABORT)
            core_telemetry.incr("training.abort")
            return GuardAction.ABORT
        self.rollbacks += 1
        self.lr_scale *= self.lr_backoff
        core_telemetry.incr("training.rollback")
        core_telemetry.gauge("training.guard.lr_scale").set(self.lr_scale)
        self._anomaly(batch_id, kind, loss, grad_norm,
                      action=GuardAction.ROLLBACK)
        return GuardAction.ROLLBACK

    def host_lost(self, host_id: str,
                  record: Optional[Dict] = None) -> str:
        """A peer host was declared dead (heartbeat-lease expiry or an
        injected ``training.host_lost`` fault).  The model did nothing
        wrong, so this does NOT consume the rollback budget or back off
        the learning rate — it ledgers the loss (``lost_hosts``, persisted
        in quarantine.json) and tells the loop to run the same
        checkpoint-floor rollback it would for a poisoned batch, after
        which the elastic runtime rebuilds the mesh over the survivors
        (docs/robustness.md "Elastic multi-host")."""
        rec = {"host_id": str(host_id)}
        rec.update(record or {})
        self.lost_hosts.append(rec)
        self.anomalies.append({"kind": "host_lost",
                               "action": GuardAction.ROLLBACK, **rec})
        core_telemetry.incr("training.anomaly")
        core_telemetry.incr("training.anomaly.host_lost")
        with core_telemetry.span("training.guard.anomaly") as sp:
            sp.attrs.update({"kind": "host_lost", **rec})
        return GuardAction.ROLLBACK

    # ------------------------------------------------- quarantine I/O

    def quarantine_checkpoint(self, step, path) -> None:
        """Record a corrupt checkpoint the restore walk condemned (the
        ``on_corrupt`` hook of ``restore_verified``): the (step, path)
        pair lands in the persisted ledger so a post-mortem can find the
        quarantined bytes even after further restarts."""
        self.quarantined_checkpoints.add((int(step), str(path)))
        self.anomalies.append({"kind": "checkpoint_corrupt",
                               "step": int(step), "path": str(path)})

    def save_quarantine(self, path) -> None:
        """Atomically persist the quarantine set (tmp + fsync + rename:
        a crash mid-write leaves the previous file, never a torn one)."""
        path = os.fspath(path)
        ids = [list(b) if isinstance(b, tuple) else b
               for b in self.quarantined]
        doc = {"quarantined": sorted(ids, key=repr),
               "quarantined_checkpoints": sorted(
                   [s, p] for s, p in self.quarantined_checkpoints),
               "lost_hosts": list(self.lost_hosts)}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load_quarantine(self, path) -> None:
        """Merge a persisted quarantine set (missing/torn file ⇒ no-op:
        worst case a poisoned batch is re-detected and re-quarantined)."""
        try:
            with open(os.fspath(path)) as f:
                doc = json.load(f)
            ids = doc.get("quarantined", [])
        except (OSError, ValueError):
            return
        for b in ids:
            self.quarantined.add(tuple(b) if isinstance(b, list) else b)
        # pre-format-2 quarantine.json has no checkpoint ledger: absent
        # key is a legacy doc, not corruption
        for entry in doc.get("quarantined_checkpoints", []):
            try:
                s, p = entry
                self.quarantined_checkpoints.add((int(s), str(p)))
            except (TypeError, ValueError):
                continue
        # pre-PR-19 docs carry no host ledger: absent key is legacy
        for rec in doc.get("lost_hosts", []):
            if isinstance(rec, dict) and rec not in self.lost_hosts:
                self.lost_hosts.append(rec)
