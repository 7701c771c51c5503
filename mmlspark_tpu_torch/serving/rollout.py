"""Fleet control plane, control half: versioned canary rollouts gated on
the perf-band engine.

A :class:`RolloutController` drives one canary at a time through a small
state machine::

    idle --begin()--> canary --step()--> promoted
                        |                   (canary weight -> 1.0, old
                        |                    replicas rolling-drained)
                        +-----step()--> rolled_back
                                            (canary weight -> 0, canary
                                             replicas drained + stopped)

While in ``canary`` the gateway splits traffic by version weight (e.g.
95/5).  Every :meth:`step` re-reads the gateway's per-version rolling
stats (in-window request/error counts, latency percentiles over the
forward window) and diffs canary vs baseline with the direction +
tolerance-band rule of the JAX package's bench regression gate
(`_band_compare`): a metric regresses only when it is worse by more
than ``abs(base)*rel + floor``.  The verdict is
hysteresis-free by design — one bad evaluation rolls back — because a
canary sample is cheap to retake and a bad canary is expensive to keep.

Rollback triggers (ROLLOUT_METRICS bands):

* ``latency_p50`` / ``latency_p95`` — canary slower than baseline by
  >50% relative + 10ms absolute floor (floor absorbs scheduler jitter
  at sub-ms service times).
* ``error_rate`` — canary error rate above baseline + 2 points absolute
  (floor-dominated: baseline error rates are ~0, so a relative band
  alone would trip on a single flake).

Promotion requires ``min_requests`` canary samples with NO metric
outside its band; the old version's replicas are then rolling-drained:
``begin_drain`` (in-process) or ``POST /admin/drain`` (remote), wait for
``drained`` (bounded by ``drain_timeout_s``), then stop — so no accepted
request is dropped during the roll.

A copy of the JAX package's `serving/rollout.py` for this package, with
the band rule inline.  Data plane: serving/fleet.py.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..core import telemetry
from ..io.http.clients import send_request
from ..io.http.schema import HTTPRequestData
from ..utils.sync import make_lock
from .fleet import FleetGateway, Replica

__all__ = ["RolloutController", "ROLLOUT_METRICS", "drain_and_stop"]

# metric -> (direction, relative tolerance, absolute floor): the bench
# gate's band shape.
ROLLOUT_METRICS: Dict[str, Tuple[str, float, float]] = {
    "latency_p50": ("lower", 0.50, 0.010),
    "latency_p95": ("lower", 0.50, 0.010),
    "error_rate": ("lower", 0.0, 0.02),
}


def _numeric(v: Any) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _band_compare(fresh: Dict[str, Any], base: Dict[str, Any],
                  metrics: Dict[str, Tuple[str, float, float]],
                  ) -> List[Dict[str, Any]]:
    """One row per band metric both sides carry as a number: the metric
    regresses when it is worse than `base` by more than
    ``abs(base) * rel + floor`` in its direction.  The same rule and row
    shape as the JAX package's bench gate (its `tools/perf_gate.py`
    ``compare``), kept inline so this package imports nothing outside
    itself."""
    rows: List[Dict[str, Any]] = []
    for name, (direction, rel, floor) in metrics.items():
        f, b = _numeric(fresh.get(name)), _numeric(base.get(name))
        if f is None or b is None:
            continue
        band = abs(b) * rel + floor
        worse_by = (b - f) if direction == "higher" else (f - b)
        rows.append({"metric": name, "direction": direction,
                     "base": b, "fresh": f,
                     "delta_pct": ((f - b) / b * 100.0) if b else None,
                     "band": band, "regressed": worse_by > band})
    return rows


def drain_and_stop(gateway: FleetGateway, rep: Replica,
                   drain_timeout_s: float = 10.0) -> None:
    """Gracefully retire one replica: begin_drain -> wait drained
    (bounded) -> stop.  In-process via the ServingServer handle, or
    remotely via ``POST /admin/drain`` + ``/health`` polling (a remote
    replica's process is stopped by its owner; the gateway just stops
    routing to it).  The drain mark goes through the gateway so it is
    sticky: a health probe racing this drain (remote /health still says
    draining=false) must not flip the replica back to routable.

    Shared by RolloutController (promote/rollback retirements) and
    AutoscaleController (scale-down) — one drain discipline, no
    accepted request dropped by either control loop."""
    gateway.begin_drain(rep.key)
    deadline = time.monotonic() + drain_timeout_s
    if rep.server is not None:
        rep.server.server.begin_drain()
        while (time.monotonic() < deadline
               and not rep.server.server.drained()):
            time.sleep(0.01)
        rep.server.stop(drain=False)  # already drained above
        return
    base = f"http://{rep.info.host}:{rep.info.port}"
    try:
        send_request(HTTPRequestData(
            url=base + "/admin/drain",
            headers={"Content-Type": "application/json"},
            entity=b"{}"), timeout=5.0)
        while time.monotonic() < deadline:
            resp = send_request(HTTPRequestData(
                url=base + "/health", method="GET"), timeout=2.0)
            if resp.ok and resp.json().get("drained"):
                break
            time.sleep(0.05)
    except Exception:  # noqa: BLE001 — replica died mid-drain: done
        pass


class RolloutController:
    """Drive a canary split on a :class:`FleetGateway` and auto-promote
    or auto-roll-back on the perf-band verdict.

    ``step()`` is the unit of control: call it from a cron, an operator
    loop, or ``run(poll_s)`` (a daemon thread stepping until the rollout
    resolves).  Tests call it directly for determinism.
    """

    def __init__(self, gateway: FleetGateway,
                 canary_weight: float = 0.05,
                 min_requests: int = 20,
                 metrics: Optional[Dict[str, Tuple[str, float, float]]] = None,
                 drain_timeout_s: float = 10.0):
        self.gateway = gateway
        self.canary_weight = float(canary_weight)
        self.min_requests = int(min_requests)
        self.metrics = dict(metrics or ROLLOUT_METRICS)
        self.drain_timeout_s = float(drain_timeout_s)
        self.state = "idle"
        self.baseline_version: Optional[str] = None
        self.canary_version: Optional[str] = None
        self._baseline_mark: Dict[str, Dict[str, int]] = {}
        self.last_rows: List[Dict[str, Any]] = []
        self.last_verdict: Optional[str] = None
        self.history: List[dict] = []
        self._lock = make_lock("serving.rollout.manager")
        gateway.rollout = self

    # ---- state machine -------------------------------------------------
    def begin(self, canary_version: str,
              baseline_version: Optional[str] = None,
              weight: Optional[float] = None) -> None:
        """Open the canary split.  The canary replicas must already be in
        the gateway pool (``add_server`` / ``add_replica`` / registry
        sync) under `canary_version`."""
        with self._lock:
            if self.state == "canary":
                raise RuntimeError(
                    f"rollout already in flight ({self.canary_version})")
            versions = {r.version for r in self.gateway.replicas()}
            if canary_version not in versions:
                raise ValueError(f"no replicas registered for canary "
                                 f"version {canary_version!r}")
            if baseline_version is None:
                others = sorted(versions - {canary_version})
                if len(others) != 1:
                    raise ValueError(
                        f"ambiguous baseline among {sorted(versions)}; "
                        f"pass baseline_version")
                baseline_version = others[0]
            w = self.canary_weight if weight is None else float(weight)
            self.baseline_version = baseline_version
            self.canary_version = canary_version
            # in-window deltas: mark both versions' counters at open
            self._baseline_mark = {
                v: {"n": s["requests"], "errors": s["errors"]}
                for v, s in ((v, self.gateway.version_stats(v))
                             for v in (baseline_version, canary_version))}
            self.gateway.set_version_weight(baseline_version, 1.0 - w)
            self.gateway.set_version_weight(canary_version, w)
            self.state = "canary"
            self.last_rows, self.last_verdict = [], None
            self.history.append({"event": "begin",
                                 "canary": canary_version,
                                 "baseline": baseline_version,
                                 "weight": w})

    def _window_stats(self, version: str) -> Dict[str, Any]:
        st = self.gateway.version_stats(version)
        mark = self._baseline_mark.get(version, {"n": 0, "errors": 0})
        n = st["requests"] - mark["n"]
        errors = st["errors"] - mark["errors"]
        return {
            "requests": n,
            "errors": errors,
            "error_rate": (errors / n) if n > 0 else 0.0,
            "latency_p50": st["latency_p50"],
            "latency_p95": st["latency_p95"],
        }

    def evaluate(self) -> str:
        """One perf-band verdict: 'warming' (not enough canary samples),
        'ok', or 'regressed'.  Pure read — no weight changes."""
        if self.state != "canary":
            return self.state
        canary = self._window_stats(self.canary_version)
        base = self._window_stats(self.baseline_version)
        if canary["requests"] < self.min_requests or base["requests"] < 1:
            self.last_verdict = "warming"
            return "warming"
        self.last_rows = _band_compare(canary, base, self.metrics)
        verdict = ("regressed"
                   if any(r["regressed"] for r in self.last_rows)
                   else "ok")
        self.last_verdict = verdict
        return verdict

    def step(self) -> str:
        """Evaluate and act: promote on 'ok', roll back on 'regressed'.
        Returns the controller state after the step."""
        verdict = self.evaluate()
        if verdict == "ok":
            self.promote()
        elif verdict == "regressed":
            self.rollback()
        return self.state

    def promote(self) -> None:
        """Canary takes all traffic; the old version's replicas are
        rolling-drained (no accepted request dropped) and removed."""
        with self._lock:
            if self.state != "canary":
                return
            old, new = self.baseline_version, self.canary_version
            self.gateway.set_version_weight(new, 1.0)
            self.gateway.set_version_weight(old, 0.0)
            self.state = "promoted"
            self.history.append({"event": "promote", "version": new,
                                 "rows": self.last_rows})
        telemetry.incr("serving.fleet.promote")
        for rep in self.gateway.replicas(version=old):
            self._drain_and_stop(rep)
            self.gateway.remove_replica(rep.key)

    def rollback(self) -> None:
        """Baseline takes all traffic back; canary replicas are drained,
        stopped, and removed from the pool."""
        with self._lock:
            if self.state != "canary":
                return
            old, new = self.baseline_version, self.canary_version
            self.gateway.set_version_weight(old, 1.0)
            self.gateway.set_version_weight(new, 0.0)
            self.state = "rolled_back"
            self.history.append({"event": "rollback", "version": new,
                                 "rows": self.last_rows})
        telemetry.incr("serving.fleet.rollback")
        for rep in self.gateway.replicas(version=new):
            self._drain_and_stop(rep)
            self.gateway.remove_replica(rep.key)

    # ---- rolling drain -------------------------------------------------
    def _drain_and_stop(self, rep: Replica) -> None:
        drain_and_stop(self.gateway, rep, self.drain_timeout_s)

    # ---- optional background stepping ---------------------------------
    def run(self, poll_s: float = 1.0) -> threading.Thread:
        """Step on an interval until the rollout resolves."""
        def _loop():
            while self.state == "canary":
                time.sleep(poll_s)
                self.step()
        t = threading.Thread(target=_loop, daemon=True,
                             name="fleet-rollout")
        t.start()
        return t

    # ---- observability -------------------------------------------------
    def describe(self) -> dict:
        return {
            "state": self.state,
            "baseline_version": self.baseline_version,
            "canary_version": self.canary_version,
            "canary_weight": self.canary_weight,
            "min_requests": self.min_requests,
            "last_verdict": self.last_verdict,
            "last_rows": self.last_rows,
            "history": self.history,
        }
