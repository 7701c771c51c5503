"""Fleet control plane, capacity half: the autoscale signal bus.

Replica counts driven from the serving.batcher queue / latency
telemetry, next to the RolloutController: this closes the loop from the
federated telemetry plane back into the gateway's pool:

* :class:`CapacityModel` is pure math: fold the merged fleet view
  (queue depth, batch fill, SLO burn rate, per-replica HBM headroom)
  plus the live pool shape into one replica-count recommendation with
  stated reasons.  No sockets, no threads — unit-testable on dict
  fixtures.
* :class:`AutoscaleController` consumes recommendations next to the
  RolloutController: scale-UP provisions replicas through an injected
  ``provisioner(count)`` callback (the operator owns process creation —
  k8s, subprocess pool, in-process servers in tests); scale-DOWN reuses
  the rollout's :func:`~mmlspark_tpu_torch.serving.rollout.drain_and_stop`
  graceful drain, so no accepted request is dropped by a scale event.
  Hysteresis (N consecutive agreeing recommendations) plus a cooldown
  clock keep canary traffic shifts and probe flaps from flapping the
  pool size.  It also garbage-collects replicas that stayed dead past a
  grace window — removing them from the registered set is what lets an
  availability alert RESOLVE once replacements are live.

Clock-injectable (`utils.faults.monotonic`) so cooldown/hysteresis are
testable under a VirtualClock.  A copy of the JAX package's
`serving/autoscale.py` for this package; this package records no device
memory gauges yet, so the HBM-headroom signal stays silent here.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional

from ..core import telemetry
from ..core.telemetry.fleet import hist_total
from ..utils.faults import monotonic as _monotonic
from ..utils.sync import make_lock
from .fleet import FleetGateway, Replica
from .rollout import drain_and_stop

__all__ = ["CapacityModel", "AutoscaleController"]

# merged-view gauge names folded into the queue-pressure signal
_QUEUE_GAUGES = ("serving.queue.depth", "serving.batcher.queue_depth")
_FILL_HISTS = ("serving.batch.fill", "serving.batcher.batch_fill")


class CapacityModel:
    """Replica-count recommendation from the merged fleet view.

    Signals, strongest first:

    * **burn** — an SLO alert pending/firing means the fleet is eating
      error budget NOW: recommend at least the registered count
      (replace whatever died) plus one when the burn is not an
      availability gap (latency/deadline burn needs more capacity, not
      just replacement).
    * **queue** — total queued work / `target_queue_per_replica` is the
      steady-state demand floor.
    * **fill** — median batch fill above `fill_high` means batches are
      packing full (capacity bound); below `fill_low` the pool is
      padding batches (over-provisioned).
    * **HBM headroom** — with a configured `hbm_limit_bytes`, a replica
      whose in-use bytes leave less than `hbm_headroom_frac` headroom
      argues one replica up (spillover room before OOM).

    Scale-down is deliberately timid: only when NO pressure signal is
    up does the model step down, one replica at a time.
    """

    def __init__(self,
                 target_queue_per_replica: float = 8.0,
                 fill_high: float = 0.85,
                 fill_low: float = 0.30,
                 hbm_limit_bytes: Optional[float] = None,
                 hbm_headroom_frac: float = 0.10,
                 min_replicas: int = 1,
                 max_replicas: int = 8):
        self.target_queue_per_replica = float(target_queue_per_replica)
        self.fill_high = float(fill_high)
        self.fill_low = float(fill_low)
        self.hbm_limit_bytes = hbm_limit_bytes
        self.hbm_headroom_frac = float(hbm_headroom_frac)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)

    # ---- signal extraction ---------------------------------------------

    @staticmethod
    def _total_queue(merged: Mapping[str, Any]) -> float:
        g = merged.get("gauges") or {}
        total = 0.0
        for name in _QUEUE_GAUGES:
            for rkey, v in (g.get(name) or {}).items():
                if rkey != "gateway":
                    total += float(v)
        return total

    @staticmethod
    def _fill_p50(merged: Mapping[str, Any]) -> Optional[float]:
        parts = [hist_total(merged, name) for name in _FILL_HISTS]
        parts = [p for p in parts if p["count"] > 0]
        if not parts:
            return None
        # take the busiest fill family (server-level vs batcher-level)
        best = max(parts, key=lambda p: p["count"])
        return best.get("p50")

    def _hbm_pressure(self, merged: Mapping[str, Any]) -> bool:
        if not self.hbm_limit_bytes:
            return False
        per = (merged.get("gauges") or {}).get(
            "device.hbm.bytes_in_use") or {}
        for rkey, used in per.items():
            if rkey == "gateway":
                continue
            headroom = 1.0 - float(used) / float(self.hbm_limit_bytes)
            if headroom < self.hbm_headroom_frac:
                return True
        return False

    # ---- the recommendation --------------------------------------------

    def recommend(self, merged: Mapping[str, Any],
                  alerts: List[Mapping[str, Any]],
                  n_routable: int, n_registered: int) -> Dict[str, Any]:
        reasons: List[str] = []
        needs: List[int] = [n_routable]

        hot = [a for a in alerts if a.get("state") in ("pending", "firing")]
        if hot:
            worst = max(hot, key=lambda a: a.get("burn_fast", 0.0))
            if worst["slo"] == "availability":
                # replicas died: restore to the registered strength
                need = max(n_registered, n_routable + 1)
                reasons.append(
                    f"availability burn {worst.get('burn_fast')}x: "
                    f"replace dead replicas ({n_routable}/{n_registered} "
                    f"routable)")
            else:
                need = n_routable + 1
                reasons.append(f"{worst['slo']} burn "
                               f"{worst.get('burn_fast')}x: add capacity")
            needs.append(need)

        queue = self._total_queue(merged)
        need_q = int(math.ceil(queue / self.target_queue_per_replica)) \
            if queue > 0 else 0
        if need_q > n_routable:
            reasons.append(f"queue depth {queue:g} wants {need_q} replicas")
            needs.append(need_q)

        fill = self._fill_p50(merged)
        if fill is not None and fill >= self.fill_high:
            reasons.append(f"batch fill p50 {fill:.2f} >= "
                           f"{self.fill_high:.2f}")
            needs.append(n_routable + 1)

        if self._hbm_pressure(merged):
            reasons.append("HBM headroom below "
                           f"{self.hbm_headroom_frac:.0%}")
            needs.append(n_routable + 1)

        target = max(needs)
        if target <= n_routable and not reasons:
            # scale-down path: every pressure signal quiet AND fill low
            idle = (fill is None or fill <= self.fill_low) and \
                need_q < n_routable and queue == 0.0
            if idle and n_routable > self.min_replicas:
                target = n_routable - 1
                reasons.append(
                    "no pressure: queue empty"
                    + (f", fill p50 {fill:.2f}" if fill is not None else ""))
        target = max(self.min_replicas, min(self.max_replicas, target))
        return {
            "target": target,
            "routable": n_routable,
            "registered": n_registered,
            "reasons": reasons,
            "inputs": {"queue": queue, "fill_p50": fill,
                       "alerts": {a["slo"]: a["state"] for a in alerts}},
        }


class AutoscaleController:
    """Act on CapacityModel recommendations against a live gateway.

    ``evaluate_once()`` is the unit of control (tests call it directly;
    ``run(poll_s)`` steps it on a daemon thread).  One evaluation:

    1. garbage-collect replicas dead past `dead_grace_s` (unroutable,
       unhealthy, never recovered) — shrinking the registered set so an
       availability alert can resolve once replacements carry traffic;
    2. read the telemetry plane's merged view + alert states;
    3. fold through the model; publish ``autoscale.target_replicas``;
    4. act only when `hysteresis` consecutive recommendations agree on
       the direction AND the cooldown has elapsed: scale-up through the
       provisioner callback, scale-down through the shared rollout
       drain.
    """

    def __init__(self, gateway: FleetGateway,
                 provisioner: Optional[Callable[[int], int]] = None,
                 model: Optional[CapacityModel] = None,
                 cooldown_s: float = 10.0,
                 hysteresis: int = 2,
                 drain_timeout_s: float = 5.0,
                 dead_grace_s: float = 1.0,
                 clock: Callable[[], float] = _monotonic):
        self.gateway = gateway
        self.provisioner = provisioner
        self.model = model or CapacityModel()
        self.cooldown_s = float(cooldown_s)
        self.hysteresis = max(1, int(hysteresis))
        self.drain_timeout_s = float(drain_timeout_s)
        self.dead_grace_s = float(dead_grace_s)
        self._clock = clock
        self._lock = make_lock("serving.fleet.autoscale")
        self._dead_since: Dict[str, float] = {}  #: guarded-by self._lock
        self._pending_dir: List[int] = []  #: guarded-by self._lock
        self._last_action = -math.inf  #: guarded-by self._lock
        self.last: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, Any]] = []
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        gateway.autoscale = self

    # ---- dead-replica GC -----------------------------------------------

    def _gc_dead(self, now: float) -> List[str]:
        removed: List[str] = []
        reps = self.gateway.replicas()
        live = {r.key for r in reps}
        with self._lock:
            for k in [k for k in self._dead_since if k not in live]:
                del self._dead_since[k]
            for rep in reps:
                if rep.healthy or rep.draining:
                    self._dead_since.pop(rep.key, None)
                    continue
                since = self._dead_since.setdefault(rep.key, now)
                if now - since >= self.dead_grace_s:
                    removed.append(rep.key)
        for key in removed:
            self.gateway.remove_replica(key)
            with self._lock:
                self._dead_since.pop(key, None)
        return removed

    # ---- the control step ----------------------------------------------

    def evaluate_once(self) -> Dict[str, Any]:
        now = self._clock()
        removed = self._gc_dead(now)
        plane = self.gateway.telemetry_plane
        merged = plane.merged()
        if merged is None:
            merged = plane.ensure_fresh()
        alerts = plane.engine.alerts()
        reps = self.gateway.replicas()
        n_routable = sum(1 for r in reps if r.routable())
        n_registered = len(reps)
        rec = self.model.recommend(merged, alerts, n_routable,
                                   n_registered)
        telemetry.gauge("autoscale.target_replicas").set(rec["target"])
        direction = (1 if rec["target"] > n_routable
                     else -1 if rec["target"] < n_routable else 0)
        with self._lock:
            self._pending_dir.append(direction)
            del self._pending_dir[:-self.hysteresis]
            agreed = (direction != 0
                      and len(self._pending_dir) >= self.hysteresis
                      and all(d == direction for d in self._pending_dir))
            cooled = now - self._last_action >= self.cooldown_s
        action = "none"
        if agreed and cooled:
            if direction > 0:
                added = self._scale_up(rec["target"] - n_routable)
                action = f"up+{added}" if added else "up_failed"
            else:
                action = "down-1" if self._scale_down() else "down_failed"
            with self._lock:
                self._last_action = now
                self._pending_dir.clear()
        rec = dict(rec, action=action, gc_removed=removed, t=now)
        self.last = rec
        self.history.append(rec)
        del self.history[:-64]
        return rec

    def _scale_up(self, count: int) -> int:
        if self.provisioner is None:
            return 0
        try:
            added = int(self.provisioner(count) or 0)
        except Exception:  # noqa: BLE001 — a broken provisioner must not
            added = 0      # kill the control loop
        if added > 0:
            telemetry.incr("autoscale.up", added)
        return added

    def _scale_down(self) -> bool:
        """Drain the least-loaded routable replica (never below the
        model floor — recommend() already enforced it)."""
        pool = [r for r in self.gateway.replicas() if r.routable()]
        if len(pool) <= self.model.min_replicas:
            return False
        victim = min(pool, key=lambda r: r.inflight)
        drain_and_stop(self.gateway, victim, self.drain_timeout_s)
        self.gateway.remove_replica(victim.key)
        telemetry.incr("autoscale.down")
        return True

    # ---- lifecycle -----------------------------------------------------

    def run(self, poll_s: float = 0.5) -> threading.Thread:
        self._stop_evt.clear()
        def _loop():
            while not self._stop_evt.wait(poll_s):
                try:
                    self.evaluate_once()
                except Exception:  # noqa: BLE001 — control loop survives
                    pass
        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="fleet-autoscale")
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def describe(self) -> dict:
        return {
            "cooldown_s": self.cooldown_s,
            "hysteresis": self.hysteresis,
            "min_replicas": self.model.min_replicas,
            "max_replicas": self.model.max_replicas,
            "last": self.last,
            "history": self.history[-8:],
        }
