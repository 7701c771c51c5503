"""Fleet soak on mmlspark_tpu_torch: kill replicas mid-traffic behind the
gateway, assert exactly-once.

The port's counterpart of tools/fleet_soak.py (same scenarios, sizes and
assertions; it imports mmlspark_tpu_torch only).  It runs >= 2 real
ServingServer replicas behind a FleetGateway (serving/fleet.py) whose
model computes through a DeviceFeed on `device` (the card unless
``device="cpu"``), while concurrent clients post through the gateway,
then hard-kills one replica mid-traffic (`stop(drain=False)` — the
process-death simulation) and later revives a fresh server on the SAME
address:

  * requests in flight at the kill resolve as upstream 504s or transport
    errors — both retried on the surviving replica within the client's
    deadline budget;
  * new forwards to the dead address get connection-refused -> the
    replica's circuit breaker opens (`serving.fleet.eject`);
  * the revived server answers the gateway's active /health probe ->
    breaker closes, replica reinstated (`serving.fleet.reinstate`) and
    verifiably serves the second traffic wave.

The invariant is the fleet-level exactly-once contract: EVERY client
request is answered exactly once with ITS OWN correct payload (y = 3*v),
0 lost, 0 duplicated, across both the kill and the revival.

Usage: python tools/torch_fleet_soak.py [--seed N] [--requests N]
                                        [--obs] [--device cpu] [--json]

`--obs` drives the telemetry plane end to end instead: kill a replica
mid-traffic, assert the availability SLO alert fires within one fast
burn window, the AutoscaleController provisions a replacement, the
flight recorder dumps an incident bundle, and the alert resolves — all
under the same exactly-once audit.

Also importable (tests/test_torch_soaks.py): run_soak(...) /
run_obs_soak(...) return the summary.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _make_server(host: str = "127.0.0.1", port: int = 0, device=None):
    import numpy as np

    from mmlspark_tpu_torch.core.pipeline import LambdaTransformer
    from mmlspark_tpu_torch.io.feed import DeviceFeed
    from mmlspark_tpu_torch.serving import ServingServer

    feed = DeviceFeed(device)

    def fn(table):
        v = np.asarray(table["v"], np.int64)
        y = (feed.put(v) * 3).cpu().numpy()  # the compute on the device
        return table.with_column("y", y)

    srv = ServingServer(
        LambdaTransformer(fn), reply_col="y", name="fleet-soak",
        host=host, port=port, input_schema=["v"],
        max_batch=8, batch_timeout_ms=10.0, max_queue=256)
    # a hard-killed replica's held exchanges resolve (504) on this bound;
    # keep it short so the gateway's retry answers the client quickly
    srv.server.handler_timeout = 1.5
    return srv


def run_soak(seed: int = 7, n_requests: int = 60, n_replicas: int = 2,
             kill_after: int = 15, n_verify: int = 24,
             concurrency: int = 8, deadline_ms: float = 20000.0,
             device=None) -> dict:
    """Drive the kill/revive scenario; returns the summary dict.
    Raises AssertionError on any lost/duplicated/cross-wired reply or a
    missing eject/reinstate transition."""
    import random

    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.io.http.clients import send_request
    from mmlspark_tpu_torch.io.http.schema import to_http_request
    from mmlspark_tpu_torch.serving import FleetGateway

    assert n_replicas >= 2, "the kill scenario needs a surviving replica"
    c0 = telemetry.counters()

    replicas = [_make_server(device=device) for _ in range(n_replicas)]
    for r in replicas:
        r.start()
    gw = FleetGateway(name=f"fleet-soak-{replicas[0].service_info.port}",
                      probe_interval_s=0.05, retries=max(2, n_replicas),
                      breaker_threshold=1, breaker_reset_s=0.3,
                      forward_timeout_s=10.0,
                      rng=random.Random(seed))
    handles = [gw.add_server(r, version="v1") for r in replicas]
    gw.start()

    results: dict = {}
    res_lock = threading.Lock()

    def post(i: int):
        r = send_request(to_http_request(
            gw.url, {"v": i},
            headers={"X-Deadline-Ms": str(deadline_ms)}), timeout=15.0)
        try:
            payload = r.json()
        except ValueError:
            payload = r.entity
        with res_lock:
            results.setdefault(i, []).append((r.status_code, payload))

    def wave(ids, on_count=None, action=None):
        """Post `ids` with at most `concurrency` in flight.  `action`
        fires (from a watcher thread) as soon as `on_count` replies have
        landed — i.e. mid-wave, with requests still in the air."""
        sem = threading.BoundedSemaphore(concurrency)

        def run(i):
            try:
                post(i)
            finally:
                sem.release()

        watcher = None
        if action is not None:
            def watch():
                while True:
                    with res_lock:
                        if len(results) >= on_count:
                            break
                    time.sleep(0.005)
                action()

            watcher = threading.Thread(target=watch, daemon=True,
                                       name="fleet-soak-watch")
            watcher.start()
        threads = []
        for i in ids:
            sem.acquire()
            t = threading.Thread(target=run, args=(i,), daemon=True,
                                 name=f"fleet-soak-client-{i}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive(), \
                "client thread still waiting: a reply was lost"
        if watcher is not None:
            watcher.join(timeout=30.0)

    victim = replicas[0]
    victim_info = victim.service_info
    kill_done = threading.Event()

    def kill():
        victim.stop(drain=False)  # hard stop: the process-death analog
        kill_done.set()

    try:
        # ---- wave 1: kill mid-traffic ------------------------------
        wave(range(n_requests), on_count=kill_after, action=kill)
        assert kill_done.is_set(), "scripted kill never fired"

        # exactly-once, correct-payload audit
        lost = [i for i in range(n_requests) if not results.get(i)]
        dup = {i: r for i, r in results.items() if len(r) > 1}
        wrong = {i: r for i, r in results.items()
                 if len(r) == 1 and (r[0][0] != 200
                                     or r[0][1] != {"y": 3 * i})}
        assert not lost, f"lost replies: {lost}"
        assert not dup, f"duplicated replies: {dup}"
        assert not wrong, f"wrong/cross-wired replies: {wrong}"

        c1 = telemetry.counters()
        ejects = c1.get("serving.fleet.eject", 0) - \
            c0.get("serving.fleet.eject", 0)
        retries = c1.get("serving.fleet.retry", 0) - \
            c0.get("serving.fleet.retry", 0)
        assert ejects >= 1, "dead replica was never ejected"
        dead = handles[0]
        assert not dead.routable(), "dead replica still routable"

        # ---- revive on the SAME address ----------------------------
        revived = _make_server(host=victim_info.host,
                               port=victim_info.port, device=device)
        revived.start()
        handles[0].server = revived  # fresh lifecycle handle
        replicas[0] = revived
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not dead.routable():
            time.sleep(0.05)
        assert dead.routable(), "probe never reinstated revived replica"
        c2 = telemetry.counters()
        reinstates = c2.get("serving.fleet.reinstate", 0) - \
            c0.get("serving.fleet.reinstate", 0)
        assert reinstates >= 1, "reinstate counter never fired"

        # ---- wave 2: revived replica verifiably serves -------------
        served_before = dead.forwarded
        wave(range(n_requests, n_requests + n_verify))
        lost2 = [i for i in range(n_requests, n_requests + n_verify)
                 if not results.get(i)]
        wrong2 = {i: r for i, r in results.items()
                  if i >= n_requests and (len(r) != 1 or r[0][0] != 200
                                          or r[0][1] != {"y": 3 * i})}
        assert not lost2 and not wrong2, (lost2, wrong2)
        revived_served = dead.forwarded - served_before
        assert revived_served > 0, \
            "revived replica took no traffic after reinstatement"

        return {
            "requests": n_requests + n_verify,
            "lost": 0,
            "duplicated": 0,
            "ejects": ejects,
            "retries": retries,
            "reinstates": reinstates,
            "revived_served": revived_served,
            "per_replica_forwarded": {h.key: h.forwarded for h in handles},
        }
    finally:
        gw.stop()
        for r in replicas:
            try:
                r.stop(drain=False)
            except Exception:  # noqa: BLE001 — victim already stopped
                pass


def run_obs_soak(seed: int = 7, n_requests: int = 40, n_replicas: int = 2,
                 kill_after: int = 12, n_verify: int = 24,
                 concurrency: int = 8, deadline_ms: float = 20000.0,
                 fast_window_s: float = 0.5, slow_window_s: float = 1.5,
                 incident_dir: str | None = None, device=None) -> dict:
    """The observability-plane soak: kill → alert fires (within one fast
    window) → autoscale provisions a replacement → incident bundle on
    disk → alert resolves, with the fleet exactly-once audit throughout.
    Raises AssertionError on any broken link in that chain."""
    import random
    import tempfile

    from mmlspark_tpu_torch.core import telemetry
    from mmlspark_tpu_torch.io.http.clients import send_request
    from mmlspark_tpu_torch.io.http.schema import to_http_request
    from mmlspark_tpu_torch.serving import AutoscaleController, CapacityModel, \
        FleetGateway

    assert n_replicas >= 2, "the kill scenario needs a surviving replica"
    own_tmp = None
    if incident_dir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="obs-soak-")
        incident_dir = own_tmp.name

    replicas = [_make_server(device=device) for _ in range(n_replicas)]
    for r in replicas:
        r.start()
    gw = FleetGateway(name=f"obs-soak-{replicas[0].service_info.port}",
                      probe_interval_s=0.05, retries=max(2, n_replicas),
                      breaker_threshold=1, breaker_reset_s=0.3,
                      forward_timeout_s=10.0,
                      rng=random.Random(seed),
                      telemetry_interval_s=0.1,
                      incident_dir=incident_dir,
                      slos=telemetry.default_slos(
                          fast_window_s=fast_window_s,
                          slow_window_s=slow_window_s))
    for r in replicas:
        gw.add_server(r, version="v1")
    transitions: list = []  # (slo, old, new, t_monotonic)
    gw.telemetry_plane.engine.on_transition(
        lambda slo, old, new, info: transitions.append(
            (slo.name, old, new, time.monotonic())))
    gw.start()

    provisioned: list = []

    def provision(count: int) -> int:
        for _ in range(count):
            srv = _make_server(device=device)
            srv.start()
            provisioned.append(srv)
            gw.add_server(srv, version="v1")
        return count

    ctl = AutoscaleController(
        gw, provisioner=provision,
        model=CapacityModel(min_replicas=n_replicas,
                            max_replicas=n_replicas + 2),
        cooldown_s=1.0, hysteresis=2, dead_grace_s=0.3)
    ctl.run(poll_s=0.05)

    results: dict = {}
    res_lock = threading.Lock()

    def post(i: int):
        r = send_request(to_http_request(
            gw.url, {"v": i},
            headers={"X-Deadline-Ms": str(deadline_ms)}), timeout=15.0)
        try:
            payload = r.json()
        except ValueError:
            payload = r.entity
        with res_lock:
            results.setdefault(i, []).append((r.status_code, payload))

    def wave(ids, on_count=None, action=None):
        sem = threading.BoundedSemaphore(concurrency)

        def run(i):
            try:
                post(i)
            finally:
                sem.release()

        watcher = None
        if action is not None:
            def watch():
                while True:
                    with res_lock:
                        if len(results) >= on_count:
                            break
                    time.sleep(0.005)
                action()

            watcher = threading.Thread(target=watch, daemon=True,
                                       name="fleet-soak-watch")
            watcher.start()
        threads = []
        for i in ids:
            sem.acquire()
            t = threading.Thread(target=run, args=(i,), daemon=True,
                                 name=f"fleet-soak-client-{i}")
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive(), \
                "client thread still waiting: a reply was lost"
        if watcher is not None:
            watcher.join(timeout=30.0)

    victim = replicas[0]
    victim_rep = next(r for r in gw.replicas()
                      if r.info.port == victim.service_info.port)
    kill_done = threading.Event()
    detect_t = [0.0]

    def kill():
        victim.stop(drain=False)
        kill_done.set()

    def detect():
        # the failure is observable once the gateway stops routing to
        # the victim (probe/breaker/pull-failure — whichever is first);
        # the "fires within one fast window" clock starts THERE, not at
        # kill initiation (the dying socket can linger handler_timeout)
        kill_done.wait(30.0)
        while victim_rep.routable():
            time.sleep(0.005)
        detect_t[0] = time.monotonic()

    detector = threading.Thread(target=detect, daemon=True,
                                name="fleet-soak-detect")
    detector.start()

    def audit(ids):
        lost = [i for i in ids if not results.get(i)]
        dup = {i: r for i, r in results.items()
               if i in ids and len(r) > 1}
        wrong = {i: r for i, r in results.items()
                 if i in ids and len(r) == 1
                 and (r[0][0] != 200 or r[0][1] != {"y": 3 * i})}
        assert not lost, f"lost replies: {lost}"
        assert not dup, f"duplicated replies: {dup}"
        assert not wrong, f"wrong/cross-wired replies: {wrong}"

    try:
        # ---- kill a replica mid-traffic ----------------------------
        wave(range(n_requests), on_count=kill_after, action=kill)
        assert kill_done.is_set(), "scripted kill never fired"
        audit(range(n_requests))

        # ---- the availability alert fires within one fast window ---
        # the wave above blocks past the whole fire->resolve cycle, so
        # the firing time comes from the timestamped transition log, not
        # from polling the live state
        detector.join(timeout=30.0)
        assert detect_t[0] > 0.0, "gateway never unrouted the victim"
        engine = gw.telemetry_plane.engine

        def _transition_t(old, new):
            return next((t for (n, o, nw, t) in list(transitions)
                         if n == "availability" and (old is None
                                                     or o == old)
                         and nw == new), None)

        budget = fast_window_s + 0.5  # one window + pull-interval slack
        deadline = detect_t[0] + budget
        fire_t = _transition_t("pending", "firing")
        while time.monotonic() < deadline and fire_t is None:
            time.sleep(0.02)
            fire_t = _transition_t("pending", "firing")
        assert fire_t is not None, (
            f"availability alert never fired within {budget:.1f}s of the "
            f"victim going unroutable: {engine.alerts()}")
        fired_after = fire_t - detect_t[0]
        assert fired_after <= budget, (
            f"availability alert took {fired_after:.2f}s after detection "
            f"(budget {budget:.1f}s = one fast window + pull slack)")

        # ---- autoscale provisions a replacement --------------------
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not provisioned:
            time.sleep(0.02)
        assert provisioned, (
            f"autoscale never provisioned a replacement: {ctl.last}")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            routable = sum(1 for r in gw.replicas() if r.routable())
            if routable >= n_replicas:
                break
            time.sleep(0.02)
        assert routable >= n_replicas, \
            f"pool never recovered to {n_replicas} routable replicas"

        # ---- the alert resolves ------------------------------------
        deadline = time.monotonic() + slow_window_s + 5.0
        while time.monotonic() < deadline and \
                _transition_t("firing", "resolved") is None:
            time.sleep(0.02)
        assert _transition_t("firing", "resolved") is not None, (
            f"availability alert never resolved: {engine.alerts()} "
            f"/ {transitions}")

        # ---- incident bundle on disk -------------------------------
        bundles = gw.telemetry_plane.recorder.bundles()
        assert bundles, "flight recorder wrote no incident bundle"
        manifest = Path(bundles[0]) / "MANIFEST.json"
        assert manifest.exists(), f"no MANIFEST.json in {bundles[0]}"

        # ---- verify wave through the recovered pool ----------------
        wave(range(n_requests, n_requests + n_verify))
        audit(range(n_requests, n_requests + n_verify))

        merged = gw.telemetry_plane.ensure_fresh()
        return {
            "requests": n_requests + n_verify,
            "lost": 0,
            "duplicated": 0,
            "alert_fired_after_s": round(fired_after, 3),
            "fast_window_s": fast_window_s,
            "provisioned": len(provisioned),
            "incidents": len(bundles),
            "transitions": [(n, o, nw) for (n, o, nw, _t) in transitions],
            "routable": sum(1 for r in gw.replicas() if r.routable()),
            "fleet_sources": merged["meta"]["replica_count"],
        }
    finally:
        ctl.stop()
        gw.stop()
        for r in replicas + provisioned:
            try:
                r.stop(drain=False)
            except Exception:  # noqa: BLE001 — victim already stopped
                pass
        if own_tmp is not None:
            own_tmp.cleanup()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="the replicas' device: the card unless 'cpu'")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON")
    ap.add_argument("--obs", action="store_true",
                    help="run the observability-plane soak (kill -> "
                         "alert -> autoscale -> incident -> resolve)")
    ap.add_argument("--incident-dir", default=None,
                    help="--obs: keep incident bundles here instead of "
                         "a temp dir")
    args = ap.parse_args(argv)
    if args.obs:
        report = run_obs_soak(seed=args.seed, n_requests=args.requests,
                              n_replicas=args.replicas,
                              incident_dir=args.incident_dir,
                              device=args.device)
    else:
        report = run_soak(seed=args.seed, n_requests=args.requests,
                          n_replicas=args.replicas, device=args.device)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print("obs-soak OK:" if args.obs else "fleet-soak OK:", report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
