"""The port's fleet observability on the CPU: federated metrics merging,
cross-process trace stitching, the SLO burn-rate state machine, the
autoscale signal bus, the flight recorder and the registry-TTL-on-read
regression — the scenarios of the JAX suite's tests/test_fleet_obs.py
over `mmlspark_tpu_torch` (its obs_report rendering test waits for the
port of the report renderers) — and the pure functions held against the
JAX package: on the same snapshots, spans, alert views and clocks, the
port's merges, Prometheus text, stitched traces, SLO transitions,
capacity recommendations and autoscale decisions equal the JAX
package's exactly.

The federation tests run against REAL subprocess replicas of the port
(tests/torch_fleet_worker.py), each with JAX refused at import.
"""
import json
import math
import os
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import pytest
import torch

from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.core.telemetry import fleet as tfleet
from mmlspark_tpu_torch.core.telemetry.metrics import BUCKET_FAMILIES, Histogram
from mmlspark_tpu_torch.io.http.clients import send_request
from mmlspark_tpu_torch.io.http.schema import HTTPRequestData, to_http_request
from mmlspark_tpu_torch.serving import FleetGateway, ServiceInfo, ServingServer
from mmlspark_tpu_torch.serving.autoscale import AutoscaleController, CapacityModel
from mmlspark_tpu_torch.utils.faults import VirtualClock

torch.set_num_threads(2)

WORKER = Path(__file__).resolve().parent / "torch_fleet_worker.py"

LATENCY = BUCKET_FAMILIES["latency"]


def _counter(name):
    return telemetry.counters().get(name, 0)


def _gw_name(tag):
    # breaker registry keys are process-global and config applies on
    # first construction: a unique gateway name per test isolates them
    return f"{tag}-{uuid.uuid4().hex[:8]}"


def _mk_server(**kw):
    import numpy as np

    from mmlspark_tpu_torch.core.pipeline import LambdaTransformer

    def fn(table):
        v = np.asarray(table["v"], np.int64)
        return table.with_column("y", v * 3)

    kw.setdefault("max_batch", 8)
    kw.setdefault("batch_timeout_ms", 5.0)
    return ServingServer(LambdaTransformer(fn), reply_col="y",
                         name="fleet-obs-test", input_schema=["v"], **kw)


def _post(url, payload, headers=None, timeout=10.0):
    return send_request(to_http_request(url, payload, headers=headers),
                        timeout=timeout)


def _get(url, timeout=10.0):
    return send_request(HTTPRequestData(url=url, method="GET"),
                        timeout=timeout)


# ---------------------------------------------------------------------------
# histogram merge exactness (pure units)
# ---------------------------------------------------------------------------

def _json_roundtrip(snap):
    """What a replica's snapshot looks like after the /metrics.json
    wire trip: the +Inf edge in its JSON spelling."""
    wire = dict(snap)
    wire["buckets"] = [["+Inf" if le == math.inf else le, cum]
                      for le, cum in snap["buckets"]]
    return json.loads(json.dumps(wire))


class TestHistogramMerge:
    def test_merge_exactness_through_json_roundtrip(self):
        h1, h2 = Histogram("a", LATENCY), Histogram("b", LATENCY)
        vals1 = [1e-5, 3e-4, 0.002, 0.002, 0.4, 2.0]
        vals2 = [7e-6, 0.03, 0.03, 0.9]
        for v in vals1:
            h1.observe(v)
        for v in vals2:
            h2.observe(v)
        parts = [_json_roundtrip(h1.snapshot()),
                 _json_roundtrip(h2.snapshot())]
        merged = telemetry.merge_histogram_snapshots(parts, key="a")
        assert merged["count"] == len(vals1) + len(vals2)
        assert merged["sum"] == pytest.approx(sum(vals1) + sum(vals2))
        # cumulative buckets add element-wise — the exactness contract
        for i, (le, cum) in enumerate(merged["buckets"]):
            want = sum(int(p["buckets"][i][1]) for p in parts)
            assert cum == want, f"bucket le={le} inexact"
        # percentiles recomputed from the merged ladder match a single
        # histogram holding the union of observations
        union = Histogram("u", LATENCY)
        for v in vals1 + vals2:
            union.observe(v)
        for q, k in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
            assert merged[k] == pytest.approx(union.percentile(q))

    def test_mismatched_edges_raise(self):
        h1 = Histogram("a", (0.1, 1.0))
        h2 = Histogram("b", (0.2, 1.0))
        h1.observe(0.05)
        h2.observe(0.05)
        with pytest.raises(ValueError, match="bucket edges differ"):
            telemetry.merge_histogram_snapshots(
                [h1.snapshot(), h2.snapshot()], key="a")

    def test_merge_snapshots_counters_sum_gauges_split(self):
        src_a = {"meta": {"pid": 1},
                 "counters": {"req": 3, "only_a": 1},
                 "gauges": {"queue": 2.0},
                 "histograms": {}}
        src_b = {"meta": {"pid": 2},
                 "counters": {"req": 5},
                 "gauges": {"queue": 7.0},
                 "histograms": {}}
        m = telemetry.merge_snapshots({"a:1": src_a, "b:2": src_b},
                                      versions={"a:1": "v1"})
        assert m["counters"] == {"req": 8, "only_a": 1}
        assert m["counters_by_replica"]["b:2"] == {"req": 5}
        # gauges keep the per-replica split; consumers fold
        assert m["gauges"]["queue"] == {"a:1": 2.0, "b:2": 7.0}
        assert m["meta"]["replica_count"] == 2
        assert m["replicas"]["a:1"]["version"] == "v1"

    def test_render_fleet_prometheus_sums_exactly(self):
        h = Histogram("h", (0.1, 1.0))
        for v in (0.05, 0.5, 0.5):
            h.observe(v)
        snap = _json_roundtrip(h.snapshot())
        src = {"counters": {"req": 2}, "gauges": {},
               "histograms": {"serving.request.latency": snap}}
        m = telemetry.merge_snapshots({"a:1": src, "b:2": src})
        text = telemetry.render_fleet_prometheus(m)
        assert 'req{replica="a:1"} 2' in text
        assert "\nreq 4" in text
        assert ('serving_request_latency_count{replica="a:1"} 3'
                in text)
        assert "\nserving_request_latency_count 6" in text


# ---------------------------------------------------------------------------
# span stitching (pure units)
# ---------------------------------------------------------------------------

class TestStitchSpans:
    def test_cross_source_nesting_and_dedup(self):
        tid = "t1"
        root = {"trace_id": tid, "span_id": "g1", "parent_id": None,
                "t_start": 1.0, "name": "gw.request"}
        child = {"trace_id": tid, "span_id": "r1", "parent_id": "g1",
                 "t_start": 1.1, "name": "replica.handle"}
        other = {"trace_id": "other", "span_id": "x", "parent_id": None,
                 "t_start": 0.5, "name": "noise"}
        stitched = telemetry.stitch_spans(tid, {
            "gateway": [root, other],
            # replica probed twice: same records twice, plus the
            # gateway's root re-reported — all dedupe by span_id
            "r:1": [child, child, dict(root)],
        })
        assert stitched["span_count"] == 2
        assert stitched["sources"] == ["gateway", "r:1"]
        assert len(stitched["tree"]) == 1
        top = stitched["tree"][0]
        assert top["span_id"] == "g1" and top["source"] == "gateway"
        # the cross-process edge: a child whose parent lives in
        # ANOTHER process still nests under it
        assert [c["span_id"] for c in top["children"]] == ["r1"]
        assert top["children"][0]["source"] == "r:1"


# ---------------------------------------------------------------------------
# SLO state machine under a VirtualClock
# ---------------------------------------------------------------------------

def _availability_slo(**kw):
    def good_total(m):
        g = m.get("gauges") or {}
        return (sum((g.get("healthy") or {}).values()),
                sum((g.get("replicas") or {}).values()))

    kw.setdefault("fast_window_s", 0.5)
    kw.setdefault("slow_window_s", 1.0)
    kw.setdefault("burn_threshold", 10.0)
    return telemetry.SLO("availability", 0.999, good_total,
                         kind="instant", **kw)


def _view(healthy, total):
    return {"gauges": {"healthy": {"gw": float(healthy)},
                       "replicas": {"gw": float(total)}}}


class TestSLOEngine:
    def test_pending_firing_resolved_inactive(self):
        vc = VirtualClock()
        slo = _availability_slo(for_s=1.0)
        eng = telemetry.SLOEngine([slo], clock=vc.monotonic)
        seen = []
        eng.on_transition(lambda s, old, new, info:
                          seen.append((old, new, dict(info))))
        c0 = _counter("slo.alert.firing")

        eng.observe(_view(3, 3))
        assert eng.state("availability") == "inactive"

        eng.observe(_view(1, 3))            # burn hits, dwell starts
        assert eng.state("availability") == "pending"
        vc.advance(0.4)
        eng.observe(_view(1, 3))            # still inside for_s
        assert eng.state("availability") == "pending"
        vc.advance(0.7)
        eng.observe(_view(1, 3))            # dwell elapsed -> firing
        assert eng.state("availability") == "firing"
        assert _counter("slo.alert.firing") == c0 + 1
        assert _counter("slo.alert.firing.availability") >= 1

        # recovery: burn stays hot until the bad samples age out of
        # BOTH windows (the multi-window guard), then firing->resolved
        vc.advance(1.5)
        eng.observe(_view(3, 3))
        assert eng.state("availability") == "resolved"
        vc.advance(0.1)
        eng.observe(_view(3, 3))
        assert eng.state("availability") == "inactive"

        assert [(o, n) for o, n, _i in seen] == [
            ("inactive", "pending"), ("pending", "firing"),
            ("firing", "resolved")]
        # listener info is the alert snapshot taken under the lock
        assert seen[1][2]["state"] == "firing"
        assert seen[1][2]["burn_fast"] >= slo.burn_threshold

    def test_pending_clears_without_firing(self):
        vc = VirtualClock()
        slo = _availability_slo(for_s=10.0, fast_window_s=0.5,
                                slow_window_s=0.5)
        eng = telemetry.SLOEngine([slo], clock=vc.monotonic)
        eng.observe(_view(0, 2))
        assert eng.state("availability") == "pending"
        vc.advance(1.0)                     # bad sample leaves the window
        eng.observe(_view(2, 2))
        assert eng.state("availability") == "inactive"

    def test_alerts_shape_and_burn_gauge(self):
        vc = VirtualClock()
        eng = telemetry.SLOEngine([_availability_slo(for_s=0.0)],
                                  clock=vc.monotonic)
        alerts = eng.observe(_view(0, 2))
        (a,) = alerts
        assert a["slo"] == "availability" and a["state"] == "firing"
        assert a["burn_fast"] >= 10.0 and a["burn_slow"] >= 10.0
        snap = telemetry.export_snapshot(include_spans=False)
        assert snap["gauges"]["slo.burn_rate.availability"] > 0


# ---------------------------------------------------------------------------
# capacity model (pure math on dict fixtures)
# ---------------------------------------------------------------------------

def _fill_merged(p50_hi=True):
    # fill ladder slice where p50 lands at 0.925 (hi) or 0.075 (lo)
    edges = [[0.15, 0 if p50_hi else 10], [0.85, 0 if p50_hi else 10],
             [1.0, 10], ["+Inf", 10]]
    return {"gauges": {}, "histograms": {
        "serving.batch.fill": {"count": 10, "sum": 9.0 if p50_hi else 0.7,
                               "buckets": edges}}}


class TestCapacityModel:
    def test_availability_burn_restores_registered_strength(self):
        m = CapacityModel(min_replicas=1, max_replicas=8)
        rec = m.recommend({"gauges": {}, "histograms": {}},
                          [{"slo": "availability", "state": "firing",
                            "burn_fast": 50.0}],
                          n_routable=1, n_registered=3)
        assert rec["target"] == 3
        assert any("replace dead" in r for r in rec["reasons"])

    def test_latency_burn_adds_capacity(self):
        m = CapacityModel(min_replicas=1, max_replicas=8)
        rec = m.recommend({"gauges": {}, "histograms": {}},
                          [{"slo": "latency_p99", "state": "pending",
                            "burn_fast": 20.0}],
                          n_routable=2, n_registered=2)
        assert rec["target"] == 3

    def test_queue_depth_sets_demand_floor(self):
        m = CapacityModel(target_queue_per_replica=8.0, max_replicas=8)
        merged = {"gauges": {"serving.queue.depth":
                             {"r1": 20.0, "r2": 12.0, "gateway": 99.0}},
                  "histograms": {}}
        rec = m.recommend(merged, [], n_routable=2, n_registered=2)
        # gateway's gauge is excluded; ceil(32/8) = 4
        assert rec["target"] == 4

    def test_fill_pressure_and_idle_scale_down(self):
        m = CapacityModel(min_replicas=1, max_replicas=8)
        rec = m.recommend(_fill_merged(p50_hi=True), [],
                          n_routable=2, n_registered=2)
        assert rec["target"] == 3
        rec = m.recommend(_fill_merged(p50_hi=False), [],
                          n_routable=3, n_registered=3)
        assert rec["target"] == 2          # one step down, never more
        rec = m.recommend(_fill_merged(p50_hi=False), [],
                          n_routable=1, n_registered=1)
        assert rec["target"] == 1          # min clamp

    def test_max_clamp(self):
        m = CapacityModel(target_queue_per_replica=1.0, max_replicas=4)
        merged = {"gauges": {"serving.queue.depth": {"r1": 100.0}},
                  "histograms": {}}
        rec = m.recommend(merged, [], n_routable=2, n_registered=2)
        assert rec["target"] == 4


# ---------------------------------------------------------------------------
# autoscale controller: hysteresis, cooldown, dead-GC, scale-down
# ---------------------------------------------------------------------------

class TestAutoscaleController:
    def test_hysteresis_and_cooldown_gate_actions(self):
        vc = VirtualClock(start=100.0)
        gw = FleetGateway(name=_gw_name("as-hyst"), probe_interval_s=60.0)
        provisions = []

        class _Up(CapacityModel):
            def recommend(self, merged, alerts, n_routable, n_registered):
                return {"target": n_routable + 2, "routable": n_routable,
                        "registered": n_registered, "reasons": ["stub"],
                        "inputs": {}}

        ctl = AutoscaleController(
            gw, provisioner=lambda n: provisions.append(n) or n,
            model=_Up(), cooldown_s=10.0, hysteresis=2,
            clock=vc.monotonic)
        try:
            assert ctl.evaluate_once()["action"] == "none"  # 1 vote < hyst
            assert ctl.evaluate_once()["action"] == "up+2"
            assert provisions == [2]
            # agreement continues but the cooldown gates the next act
            # (these cooled votes refill the hysteresis window)
            assert ctl.evaluate_once()["action"] == "none"
            assert ctl.evaluate_once()["action"] == "none"
            vc.advance(11.0)
            assert ctl.evaluate_once()["action"] == "up+2"
            assert provisions == [2, 2]
            assert gw.describe()["autoscale"]["hysteresis"] == 2
        finally:
            gw._httpd.server_close()        # never start()ed

    def test_dead_replica_gc_shrinks_registered_set(self):
        vc = VirtualClock(start=5.0)
        gw = FleetGateway(name=_gw_name("as-gc"), probe_interval_s=60.0)
        rep = gw.add_replica(ServiceInfo(name="dead", host="127.0.0.1",
                                         port=1, path="/"))
        rep.healthy = False                 # prober would have marked it
        ctl = AutoscaleController(gw, cooldown_s=1e9, hysteresis=99,
                                  dead_grace_s=0.5, clock=vc.monotonic)
        try:
            rec = ctl.evaluate_once()
            assert rec["gc_removed"] == [] and len(gw.replicas()) == 1
            vc.advance(0.6)                 # grace elapses
            rec = ctl.evaluate_once()
            assert rec["gc_removed"] == [rep.key]
            assert gw.replicas() == []
        finally:
            gw._httpd.server_close()        # never start()ed

    def test_scale_down_drains_least_loaded(self):
        servers = [_mk_server() for _ in range(2)]
        gw = FleetGateway(name=_gw_name("as-down"), probe_interval_s=60.0)
        try:
            for s in servers:
                s.start()
                gw.add_server(s, version="v1")

            class _Down(CapacityModel):
                def recommend(self, merged, alerts, n_routable,
                              n_registered):
                    return {"target": n_routable - 1,
                            "routable": n_routable,
                            "registered": n_registered,
                            "reasons": ["stub"], "inputs": {}}

            c0 = _counter("autoscale.down")
            ctl = AutoscaleController(gw, model=_Down(min_replicas=1),
                                      cooldown_s=0.0, hysteresis=1,
                                      drain_timeout_s=5.0)
            rec = ctl.evaluate_once()
            assert rec["action"] == "down-1"
            assert len(gw.replicas()) == 1
            assert _counter("autoscale.down") == c0 + 1
            # the floor holds: a second step-down recommendation at
            # min_replicas is refused, not half-applied
            rec = ctl.evaluate_once()
            assert rec["action"] == "down_failed"
            assert len(gw.replicas()) == 1
        finally:
            gw._httpd.server_close()        # never start()ed
            for s in servers:
                try:
                    s.stop(drain=False)
                except Exception:
                    pass


# ---------------------------------------------------------------------------
# registry-TTL regression: a pull failure ejects the replica NOW
# ---------------------------------------------------------------------------

class TestPullFailureEjects:
    def test_dead_between_probes_replica_unroutable_after_pull(self):
        servers = [_mk_server() for _ in range(2)]
        gw = FleetGateway(name=_gw_name("ttl-reg"), probe_interval_s=60.0)
        try:
            for s in servers:
                s.start()
                gw.add_server(s, version="v1")
            victim = gw.replicas()[0]
            c_eject = _counter("serving.fleet.eject")
            c_fail = _counter("fleet.pull_failed")
            # hard-kill between probe ticks: with the prober 60 s away,
            # nothing else notices — the federated pull must
            victim.server.stop(drain=False)
            assert victim.routable()        # the stale-registry hole
            merged = gw.telemetry_plane.pull_once()
            assert not victim.routable()
            assert not victim.healthy
            assert merged["meta"]["failed"] == [victim.key]
            assert _counter("serving.fleet.eject") == c_eject + 1
            assert _counter("fleet.pull_failed") == c_fail + 1
            assert _counter(f"fleet.pull_failed.{victim.key}") >= 1
            # the survivor still contributes a source
            assert len(merged["meta"]["sources"]) == 2  # gateway + 1
        finally:
            gw._httpd.server_close()        # never start()ed
            for s in servers:
                try:
                    s.stop(drain=False)
                except Exception:
                    pass

    def test_scrape_never_holds_the_routing_lock(self):
        srv = _mk_server()
        gw = FleetGateway(name=_gw_name("scrape-lock"),
                          probe_interval_s=60.0)
        plane = gw.telemetry_plane
        inner = plane._get_json
        release = threading.Event()
        try:
            srv.start()
            gw.add_server(srv, version="v1")
            gw.start()

            def slow_get(host, port, path):
                release.wait(timeout=5.0)
                return inner(host, port, path)

            plane._get_json = slow_get
            puller = threading.Thread(target=plane.pull_once, daemon=True)
            puller.start()
            time.sleep(0.05)                # puller is inside the scrape
            t0 = time.perf_counter()
            gw.replicas()                   # routing-lock acquisition
            r = _post(gw.url, {"v": 5})     # a full routed request
            waited = time.perf_counter() - t0
            assert r.status_code == 200 and r.json() == {"y": 15}
            assert waited < 2.0, \
                f"routing stalled {waited:.2f}s behind a slow scrape"
            release.set()
            puller.join(timeout=10.0)
            assert not puller.is_alive()
        finally:
            release.set()
            plane._get_json = inner
            gw.stop()
            try:
                srv.stop(drain=False)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# flight recorder + report renderers
# ---------------------------------------------------------------------------

class TestFlightRecorder:
    def test_bundle_contents_and_prune(self, tmp_path):
        rec = telemetry.FlightRecorder(str(tmp_path), max_bundles=2)
        c0 = _counter("fleet.incident")
        merged = telemetry.merge_snapshots(
            {"gateway": telemetry.export_snapshot(include_spans=False)})
        for i in range(3):
            rec.dump(f"slo availability #{i}", merged=merged,
                     alerts=[{"slo": "availability", "state": "firing"}])
        bundles = rec.bundles()
        assert len(bundles) == 2            # oldest pruned
        assert _counter("fleet.incident") == c0 + 3
        manifest = json.loads(
            (Path(bundles[-1]) / "MANIFEST.json").read_text())
        assert manifest["reason"] == "slo availability #2"
        assert manifest["files"] == ["alerts.json", "snapshot.json"]
        snap = json.loads((Path(bundles[-1]) / "snapshot.json").read_text())
        assert snap["meta"]["replica_count"] == 1
        # no half-written .tmp-* turds left behind
        assert not [d for d in os.listdir(tmp_path / "incidents")
                    if d.startswith(".")]


# ---------------------------------------------------------------------------
# the real thing: subprocess replicas behind a live gateway
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worker_pool(tmp_path_factory):
    """Three subprocess replicas — each its own registry + span store."""
    logdir = tmp_path_factory.mktemp("workers")
    env = dict(os.environ)
    procs, infos, logs = [], [], []
    for i in range(3):
        log = open(logdir / f"worker{i}.err", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=log, env=env, text=True))
    for i, p in enumerate(procs):
        line = p.stdout.readline()
        if not line:
            logs[i].seek(0)
            raise RuntimeError(
                f"fleet worker {i} died at startup:\n{logs[i].read()}")
        info = json.loads(line)
        # a port worker runs with jax, flax and the JAX package refused
        assert info.pop("blocked_loaded") == [], info
        infos.append(info)
    try:
        yield infos
    finally:
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
        for log in logs:
            log.close()


@pytest.fixture
def fleet_gw(worker_pool):
    gw = FleetGateway(name=_gw_name("fedobs"), probe_interval_s=5.0,
                      retries=3)
    for info in worker_pool:
        gw.add_replica(ServiceInfo(name=info["name"], host=info["host"],
                                   port=info["port"], path=info["path"]))
    gw.start()
    try:
        yield gw
    finally:
        gw.stop()


def _wave(gw, ids, headers_for=None, concurrency=8):
    results = {}
    lock = threading.Lock()
    sem = threading.BoundedSemaphore(concurrency)

    def run(i):
        try:
            hdrs = headers_for(i) if headers_for else None
            r = _post(gw.url, {"v": i}, headers=hdrs)
            with lock:
                results[i] = (r.status_code, r.json())
        finally:
            sem.release()

    threads = []
    for i in ids:
        sem.acquire()
        t = threading.Thread(target=run, args=(i,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=30.0)
    return results


class TestFederatedFleet:
    def test_fleet_metrics_merge_is_exact_across_processes(self, fleet_gw):
        results = _wave(fleet_gw, range(12))
        assert all(results[i] == (200, {"y": 3 * i}) for i in range(12))
        r = _get(f"{fleet_gw.url.rsplit('/', 1)[0]}/fleet/metrics.json")
        assert r.status_code == 200
        merged = r.json()
        # gateway + 3 subprocess replicas, each a DISTINCT registry
        assert merged["meta"]["replica_count"] == 4
        assert merged["meta"]["failed"] == []
        by_hist = merged["histograms_by_replica"]
        for hkey, snap in merged["histograms"].items():
            parts = [by_hist[rk][hkey] for rk in by_hist
                     if hkey in by_hist[rk]]
            assert snap["count"] == sum(p["count"] for p in parts), hkey
            assert snap["sum"] == pytest.approx(
                sum(p["sum"] for p in parts)), hkey
            for i, (_le, cum) in enumerate(snap["buckets"]):
                assert cum == sum(int(p["buckets"][i][1])
                                  for p in parts), hkey
        by_ctr = merged["counters_by_replica"]
        for name, total in merged["counters"].items():
            assert total == sum(c.get(name, 0) for c in by_ctr.values()), \
                name
        # the 12 requests landed across the worker processes, summed
        # exactly into the fleet series (workers are fresh registries)
        worker_keys = [k for k in by_hist if k != "gateway"]
        assert len(worker_keys) == 3
        served = sum(
            snap["count"]
            for rk in worker_keys
            for hk, snap in by_hist[rk].items()
            if tfleet.parse_hist_key(hk)[0] == "serving.request.latency")
        assert served >= 12

        # Prometheus rendering of the same view: per-replica labels
        # plus the unlabeled exact aggregate
        rp = _get(f"{fleet_gw.url.rsplit('/', 1)[0]}/fleet/metrics")
        assert rp.status_code == 200
        text = rp.entity.decode("utf-8") if isinstance(rp.entity, bytes) \
            else rp.entity
        assert 'replica="gateway"' in text
        assert "# TYPE serving_request_latency histogram" in text

    def test_trace_stitching_under_concurrent_traffic(self, fleet_gw):
        tids = {i: f"obs-{uuid.uuid4().hex}" for i in range(12)}
        results = _wave(fleet_gw, range(12),
                        headers_for=lambda i: {"X-Trace-Id": tids[i]})
        assert all(results[i][0] == 200 for i in range(12))
        base = fleet_gw.url.rsplit("/", 1)[0]
        replica_sources = set()
        for i, tid in tids.items():
            r = _get(f"{base}/trace/{tid}")
            assert r.status_code == 200
            stitched = r.json()
            assert stitched["trace_id"] == tid
            assert all(s["trace_id"] == tid for s in stitched["spans"])
            # one tree per client request: the gateway hop roots it,
            # the replica-process hop nests under it
            assert len(stitched["tree"]) == 1
            root = stitched["tree"][0]
            assert root["source"] == "gateway"
            assert root["name"] == "serving.fleet.request"

            def sources(node):
                yield node["source"]
                for c in node["children"]:
                    yield from sources(c)

            srcs = set(sources(root))
            assert len(srcs) >= 2, f"trace {tid} never left the gateway"
            replica_sources |= (srcs - {"gateway"})
        # concurrent traffic spread across the pool: spans stitched
        # from >= 2 distinct replica processes (3 stores incl. gateway)
        assert len(replica_sources) >= 2

    def test_fleet_alerts_endpoint_reports_slo_states(self, fleet_gw):
        _wave(fleet_gw, range(4))
        r = _get(f"{fleet_gw.url.rsplit('/', 1)[0]}/fleet/alerts")
        assert r.status_code == 200
        alerts = {a["slo"]: a for a in r.json()["alerts"]}
        assert set(alerts) == {"availability", "latency_p99",
                               "deadline_miss"}
        for a in alerts.values():
            assert a["state"] in ("inactive", "pending", "firing",
                                  "resolved")
            assert "burn_fast" in a and "burn_slow" in a
        # an all-healthy pool burns no availability budget
        assert alerts["availability"]["state"] == "inactive"


# ---------------------------------------------------------------------------
# the pure functions, held against the JAX package on the same inputs
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402


def _jax_side():
    from mmlspark_tpu.core import telemetry as jtel
    from mmlspark_tpu.core.telemetry import fleet as jfleet
    from mmlspark_tpu.core.telemetry.metrics import Histogram as JHistogram

    return jtel, jfleet, JHistogram


def _snap(H, vals, ladder):
    h = H("h", ladder)
    for v in vals:
        h.observe(float(v))
    return _json_roundtrip(h.snapshot())


_KEYS = ["gateway", "10.0.0.1:8001", "10.0.0.2:8002", "10.0.0.3:8003"]


def _sources(H, seed=7):
    """Four processes' `export_snapshot()`-shaped dicts from one seed:
    counters, gauges, labeled latency histograms, a fill histogram, and
    goodput / time-series blocks on the replicas."""
    rng = np.random.default_rng(seed)
    fill = BUCKET_FAMILIES["fill"]
    out = {}
    for r, key in enumerate(_KEYS):
        lat = 10.0 ** rng.uniform(-5.0, 0.7, size=20 + 3 * r)
        lat2 = 10.0 ** rng.uniform(-4.0, -0.5, size=9 + r)
        src = {
            "meta": {"pid": 100 + r, "timestamp": None},
            "counters": {
                "serving.requests": int(rng.integers(0, 50)),
                "serving.fleet.deadline_expired": int(rng.integers(0, 3)),
                f"only.{r}": r,
            },
            "gauges": {
                "serving.queue.depth": float(rng.integers(0, 20)),
                "serving.fleet.healthy": float(rng.integers(1, 4)),
                "serving.fleet.replicas": 3.0,
            },
            "histograms": {
                'serving.fleet.request.latency{version="v1"}':
                    _snap(H, lat, LATENCY),
                'serving.request.latency{endpoint="/",outcome="ok"}':
                    _snap(H, lat2, LATENCY),
                "serving.batch.fill": _snap(H, rng.uniform(0, 1, 10), fill),
            },
        }
        if key != "gateway":
            src["timeseries"] = {"cadence_s": 1.0, "series": {
                "serving.requests": {"kind": "counter", "points": [
                    [float(t) + 0.1 * r, float(t * (r + 1))]
                    for t in range(4)]},
                "serving.queue.depth": {"kind": "gauge", "points": [
                    [0.5, float(r)]]}}}
            walls = rng.uniform(0.1, 0.2, size=5) * (4.0 if r == 3 else 1.0)
            src["goodput"] = {
                "summary": {"productive_s": float(walls.sum()),
                            "wall_s": float(walls.sum()) + 0.5,
                            "lost": {"compile": 0.25, "checkpoint": 0.25}},
                "steps": [{"step": i, "wall_s": float(w)}
                          for i, w in enumerate(walls)]}
        out[key] = src
    return out


def test_histogram_snapshots_match_the_jax_package():
    _jtel, _jf, JH = _jax_side()
    rng = np.random.default_rng(3)
    for fam, ladder in sorted(BUCKET_FAMILIES.items()):
        vals = (10.0 ** rng.uniform(-7, 4, size=64) if fam != "fill"
                else rng.uniform(0, 1.2, size=64))
        vals = np.concatenate([vals, ladder[:3]])   # values ON an edge
        assert _snap(Histogram, vals, ladder) == _snap(JH, vals, ladder), fam
    from mmlspark_tpu.core.telemetry import metrics as jm
    from mmlspark_tpu_torch.core.telemetry import metrics as pm
    # the card's own timings (a feed copy, a training step, each between
    # two timing events), which the JAX package does not record
    port_only = {"io.feed.transfer.device_latency",
                 "models.training.step_device_latency"}
    for name in pm.HISTOGRAM_FAMILY:
        if name in port_only:
            assert pm.buckets_for(name) == BUCKET_FAMILIES["latency"], name
            assert pm.is_declared(name) and not jm.is_declared(name), name
            continue
        assert pm.buckets_for(name) == jm.buckets_for(name), name
        assert pm.is_declared(name) and jm.is_declared(name)


def test_merges_and_fleet_prometheus_match_the_jax_package():
    jtel, jfleet, JH = _jax_side()
    srcs = _sources(Histogram)
    assert srcs == _sources(JH)
    versions = {k: ("v2" if k.endswith("3") else "v1") for k in _KEYS[1:]}
    got = telemetry.merge_snapshots(srcs, versions)
    want = jtel.merge_snapshots(srcs, versions)
    assert got == want
    assert set(got) >= {"counters", "gauges", "histograms", "timeseries",
                        "goodput"}
    assert got["goodput"]["straggler"] == want["goodput"]["straggler"]
    assert telemetry.render_fleet_prometheus(got) == \
        jtel.render_fleet_prometheus(want)
    for name in ("serving.fleet.request.latency", "serving.request.latency",
                 "serving.batch.fill", "absent"):
        ht = tfleet.hist_total(got, name)
        assert ht == jfleet.hist_total(want, name), name
        for le in list(LATENCY) + [math.inf, 0.0]:
            assert tfleet.cum_le(ht, le) == jfleet.cum_le(ht, le)
    for key in got["histograms"]:
        assert tfleet.parse_hist_key(key) == jfleet.parse_hist_key(key)
    parts = [s["histograms"]["serving.batch.fill"] for s in srcs.values()]
    assert telemetry.merge_histogram_snapshots(parts, key="f") == \
        jtel.merge_histogram_snapshots(parts, key="f")


def test_federate_host_snapshots_matches_the_jax_package(tmp_path):
    jtel, jfleet, _JH = _jax_side()
    srcs = _sources(Histogram, seed=11)
    paths = {}
    for i, (key, snap) in enumerate(srcs.items()):
        p = tmp_path / f"host{i}.json"
        p.write_text(json.dumps(snap))
        paths[f"host{i}"] = str(p)
    paths["torn"] = str(tmp_path / "torn.json")
    (tmp_path / "torn.json").write_text("{not json")
    paths["gone"] = str(tmp_path / "missing.json")
    got = tfleet.federate_host_snapshots(paths)
    assert got == jfleet.federate_host_snapshots(paths)
    assert got["replicas"]["torn"] == {"unreadable": True}


def test_stitched_spans_match_the_jax_package():
    _jtel, jfleet, _JH = _jax_side()
    rng = np.random.default_rng(5)
    tid = "t-stitch"
    recs = {"gateway": [], "r:1": [], "r:2": []}
    ids = ["g0"]
    recs["gateway"].append({"trace_id": tid, "span_id": "g0",
                            "parent_id": "client", "t_start": 0.0,
                            "name": "serving.fleet.request"})
    for i in range(1, 24):
        src = ("gateway", "r:1", "r:2")[int(rng.integers(0, 3))]
        rec = {"trace_id": tid if i % 7 else "other", "span_id": f"s{i}",
               "parent_id": ids[int(rng.integers(0, len(ids)))],
               "t_start": float(rng.uniform(0, 1)), "name": f"op{i % 4}"}
        recs[src].append(rec)
        recs["r:1" if src != "r:1" else "r:2"].append(dict(rec))  # dup
        ids.append(rec["span_id"])
    got = telemetry.stitch_spans(tid, recs)
    assert got == jfleet.stitch_spans(tid, recs)
    assert len(got["tree"]) == 1 and got["span_count"] > 10


def _fleet_view(H, healthy, total, lat_vals, expired):
    return {"gauges": {"serving.fleet.healthy": {"gateway": float(healthy)},
                       "serving.fleet.replicas": {"gateway": float(total)}},
            "counters": {"serving.fleet.deadline_expired": expired},
            "histograms": {"serving.fleet.request.latency":
                           _snap(H, lat_vals, LATENCY)}}


def _drive_slos(tel, H, VC):
    """The default objectives plus a custom one through one scripted
    timeline of fleet views; every transition and alert list recorded."""
    vc = VC(start=50.0)
    custom = tel.SLO("availability_fast", 0.99,
                     lambda m: (sum(m["gauges"]["serving.fleet.healthy"]
                                    .values()),
                                sum(m["gauges"]["serving.fleet.replicas"]
                                    .values())),
                     kind="instant", fast_window_s=0.5, slow_window_s=2.0,
                     burn_threshold=5.0, for_s=0.3)
    eng = tel.SLOEngine(tel.default_slos(fast_window_s=1.0,
                                         slow_window_s=4.0) + [custom],
                        clock=vc.monotonic)
    seen = []
    eng.on_transition(lambda s, old, new, info:
                      seen.append((s.name, old, new, dict(info))))
    rng = np.random.default_rng(9)
    n_lat, expired, log = 0, 0, []
    for step in range(40):
        bad = 10 <= step < 22
        healthy = 1 if bad else 3
        n_lat += 5
        if bad:
            expired += int(rng.integers(0, 3))
        lat = np.concatenate([
            10.0 ** rng.uniform(-4, -1, size=n_lat),
            np.full(n_lat // (3 if bad else 50), 2.0)])
        alerts = eng.observe(_fleet_view(H, healthy, 3, lat, expired))
        log.append([(a["slo"], a["state"], a["burn_fast"], a["burn_slow"])
                    for a in alerts])
        vc.advance(0.25)
    return seen, log, {s.name: eng.state(s.name) for s in eng.slos}


def test_slo_engine_transitions_match_the_jax_package():
    from mmlspark_tpu.utils.faults import VirtualClock as JVC

    jtel, _jf, JH = _jax_side()
    got = _drive_slos(telemetry, Histogram, VirtualClock)
    want = _drive_slos(jtel, JH, JVC)
    assert got == want
    kinds = {(name, new) for name, _old, new, _i in got[0]}
    # the timeline drives every objective through pending and firing
    for name in ("availability", "availability_fast", "latency_p99"):
        assert (name, "firing") in kinds, kinds


def _capacity_cases(H):
    rng = np.random.default_rng(21)
    fill_hi = {"serving.batch.fill": _snap(H, rng.uniform(0.9, 1.0, 20),
                                           BUCKET_FAMILIES["fill"])}
    fill_lo = {"serving.batcher.batch_fill": _snap(
        H, rng.uniform(0.0, 0.2, 20), BUCKET_FAMILIES["fill"])}
    q = {"serving.queue.depth": {"r1": 20.0, "r2": 12.0, "gateway": 99.0},
         "serving.batcher.queue_depth": {"r1": 3.0}}
    hbm = {"device.hbm.bytes_in_use": {"r1": 7.6e10, "gateway": 8e10}}
    firing = [{"slo": "availability", "state": "firing", "burn_fast": 50.0},
              {"slo": "latency_p99", "state": "pending", "burn_fast": 20.0}]
    lat_only = [{"slo": "latency_p99", "state": "pending",
                 "burn_fast": 20.0},
                {"slo": "deadline_miss", "state": "resolved",
                 "burn_fast": 1.0}]
    merged = [{"gauges": {}, "histograms": {}},
              {"gauges": q, "histograms": {}},
              {"gauges": {}, "histograms": fill_hi},
              {"gauges": {}, "histograms": fill_lo},
              {"gauges": hbm, "histograms": fill_lo},
              {"gauges": q, "histograms": fill_hi}]
    models = [dict(), dict(min_replicas=2, max_replicas=4),
              dict(target_queue_per_replica=2.0, hbm_limit_bytes=8e10)]
    for m in models:
        for view in merged:
            for alerts in ([], firing, lat_only):
                for routable, registered in ((1, 3), (2, 2), (4, 4)):
                    yield m, view, alerts, routable, registered


def test_capacity_model_matches_the_jax_package():
    from mmlspark_tpu.serving.autoscale import CapacityModel as JModel

    _jtel, _jf, JH = _jax_side()
    n = 0
    for (m, view, alerts, ro, reg), (_m, jview, _a, _r, _g) in zip(
            _capacity_cases(Histogram), _capacity_cases(JH)):
        got = CapacityModel(**m).recommend(view, alerts, ro, reg)
        want = JModel(**m).recommend(jview, alerts, ro, reg)
        assert got == want, (m, alerts, ro, reg)
        n += 1
    assert n == 162


def _drive_autoscale(Gateway, Controller, Model, Info, VC, tag):
    """One scripted control run: three registered replicas (never
    contacted — the scrape is stubbed), scripted health flips and
    scripted recommendations, under a VirtualClock."""
    vc = VC(start=10.0)
    gw = Gateway(name=_gw_name(tag), probe_interval_s=60.0)
    reps = [gw.add_replica(Info(name="x", host="127.0.0.1", port=p,
                                path="/")) for p in (1, 2, 3)]
    gw.telemetry_plane._get_json = lambda host, port, path: {
        "counters": {}, "gauges": {}, "histograms": {}}
    deltas = iter([+1, +1, +1, 0, -1, -1, +2, +2, +2, -1, -1, -1, 0])

    class Scripted(Model):
        def recommend(self, merged, alerts, n_routable, n_registered):
            return {"target": n_routable + next(deltas),
                    "routable": n_routable, "registered": n_registered,
                    "reasons": ["scripted"], "inputs": {}}

    provisions = []
    ctl = Controller(gw, provisioner=lambda n: provisions.append(n) or n,
                     model=Scripted(min_replicas=1, max_replicas=8),
                     cooldown_s=1.0, hysteresis=2, drain_timeout_s=0.0,
                     dead_grace_s=0.6, clock=vc.monotonic)
    out = []
    try:
        for step in range(13):
            if step == 3:
                reps[2].healthy = False       # dies; GC'd after the grace
            out.append({k: v for k, v in ctl.evaluate_once().items()
                        if k in ("target", "routable", "registered",
                                 "action", "t")})
            out[-1]["gc"] = [k.rsplit(":", 1)[1]
                             for k in ctl.last["gc_removed"]]
            vc.advance(0.4)
        return out, provisions, sorted(r.info.port for r in gw.replicas())
    finally:
        gw._httpd.server_close()        # never start()ed


def test_autoscale_decisions_match_the_jax_package():
    from mmlspark_tpu.serving import FleetGateway as JGateway
    from mmlspark_tpu.serving import ServiceInfo as JInfo
    from mmlspark_tpu.serving.autoscale import \
        AutoscaleController as JController
    from mmlspark_tpu.serving.autoscale import CapacityModel as JModel
    from mmlspark_tpu.utils.faults import VirtualClock as JVC

    got = _drive_autoscale(FleetGateway, AutoscaleController, CapacityModel,
                           ServiceInfo, VirtualClock, "as-port")
    want = _drive_autoscale(JGateway, JController, JModel, JInfo, JVC,
                            "as-jax")
    assert got == want
    actions = {r["action"] for r in got[0]}
    assert {"none", "down-1"} <= actions and any(
        a.startswith("up+") for a in actions), actions
    assert any(r["gc"] for r in got[0])


def test_rollout_band_rule_matches_the_jax_gate():
    """The rollout's inline band rule gives the JAX package's
    `tools/perf_gate.compare` rows on the rollout band table."""
    import sys as _sys

    _sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from tools.perf_gate import compare

    from mmlspark_tpu_torch.serving import ROLLOUT_METRICS
    from mmlspark_tpu_torch.serving.rollout import _band_compare

    rng = np.random.default_rng(13)
    for _ in range(200):
        base = {k: float(rng.uniform(0, 0.2)) for k in ROLLOUT_METRICS}
        fresh = {k: float(v * rng.uniform(0.3, 2.5) + rng.uniform(0, 0.02))
                 for k, v in base.items()}
        if rng.uniform() < 0.2:
            base["error_rate"] = 0.0
        if rng.uniform() < 0.1:
            fresh.pop("latency_p95")
        if rng.uniform() < 0.1:
            base["latency_p50"] = True          # not a number: skipped
        assert _band_compare(fresh, base, ROLLOUT_METRICS) == \
            compare(fresh, base, metrics=ROLLOUT_METRICS)[0]


def test_flight_recorder_bundle_matches_the_jax_package(tmp_path):
    jtel, _jf, JH = _jax_side()
    srcs = _sources(Histogram, seed=17)
    alerts = [{"slo": "availability", "state": "firing", "burn_fast": 42.0}]
    bundles = []
    for tel, sub in ((telemetry, "port"), (jtel, "jax")):
        rec = tel.FlightRecorder(str(tmp_path / sub), max_bundles=2)
        merged = tel.merge_snapshots(srcs)
        bundle = None
        for i in range(3):
            bundle = rec.dump(f"slo availability #{i}", merged=merged,
                              alerts=alerts,
                              traces={"t1": {"spans": [], "tree": []}})
        assert len(rec.bundles()) == 2
        files = {}
        for name in sorted(os.listdir(bundle)):
            doc = json.loads((Path(bundle) / name).read_text())
            if name == "MANIFEST.json":
                doc.pop("created_unix", None)
                doc.pop("ts", None)
            files[name] = doc
        bundles.append((os.path.basename(bundle).split("-", 1)[1], files))
    assert bundles[0] == bundles[1]


def test_fleet_goodput_federates_the_ledger_export():
    """`export_snapshot()` carries the goodput ledger's export once the
    process recorded a step, and the gateway's `/fleet/goodput` folds it
    from every source (here the gateway and one in-process replica, which
    share the ledger)."""
    srv = _mk_server()
    gw = FleetGateway(name=_gw_name("goodput"), probe_interval_s=60.0)
    try:
        telemetry.LEDGER.reset(host_id="h0")
        assert "goodput" not in telemetry.export_snapshot(include_spans=False)
        telemetry.LEDGER.record_step(0, 0.25)
        telemetry.LEDGER.record_step(1, 0.25, checkpoint=0.125)
        snap = telemetry.export_snapshot(include_spans=False)
        assert snap["goodput"]["summary"]["productive_s"] == \
            pytest.approx(0.5)
        srv.start()
        gw.add_server(srv, version="v1")
        gw.start()
        doc = _get(f"{gw.url.rsplit('/', 1)[0]}/fleet/goodput").json()
        assert len(doc["hosts"]) == 2
        assert doc["fleet"]["productive_s"] == pytest.approx(1.0)
        assert doc["fleet"]["lost"] == {"checkpoint": pytest.approx(0.25)}
    finally:
        telemetry.LEDGER.reset()
        gw.stop()
        srv.stop(drain=False)
