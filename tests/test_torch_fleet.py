"""The port's fleet control plane on the CPU: registry hygiene, gateway
routing / deadline / retry, breaker ejection and probe reinstatement,
drain under concurrent load, metrics-gated canary rollouts — the
scenarios of the JAX suite's tests/test_fleet.py (all but its two chaos
soaks) over `mmlspark_tpu_torch` — then the multi-replica serving forms
(`distributed_server`, `DistributedServingServer`), routing across the
two packages (a JAX gateway over port replicas and a port gateway over
JAX replicas, through each other's registries), and a two-replica LM
fleet whose streams through the gateway equal the JAX package's
`generate`.

Everything runs against real sockets on loopback; only the "dead
replica" (a bound-then-closed port) and the header-capturing stub are
synthetic.
"""
import functools
import gc
import http.client
import json
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.core.pipeline import LambdaTransformer
from mmlspark_tpu_torch.io.http.clients import send_request
from mmlspark_tpu_torch.io.http.schema import HTTPRequestData, to_http_request
from mmlspark_tpu_torch.serving import (
    DistributedServingServer,
    FleetGateway,
    RolloutController,
    ServiceInfo,
    ServiceRegistry,
    ServingServer,
    deregister_service,
    list_services,
    read_stream,
    register_service,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _frozen_imports():
    """Move the objects alive at this module's start (torch, JAX and both
    packages: some 180k) out of the collector's reach.  A full collection
    over them takes 80-100 ms on a CPU, about ten times one in the JAX
    suite's process, and one that lands on a canary request is that
    version's p95 over a dozen samples: it alone would decide a rollout
    that the reference's own margins judge."""
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()


def _counter(name):
    return telemetry.counters().get(name, 0)


def _gw_name(tag):
    # breaker registry keys are process-global and config applies on
    # first construction: a unique gateway name per test isolates them
    return f"{tag}-{uuid.uuid4().hex[:8]}"


def _mk_server(slow=0.0, **kw):
    def fn(table):
        if slow:
            time.sleep(slow)
        v = np.asarray(table["x"], np.int64)
        return table.with_column("y", v * 2)

    kw.setdefault("max_batch", 4)
    kw.setdefault("batch_timeout_ms", 5.0)
    return ServingServer(LambdaTransformer(fn), reply_col="y",
                         name="fleet-test", input_schema=["x"], **kw)


def _post(url, payload, headers=None, timeout=10.0):
    return send_request(to_http_request(url, payload, headers=headers),
                        timeout=timeout)


def _get(url, timeout=5.0):
    return send_request(HTTPRequestData(url=url, method="GET"),
                        timeout=timeout)


def _dead_address():
    """A (host, port) with no listener: bound, learned, closed."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    host, port = s.getsockname()
    s.close()
    return host, port


class _StubReplica:
    """Raw HTTP replica capturing forwarded headers; answers 200 JSON
    and /health, so gateway-side behavior (deadline decrement, trace
    injection) is observable without a model in the loop."""

    def __init__(self):
        self.seen = []
        outer = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) if n else b"{}"
                outer.seen.append(dict(self.headers.items()))
                out = json.dumps({"echo": json.loads(body or b"{}")
                                  }).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def do_GET(self):
                out = b'{"status": "ok", "draining": false}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True, name="fleet-stub")

    @property
    def info(self):
        h, p = self.httpd.server_address[:2]
        return ServiceInfo("fleet-test", h, p, "/")

    def start(self):
        self.thread.start()
        return self.info

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


# ------------------------------------------------------ ServiceRegistry

def test_registry_reregistration_is_heartbeat_not_duplicate():
    reg = ServiceRegistry()
    url = reg.start()
    try:
        info = ServiceInfo("svc", "127.0.0.1", 9001, "/p")
        for _ in range(3):
            assert register_service(url, info)
        listed = list_services(url, "svc")
        assert len(listed) == 1, f"re-registration duplicated: {listed}"
        # distinct port = distinct replica = second entry
        assert register_service(
            url, ServiceInfo("svc", "127.0.0.1", 9002, "/p"))
        assert len(list_services(url, "svc")) == 2
    finally:
        reg.stop()


def test_registry_ttl_expires_dead_workers_on_read():
    clock = {"t": 100.0}
    reg = ServiceRegistry(ttl_s=5.0, clock=lambda: clock["t"])
    url = reg.start()
    try:
        register_service(url, ServiceInfo("svc", "127.0.0.1", 9001, "/"))
        assert len(list_services(url, "svc")) == 1
        clock["t"] += 4.0  # inside TTL: still discoverable
        assert len(list_services(url, "svc")) == 1
        register_service(  # heartbeat refreshes last_seen
            url, ServiceInfo("svc", "127.0.0.1", 9001, "/"))
        clock["t"] += 4.0
        assert len(list_services(url, "svc")) == 1
        clock["t"] += 10.0  # silent past TTL: expired on read
        assert list_services(url, "svc") == []
    finally:
        reg.stop()


def test_registry_deregister_removes_immediately():
    reg = ServiceRegistry()
    url = reg.start()
    try:
        info = ServiceInfo("svc", "127.0.0.1", 9001, "/")
        register_service(url, info)
        assert len(list_services(url, "svc")) == 1
        assert deregister_service(url, info)
        assert list_services(url, "svc") == []
        # malformed payloads are a 400, not a registry mutation
        r = send_request(HTTPRequestData(
            url=url + "/register", entity=b'{"nope": 1}'), timeout=5.0)
        assert r.status_code == 400
    finally:
        reg.stop()


# ------------------------------------------------------ gateway routing

def test_gateway_p2c_spreads_load_and_discovers_via_registry():
    reg = ServiceRegistry()
    reg_url = reg.start()
    servers = [_mk_server(), _mk_server()]
    gw = None
    try:
        for s in servers:
            info = s.start()
            info.name = "p2c"
            register_service(reg_url, info)
        gw = FleetGateway(name="p2c", registry_url=reg_url,
                          probe_interval_s=0.2)
        gw.start()  # discovers both replicas via sync_registry
        assert len(gw.replicas()) == 2
        for i in range(40):
            r = _post(gw.url, {"x": i})
            assert r.ok and r.json() == {"y": 2 * i}
        loads = sorted(rep.forwarded for rep in gw.replicas())
        # p2c on in-flight counts: both replicas take real traffic
        assert loads[0] > 0, f"one replica starved: {loads}"
    finally:
        if gw is not None:
            gw.stop()
        for s in servers:
            s.stop()
        reg.stop()


def test_gateway_decrements_deadline_before_forwarding():
    stub = _StubReplica()
    stub.start()
    gw = FleetGateway(name=_gw_name("ddl"), probe_interval_s=5.0)
    gw.add_replica(stub.info)
    gw.start()
    try:
        r = _post(gw.url, {"x": 1}, headers={"X-Deadline-Ms": "5000"})
        assert r.ok
        fwd = stub.seen[-1]
        got = float(fwd["X-Deadline-Ms"])
        # decremented by gateway-observed elapsed, never inflated
        assert 0 < got < 5000.0, f"budget not decremented: {got}"
        # trace headers are gateway-issued, not client passthrough
        assert "X-Trace-Id" in fwd and "X-Span-Id" in fwd
    finally:
        gw.stop()
        stub.stop()


def test_gateway_expired_deadline_504_without_forwarding():
    stub = _StubReplica()
    stub.start()
    gw = FleetGateway(name=_gw_name("exp"), probe_interval_s=5.0)
    gw.add_replica(stub.info)
    gw.start()
    try:
        before = _counter("serving.fleet.deadline_expired")
        r = _post(gw.url, {"x": 1}, headers={"X-Deadline-Ms": "0"})
        assert r.status_code == 504
        assert stub.seen == [], "expired request must never be forwarded"
        assert _counter("serving.fleet.deadline_expired") == before + 1
    finally:
        gw.stop()
        stub.stop()


def test_gateway_retries_idempotent_on_alternate_replica():
    stub = _StubReplica()
    stub.start()
    dead = _dead_address()
    gw = FleetGateway(name=_gw_name("rty"), probe_interval_s=30.0,
                      retries=2, breaker_threshold=1)
    gw.add_replica(ServiceInfo("fleet-test", dead[0], dead[1], "/"))
    gw.add_replica(stub.info)
    gw.start()
    try:
        before_retry = _counter("serving.fleet.retry")
        before_eject = _counter("serving.fleet.eject")
        for i in range(8):  # p2c will hit the dead replica eventually
            r = _post(gw.url, {"x": i})
            assert r.ok, (i, r.status_code, r.entity)
        assert _counter("serving.fleet.retry") > before_retry
        # threshold-1 breaker: first refused connection opens the circuit
        assert _counter("serving.fleet.eject") > before_eject
        dead_rep = gw.replicas()[0]
        assert dead_rep.breaker.state == "open"
        assert not dead_rep.routable()
    finally:
        gw.stop()
        stub.stop()


def test_gateway_never_retries_non_idempotent():
    d1, d2 = _dead_address(), _dead_address()
    gw = FleetGateway(name=_gw_name("nidem"), probe_interval_s=30.0,
                      retries=2, breaker_threshold=10)
    gw.add_replica(ServiceInfo("fleet-test", d1[0], d1[1], "/"))
    gw.add_replica(ServiceInfo("fleet-test", d2[0], d2[1], "/"))
    gw.start()
    try:
        before = _counter("serving.fleet.retry")
        r = _post(gw.url, {"x": 1}, headers={"X-Idempotent": "false"})
        assert r.status_code == 502
        assert _counter("serving.fleet.retry") == before, \
            "non-idempotent request was retried"
        r = _post(gw.url, {"x": 1})  # idempotent: alternates get tried
        assert r.status_code in (502, 503)
        assert _counter("serving.fleet.retry") > before
    finally:
        gw.stop()


def test_probe_reinstates_revived_replica():
    dead = _dead_address()
    gw = FleetGateway(name=_gw_name("rei"), probe_interval_s=0.05,
                      retries=1, breaker_threshold=1, breaker_reset_s=0.2)
    rep = gw.add_replica(ServiceInfo("fleet-test", dead[0], dead[1], "/"))
    gw.start()
    try:
        r = _post(gw.url, {"x": 1})  # opens the breaker (refused)
        assert r.status_code in (502, 503)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and rep.routable():
            time.sleep(0.02)
        assert not rep.routable()
        before = _counter("serving.fleet.reinstate")
        # revive a listener at the SAME address; its /health answers
        srv = ThreadingHTTPServer(dead, _health_handler())
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not rep.routable():
                time.sleep(0.02)
            assert rep.routable(), "probe never reinstated the replica"
            assert _counter("serving.fleet.reinstate") > before
        finally:
            srv.shutdown()
            srv.server_close()
    finally:
        gw.stop()


def _health_handler():
    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            out = b'{"status": "ok", "draining": false}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    return H


def test_fleet_forward_fault_point_is_retried():
    from mmlspark_tpu_torch.utils.faults import FAULTS, FaultPlan

    s1, s2 = _mk_server(), _mk_server()
    s1.start(), s2.start()
    gw = FleetGateway(name=_gw_name("flt"), probe_interval_s=30.0,
                      retries=2, breaker_threshold=5)
    gw.add_server(s1), gw.add_server(s2)
    gw.start()
    try:
        before = _counter("serving.fleet.retry")
        plan = FaultPlan(seed=3).on("fleet.forward", nth={0})
        with FAULTS.arm(plan):
            r = _post(gw.url, {"x": 7})
        assert r.ok and r.json() == {"y": 14}
        assert FAULTS.fires.get("fleet.forward", 0) == 1
        assert _counter("serving.fleet.retry") == before + 1
    finally:
        gw.stop()
        s1.stop()
        s2.stop()


# ----------------------------------------------- trace + admin surface

def test_client_trace_id_yields_gateway_span_with_replica_child():
    srv = _mk_server()
    srv.start()
    gw = FleetGateway(name=_gw_name("trc"), probe_interval_s=5.0)
    gw.add_server(srv)
    gw.start()
    try:
        tid = f"trace-{uuid.uuid4().hex[:12]}"
        r = _post(gw.url, {"x": 3},
                  headers={"X-Trace-Id": tid, "X-Span-Id": "client-root"})
        assert r.ok
        gi = gw.service_info
        doc = _get(f"http://{gi.host}:{gi.port}/trace/{tid}").json()
        spans = {s["name"]: s for s in doc["spans"]}
        assert "serving.fleet.request" in spans, doc
        assert "serving.request" in spans, doc
        gw_span = spans["serving.fleet.request"]
        assert gw_span["parent_id"] == "client-root"
        assert spans["serving.request"]["parent_id"] == gw_span["span_id"]
    finally:
        gw.stop()
        srv.stop()


def test_fleet_admin_endpoint_reports_pool_and_rollout():
    s1, s2 = _mk_server(), _mk_server()
    s1.start(), s2.start()
    gw = FleetGateway(name=_gw_name("adm"), probe_interval_s=5.0)
    gw.add_server(s1, version="v1"), gw.add_server(s2, version="v2")
    ctl = RolloutController(gw, canary_weight=0.25, min_requests=5)
    gw.start()
    ctl.begin("v2")
    try:
        for i in range(6):
            assert _post(gw.url, {"x": i}).ok
        gi = gw.service_info
        doc = _get(f"http://{gi.host}:{gi.port}/fleet").json()
        assert len(doc["replicas"]) == 2
        assert doc["version_weights"] == {"v1": 0.75, "v2": 0.25}
        assert set(doc["versions"]) == {"v1", "v2"}
        assert doc["rollout"]["state"] == "canary"
        assert doc["rollout"]["canary_version"] == "v2"
        total = sum(r["forwarded"] for r in doc["replicas"])
        assert total == 6
    finally:
        gw.stop()
        s1.stop()
        s2.stop()


# --------------------------------------- drain under concurrent load

def test_begin_drain_under_concurrent_load():
    srv = _mk_server(slow=0.15, max_batch=2)
    info = srv.start()
    in_flight_results = []
    try:
        barrier = threading.Barrier(4)

        def client(i):
            barrier.wait()
            r = _post(info.url, {"x": i}, timeout=15.0)
            in_flight_results.append((i, r.status_code, r.entity))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        barrier.wait()       # all three are in flight (or queued)
        time.sleep(0.05)
        srv.server.begin_drain()
        assert not srv.server.drained(), \
            "drained() true with requests still in flight"
        # new arrivals during the drain shed with 503 + Retry-After
        shed = _post(info.url, {"x": 99})
        assert shed.status_code == 503
        assert (shed.headers.get("Retry-After")
                or shed.headers.get("retry-after")) is not None
        for t in threads:
            t.join(timeout=15.0)
            assert not t.is_alive()
        # every in-flight request completed with its own payload
        assert sorted(i for i, _, _ in in_flight_results) == [0, 1, 2]
        for i, status, entity in in_flight_results:
            assert status == 200, (i, status, entity)
            assert json.loads(entity) == {"y": 2 * i}
        # ...and drained() flips exactly once the last one finished
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not srv.server.drained():
            time.sleep(0.01)
        assert srv.server.drained()
    finally:
        srv.stop()


# ------------------------------------------------------------- canary

def test_slow_canary_auto_rolls_back():
    import random

    s1 = _mk_server()
    s2 = _mk_server(slow=0.12)  # deliberately slow v2 (band floor is 10ms)
    s1.start(), s2.start()
    gw = FleetGateway(name=_gw_name("can1"), probe_interval_s=0.5,
                      rng=random.Random(3))
    gw.add_server(s1, version="v1")
    gw.add_server(s2, version="v2")
    ctl = RolloutController(gw, canary_weight=0.3, min_requests=5)
    gw.start()
    ctl.begin("v2")
    try:
        before = _counter("serving.fleet.rollback")
        for i in range(30):
            r = _post(gw.url, {"x": i})
            assert r.ok and r.json() == {"y": 2 * i}
        assert ctl.step() == "rolled_back"
        assert ctl.last_verdict == "regressed"
        regressed = {r["metric"] for r in ctl.last_rows if r["regressed"]}
        assert regressed & {"latency_p50", "latency_p95"}, ctl.last_rows
        assert _counter("serving.fleet.rollback") == before + 1
        # canary out of the pool, stopped; baseline serves on
        assert [r.version for r in gw.replicas()] == ["v1"]
        assert not s2._running.is_set()
        assert _post(gw.url, {"x": 5}).ok
    finally:
        gw.stop()
        s1.stop()
        if s2._running.is_set():
            s2.stop()


def test_healthy_canary_auto_promotes_and_drains_old_without_drops():
    import random

    s1, s2 = _mk_server(), _mk_server()
    s1.start(), s2.start()
    gw = FleetGateway(name=_gw_name("can2"), probe_interval_s=0.5,
                      rng=random.Random(4))
    gw.add_server(s1, version="v1")
    gw.add_server(s2, version="v2")
    ctl = RolloutController(gw, canary_weight=0.4, min_requests=5)
    gw.start()
    ctl.begin("v2")
    results = {}
    res_lock = threading.Lock()

    def client(i):
        r = _post(gw.url, {"x": i}, timeout=15.0)
        with res_lock:
            results[i] = (r.status_code, r.entity)

    try:
        before = _counter("serving.fleet.promote")
        for i in range(30):
            client(i)
        # promote WHILE traffic is in the air: the rolling drain must
        # drop none of it
        threads = [threading.Thread(target=client, args=(100 + i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        assert ctl.step() == "promoted"
        for t in threads:
            t.join(timeout=20.0)
            assert not t.is_alive()
        assert ctl.last_verdict == "ok"
        assert _counter("serving.fleet.promote") == before + 1
        bad = {i: v for i, v in results.items() if v[0] != 200}
        assert not bad, f"requests dropped during the roll: {bad}"
        # old version drained out of the pool and stopped
        assert [r.version for r in gw.replicas()] == ["v2"]
        assert not s1._running.is_set()
        assert _post(gw.url, {"x": 5}).json() == {"y": 10}
    finally:
        gw.stop()
        s2.stop()
        if s1._running.is_set():
            s1.stop()


# ------------------------------------------- the multi-replica serving forms

def _x2(table):
    return table.with_column("y", np.asarray(table["x"], np.int64) * 2)


def test_distributed_server_registers_replicas_a_gateway_finds(tmp_path):
    reg = ServiceRegistry()
    url = reg.start()
    query = gw = None
    try:
        query = (read_stream()
                 .distributed_server(name="dist", path="/d", replicas=2,
                                     registry_url=url)
                 .parse_request(schema=["x"])
                 .transform(_x2).make_reply("y")
                 .options(batch_timeout_ms=5.0,
                          journal_path=str(tmp_path / "journal"))
                 .start())
        infos = query.service_infos
        assert len(infos) == 2 and len({i.port for i in infos}) == 2
        # each replica keeps its own journal, and all register under the
        # query's name
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "journal-0", "journal-1"]
        listed = list_services(url, "dist")
        assert sorted(e["port"] for e in listed) == sorted(
            i.port for i in infos)
        gw = FleetGateway(name="dist", registry_url=url,
                          probe_interval_s=5.0)
        gw.start()
        assert len(gw.replicas()) == 2
        for i in range(12):
            r = _post(gw.url, {"x": i})
            assert r.ok and r.json() == {"y": 2 * i}
        assert sum(rep.forwarded for rep in gw.replicas()) == 12
        assert query.stats["requests"] >= 12
    finally:
        if gw is not None:
            gw.stop()
        if query is not None:
            query.stop()
        reg.stop()
    assert not query.is_active()


def test_distributed_server_with_a_fixed_port_and_replicas_raises():
    with pytest.raises(ValueError, match="port=0"):
        read_stream().distributed_server(port=8123, replicas=2)
    # one replica may bind a fixed port
    read_stream().distributed_server(port=8123, replicas=1)


def test_distributed_serving_server_starts_and_answers():
    dss = DistributedServingServer(LambdaTransformer(_x2), reply_col="y",
                                   name="dss", path="/p", replicas=2,
                                   batch_timeout_ms=5.0)
    gw = None
    try:
        infos = dss.start()
        assert len(infos) == 2
        with pytest.raises(RuntimeError, match="already started"):
            dss.start()
        assert len(list_services(dss.registry.url, "dss")) == 2
        gw = FleetGateway(name="dss", registry_url=dss.registry.url,
                          probe_interval_s=5.0)
        gw.start()
        for i in range(6):
            r = _post(gw.url, {"x": i})
            assert r.ok and r.json() == {"y": 2 * i}
        for info in infos:      # and each replica answers on its own
            assert _post(info.url, {"x": 5}).json() == {"y": 10}
    finally:
        if gw is not None:
            gw.stop()
        dss.stop()
    assert dss.query is None


def test_stream_chunks_arrive_incrementally_through_the_gateway():
    """A streamed reply crosses two HTTP hops (replica, then gateway) one
    chunk at a time: the client reads the first chunk while the producer
    is still blocked before the second."""
    got_first = threading.Event()

    def produce(row):
        yield "tok1 "
        assert got_first.wait(10), "client never saw the first chunk"
        yield "tok2 "
        yield "tok3"

    query = (read_stream().distributed_server(name="strm", path="/g",
                                              replicas=2)
             .parse_request(schema=["x"]).stream_reply(produce).start())
    gw = FleetGateway(name=_gw_name("strm"), probe_interval_s=5.0)
    for info in query.service_infos:
        gw.add_replica(info)
    gw.start()
    try:
        gi = gw.service_info
        conn = http.client.HTTPConnection(gi.host, gi.port, timeout=10)
        conn.request("POST", gi.path, body=b'{"x": 1}')
        resp = conn.getresponse()
        assert resp.status == 200
        first = resp.read1(64)
        assert first == b"tok1 "
        got_first.set()
        assert resp.read() == b"tok2 tok3"
        conn.close()
    finally:
        got_first.set()
        gw.stop()
        query.stop()


# --------------------------------------------- routing across the packages

def test_a_jax_gateway_routes_to_port_replicas():
    from mmlspark_tpu.serving import FleetGateway as JGateway
    from mmlspark_tpu.serving import ServiceRegistry as JRegistry

    reg = JRegistry()
    url = reg.start()
    query = gw = None
    try:
        query = (read_stream()
                 .distributed_server(name="xpkg", replicas=2,
                                     registry_url=url)
                 .parse_request(schema=["x"])
                 .transform(_x2).make_reply("y")
                 .options(batch_timeout_ms=5.0).start())
        gw = JGateway(name="xpkg", registry_url=url, probe_interval_s=5.0)
        gw.start()
        assert len(gw.replicas()) == 2
        tid = f"xpkg-{uuid.uuid4().hex[:12]}"
        for i in range(8):
            r = _post(gw.url, {"x": i}, headers={"X-Trace-Id": tid})
            assert r.ok and r.json() == {"y": 2 * i}
        # the JAX gateway's stitched trace holds the port replicas' spans
        gi = gw.service_info
        doc = _get(f"http://{gi.host}:{gi.port}/trace/{tid}").json()
        names = {s["name"] for s in doc["spans"]}
        assert {"serving.fleet.request", "serving.request"} <= names
    finally:
        if gw is not None:
            gw.stop()
        if query is not None:
            query.stop()
        reg.stop()


def test_a_port_gateway_routes_to_jax_replicas():
    from mmlspark_tpu.core.pipeline import LambdaTransformer as JLambda
    from mmlspark_tpu.serving import ServingServer as JServer
    from mmlspark_tpu.serving import list_services as j_list
    from mmlspark_tpu.serving import register_service as j_register

    reg = ServiceRegistry()
    url = reg.start()
    servers = [JServer(JLambda(_x2), reply_col="y", name="jrep",
                       input_schema=["x"], max_batch=4,
                       batch_timeout_ms=5.0) for _ in range(2)]
    gw = None
    try:
        for s in servers:
            info = s.start()
            info.name = "jrep"
            assert j_register(url, info)
        # the two packages read one registry's JSON the same way
        assert j_list(url, "jrep") == list_services(url, "jrep")
        gw = FleetGateway(name="jrep", registry_url=url,
                          probe_interval_s=0.2)
        gw.start()
        assert len(gw.replicas()) == 2
        for i in range(8):
            r = _post(gw.url, {"x": i}, headers={"X-Deadline-Ms": "5000"})
            assert r.ok and r.json() == {"y": 2 * i}
        assert all(rep.healthy for rep in gw.replicas())
    finally:
        if gw is not None:
            gw.stop()
        for s in servers:
            s.stop()
        reg.stop()


# ------------------------------------------------- the LM fleet on the CPU

N_NEW = 5
PROMPTS = [[3, 1, 4], [9, 8, 2], [2, 2, 7, 5], [5, 1], [7, 7, 7, 1, 2],
           [4, 6]]


@functools.lru_cache(maxsize=None)
def _lm():
    import jax
    import jax.numpy as jnp

    from mmlspark_tpu.models.transformer import transformer_lm
    from mmlspark_tpu_torch.models.bundle import from_flax_variables

    kw = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
              max_len=48)
    model = transformer_lm(dtype=jnp.float32, **kw)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, 4), jnp.int32), train=False)
    variables = {"params": jax.tree.map(np.asarray, variables["params"])}
    return model, variables, from_flax_variables("transformer_lm", variables,
                                                 kw, dtype="float32")


def _reference(prompt):
    import jax.numpy as jnp

    from mmlspark_tpu.models.generation import generate as j_generate

    model, variables, _bundle = _lm()
    out = j_generate(model, variables, jnp.asarray(prompt)[None],
                     max_new_tokens=N_NEW)
    return np.asarray(out)[0, len(prompt):].tolist()


def test_lm_fleet_streams_jax_generate_through_the_gateway(monkeypatch):
    from mmlspark_tpu_torch.serving import batcher as B

    built = []
    init = B.ContinuousBatcher.__init__

    def counting_init(self, *a, **kw):
        built.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(B.ContinuousBatcher, "__init__", counting_init)
    reg = ServiceRegistry()
    url = reg.start()
    query = gw = None
    results = [None] * len(PROMPTS)
    try:
        query = (read_stream()
                 .distributed_server(name="lmfleet", path="/lm", replicas=2,
                                     registry_url=url)
                 .parse_request(schema=["prompt"])
                 .generate_stream(_lm()[2], max_new_tokens=N_NEW,
                                  max_slots=2, paged=True, page_size=8,
                                  device="cpu")
                 .options(batch_timeout_ms=5.0).start())
        # two replicas, one batcher over one copy of the model
        assert len(query.service_infos) == 2 and built == [query._batcher]
        gw = FleetGateway(name="lmfleet", registry_url=url,
                          probe_interval_s=5.0)
        gw.start()
        assert len(gw.replicas()) == 2

        def client(i):
            r = _post(gw.url, {"prompt": PROMPTS[i]}, timeout=120.0)
            results[i] = (r.status_code, r.entity)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        if gw is not None:
            gw.stop()
        if query is not None:
            query.stop()
        reg.stop()
    for p, (status, body) in zip(PROMPTS, results):
        assert status == 200
        text = body.decode() if isinstance(body, bytes) else body
        assert [int(t) for t in text.split()] == _reference(p), p
    assert not query._batcher._thread.is_alive()
