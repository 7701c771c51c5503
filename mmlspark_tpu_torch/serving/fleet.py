"""Fleet control plane, data half: a health-checked HTTP gateway routing
over a pool of worker replicas.

Reference lineage: the paper's Spark-driver registry (HTTPSourceV2
DriverServiceUtils) sketches discovery; Clipper-style model-serving
frontends sketch the rest — a thin routing tier in front of N identical
model replicas, with load-aware balancing, passive failure ejection, and
active health-probe reinstatement.  The single-replica machinery this
fronts (drain, deadlines, shedding, journal replay) lives in
serving/server.py; the rollout/canary control half lives in
serving/rollout.py; the operator story is the JAX package's
docs/serving.md.  A copy of the JAX package's `serving/fleet.py` for this
package: the same paths, headers, JSON shapes, fault points and counter
names, so a gateway of either package routes to replicas of either.

Routing policy
--------------
* Replicas are grouped by ``version``; a version is picked by weight
  (explicit canary splits via :meth:`FleetGateway.set_version_weight`,
  else proportional to the replicas' registered weights).
* Within the version group: **power of two choices** on per-replica
  in-flight counts — sample two distinct replicas, forward to the one
  with fewer requests currently in flight.  P2C gets most of the benefit
  of join-shortest-queue at O(1) cost and without herding on one
  momentarily-idle replica.
* A replica is routable while it is healthy (last probe succeeded), not
  draining, and its circuit is not open.

Deadline rule
-------------
The gateway decrements a client's ``X-Deadline-Ms`` budget by its own
observed elapsed time before every forward (including before a retry),
so the replica sees only the budget that is actually left.  An exhausted
budget is answered 504 at the gateway — never forwarded.

Retries
-------
A transport failure (replica died mid-exchange) or a 503 (shed /
draining) is retried on an ALTERNATE replica, at most ``retries`` times,
only while deadline budget remains, and never after response body bytes
have been relayed — a chunked stream that dies mid-body closes the
client connection rather than replaying a half-delivered stream.
Requests carrying ``X-Idempotent: false`` are never retried.

Ejection / reinstatement
------------------------
Each replica holds a :class:`~mmlspark_tpu_torch.io.http.clients.
CircuitBreaker` from the process-shared ``get_breaker`` registry:
consecutive transport failures open the circuit (passive ejection, no
more traffic).  A background prober GETs every replica's ``/health`` on
an interval (fault point ``fleet.health``); a live answer closes the
circuit and reinstates the replica, so a revived process at the same
address rejoins the pool without operator action.

Fleet telemetry plane
---------------------
:class:`FleetTelemetry` is the HTTP half of `core/telemetry/fleet.py`:
it pulls every replica's ``/metrics.json`` snapshot (never holding the
gateway routing lock across the wire), merges them exactly, feeds the
SLO burn-rate engine, and exposes ``GET /fleet/metrics`` (Prometheus +
JSON), ``GET /fleet/alerts``, ``GET /fleet/goodput`` (the federated
goodput/straggler view), and a federated ``GET /trace/<id>`` that
stitches one client trace across gateway + replica span stores.  A pull
failure marks the replica unhealthy through the same probe/breaker path
as an active health-probe failure — closing the registry-TTL gap where
a replica that died between registry syncs stayed routable until the
next scrape.  On an alert transitioning to firing, the attached
FlightRecorder dumps an incident bundle under ``incidents/<ts>/``.
"""
from __future__ import annotations

import http.client
import json
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set

from ..core import telemetry
from ..io.http.clients import CircuitBreaker, get_breaker, send_request
from ..io.http.schema import HTTPRequestData
from ..utils.faults import fault_point
from .registry import list_services
from ..utils.sync import make_lock
from .server import ServiceInfo

__all__ = ["Replica", "FleetGateway", "FleetTelemetry"]

# hop-by-hop (and gateway-owned) headers never copied onto the forward
_HOP_HEADERS = frozenset({
    "connection", "keep-alive", "transfer-encoding", "content-length",
    "host", "te", "upgrade", "proxy-connection",
    "x-trace-id", "x-span-id",     # re-injected from the gateway span
    "x-deadline-ms",               # re-stamped with the decremented budget
})

_LAT_WINDOW = 512  # per-version rolling latency window (rollout gating)


class Replica:
    """One routable backend: endpoint + version/weight + live state."""

    def __init__(self, info: ServiceInfo, breaker: CircuitBreaker,
                 server=None, from_registry: bool = False):
        self.info = info
        self.breaker = breaker
        # optional in-process handle (ServingServer) for lifecycle ops
        # (rolling drains in rollout.py); remote replicas use /admin/drain
        self.server = server
        self.from_registry = from_registry
        self.inflight = 0
        self.healthy = True
        self.draining = False
        # sticky local drain intent (set via FleetGateway.begin_drain,
        # under the gateway lock): a remote /health probe answered
        # before the replica processed /admin/drain reports
        # draining=false, and must not flip this replica back to
        # routable mid-drain
        self.drain_requested = False
        self.forwarded = 0
        self.errors = 0

    @property
    def key(self) -> str:
        return f"{self.info.host}:{self.info.port}"

    @property
    def version(self) -> str:
        return self.info.version

    @property
    def weight(self) -> float:
        return float(self.info.weight)

    def routable(self) -> bool:
        return (self.healthy and not self.draining
                and self.breaker.state != "open")

    def describe(self) -> dict:
        return {
            "url": self.info.url,
            "version": self.info.version,
            "weight": self.info.weight,
            "healthy": self.healthy,
            "draining": self.draining,
            "breaker": self.breaker.state,
            "inflight": self.inflight,
            "forwarded": self.forwarded,
            "errors": self.errors,
        }


class FleetGateway:
    """HTTP gateway fronting a replica pool (see module docstring).

    POSTs to `path` are routed/forwarded; admin surface:

    * ``GET /fleet``   — replica table, version weights + stats, rollout
    * ``GET /health``  — the gateway's own liveness
    * ``GET /metrics`` / ``/trace/<id>`` / ``/trace.json`` — the process
      telemetry registry (same handlers as WorkerServer)
    """

    def __init__(self, name: str = "fleet", path: str = "/",
                 host: str = "127.0.0.1", port: int = 0,
                 registry_url: Optional[str] = None,
                 probe_interval_s: float = 0.25,
                 retries: int = 1,
                 breaker_threshold: int = 2,
                 breaker_reset_s: float = 0.5,
                 forward_timeout_s: float = 30.0,
                 rng: Optional[random.Random] = None,
                 telemetry_interval_s: Optional[float] = None,
                 incident_dir: Optional[str] = None,
                 slos=None):
        self.name = name
        self.path = path if path.startswith("/") else "/" + path
        self.registry_url = registry_url
        self.probe_interval_s = float(probe_interval_s)
        self.retries = int(retries)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self.forward_timeout_s = float(forward_timeout_s)
        self._rng = rng or random.Random()
        self._lock = make_lock("serving.fleet.gateway")
        self._replicas: Dict[str, Replica] = {}
        # explicit canary splits (rollout.py); unset versions weigh
        # proportionally to their replicas' registered weights
        self._version_weights: Dict[str, float] = {}
        # per-version rolling stats feeding the rollout gate
        self._vstats: Dict[str, dict] = {}
        self.rollout = None  # RolloutController attaches itself here
        self.autoscale = None  # AutoscaleController attaches itself here
        # the federated telemetry plane: always constructed (the
        # /fleet/* endpoints pull synchronously when stale), background
        # puller thread only when an interval is configured
        self.telemetry_plane = FleetTelemetry(
            self, pull_interval_s=telemetry_interval_s,
            incident_dir=incident_dir, slos=slos)
        self._running = threading.Event()
        self._stop_evt = threading.Event()  # wakes the prober on stop()
        outer = self

        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def do_POST(self):
                if self.path.rstrip("/") != outer.path.rstrip("/"):
                    self.send_error(404)
                    return
                if "chunked" in self.headers.get(
                        "Transfer-Encoding", "").lower():
                    self.send_error(501, "chunked transfer not supported")
                    return
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                ctx = telemetry.extract_trace(self.headers)
                t0 = time.perf_counter()
                outcome = "error"
                try:
                    with telemetry.span("serving.fleet.request",
                                        parent_ctx=ctx,
                                        endpoint=outer.path) as sp:
                        outcome = outer._route(self, body,
                                               dict(self.headers.items()),
                                               sp)
                        sp.attrs["outcome"] = outcome
                finally:
                    telemetry.histogram(
                        "serving.fleet.request.latency",
                        endpoint=outer.path, outcome=outcome,
                    ).observe(time.perf_counter() - t0)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/fleet":
                    payload = json.dumps(outer.describe()).encode("utf-8")
                    self._reply(200, payload,
                                {"Content-Type": "application/json"})
                    return
                if path == "/fleet/metrics":
                    merged = outer.telemetry_plane.ensure_fresh()
                    payload = telemetry.render_fleet_prometheus(
                        merged).encode("utf-8")
                    self._reply(200, payload,
                                {"Content-Type":
                                 "text/plain; version=0.0.4; charset=utf-8"})
                    return
                if path == "/fleet/metrics.json":
                    merged = outer.telemetry_plane.ensure_fresh()
                    payload = json.dumps(merged, default=repr).encode(
                        "utf-8")
                    self._reply(200, payload,
                                {"Content-Type": "application/json"})
                    return
                if path == "/fleet/goodput":
                    # the federated goodput view alone: per-host
                    # summaries, fleet lost-time table, straggler verdict
                    merged = outer.telemetry_plane.ensure_fresh()
                    gp = merged.get("goodput") or {
                        "hosts": {}, "fleet": None, "straggler": None}
                    payload = json.dumps(gp, default=repr).encode("utf-8")
                    self._reply(200, payload,
                                {"Content-Type": "application/json"})
                    return
                if path == "/fleet/alerts":
                    outer.telemetry_plane.ensure_fresh()
                    payload = json.dumps({
                        "alerts": outer.telemetry_plane.engine.alerts(),
                    }, default=repr).encode("utf-8")
                    self._reply(200, payload,
                                {"Content-Type": "application/json"})
                    return
                if path == "/metrics.json":
                    payload = json.dumps(
                        telemetry.export_snapshot(include_spans=False),
                        default=repr).encode("utf-8")
                    self._reply(200, payload,
                                {"Content-Type": "application/json"})
                    return
                if path == "/health":
                    self._reply(200, b'{"status": "ok"}',
                                {"Content-Type": "application/json"})
                    return
                if path == "/metrics":
                    payload = telemetry.render_prometheus().encode("utf-8")
                    self._reply(200, payload,
                                {"Content-Type":
                                 "text/plain; version=0.0.4; charset=utf-8"})
                    return
                if path == "/trace.json":
                    payload = json.dumps(
                        telemetry.render_chrome_trace()).encode("utf-8")
                    self._reply(200, payload,
                                {"Content-Type": "application/json"})
                    return
                if path.startswith("/trace/"):
                    # federated: fan out to every replica's span store
                    # and stitch the hops under the client's trace id
                    tid = path[len("/trace/"):].strip("/")
                    stitched = outer.telemetry_plane.fetch_trace(tid)
                    if not stitched["spans"]:
                        self._reply(404, b'{"error": "unknown trace id"}',
                                    {"Content-Type": "application/json"})
                        return
                    payload = json.dumps(stitched, default=repr).encode(
                        "utf-8")
                    self._reply(200, payload,
                                {"Content-Type": "application/json"})
                    return
                self.send_error(404)

            def _reply(self, status: int, body: bytes,
                       headers: Dict[str, str]):
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"fleet-gw-{name}")
        self._prober = threading.Thread(
            target=self._probe_loop, daemon=True, name=f"fleet-probe-{name}")

    # ---- pool management ----------------------------------------------
    @property
    def service_info(self) -> ServiceInfo:
        h, p = self._httpd.server_address[:2]
        return ServiceInfo(self.name, h, p, self.path)

    @property
    def url(self) -> str:
        return self.service_info.url

    def add_replica(self, info: ServiceInfo, server=None,
                    from_registry: bool = False) -> Replica:
        """Register one backend.  Re-adding the same host:port updates
        version/weight in place (a revived process at the same address
        keeps its replica slot, breaker, and stats)."""
        breaker = get_breaker(f"fleet:{self.name}:{info.host}:{info.port}",
                              failure_threshold=self.breaker_threshold,
                              reset_timeout_s=self.breaker_reset_s)
        with self._lock:
            rep = self._replicas.get(f"{info.host}:{info.port}")
            if rep is None:
                rep = Replica(info, breaker, server=server,
                              from_registry=from_registry)
                self._replicas[rep.key] = rep
            else:
                rep.info = info
                if server is not None:
                    rep.server = server
            self._vstats.setdefault(info.version, {
                "n": 0, "errors": 0, "lat": deque(maxlen=_LAT_WINDOW)})
        self._update_gauges()
        return rep

    def add_server(self, server, version: str = "v1",
                   weight: float = 1.0) -> Replica:
        """Convenience: register an in-process ServingServer replica."""
        info = server.service_info
        info.version, info.weight = version, float(weight)
        return self.add_replica(info, server=server)

    def begin_drain(self, key: str) -> Optional[Replica]:
        """Mark a replica draining, stickily: the flag is set under the
        gateway lock and survives health probes until the replica is
        removed (see Replica.drain_requested)."""
        with self._lock:
            rep = self._replicas.get(key)
            if rep is not None:
                rep.drain_requested = True
                rep.draining = True
        return rep

    def remove_replica(self, key: str) -> Optional[Replica]:
        with self._lock:
            rep = self._replicas.pop(key, None)
        self._update_gauges()
        return rep

    def replicas(self, version: Optional[str] = None) -> List[Replica]:
        with self._lock:
            reps = list(self._replicas.values())
        if version is not None:
            reps = [r for r in reps if r.version == version]
        return reps

    def set_version_weight(self, version: str, weight: float) -> None:
        """Pin one version's share of traffic (canary split).  Weights
        are relative across versions; 0 removes a version from routing
        without touching its replicas."""
        with self._lock:
            self._version_weights[version] = float(weight)

    def sync_registry(self, name: Optional[str] = None) -> int:
        """Pull the replica pool from the ServiceRegistry: add newly
        registered endpoints, drop registry-sourced ones the registry no
        longer lists (TTL-expired or deregistered).  Returns pool size."""
        if self.registry_url is None:
            raise ValueError("gateway constructed without registry_url")
        listed = list_services(self.registry_url, name or self.name)
        seen: Set[str] = set()
        for entry in listed:
            info = ServiceInfo(
                name=entry.get("name", self.name), host=entry["host"],
                port=int(entry["port"]), path=entry.get("path", self.path),
                version=entry.get("version", "v1"),
                weight=float(entry.get("weight", 1.0)))
            seen.add(f"{info.host}:{info.port}")
            self.add_replica(info, from_registry=True)
        with self._lock:
            stale = [k for k, r in self._replicas.items()
                     if r.from_registry and k not in seen]
            for k in stale:
                del self._replicas[k]
            n = len(self._replicas)
        self._update_gauges()
        return n

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> ServiceInfo:
        self._running.set()
        if self.registry_url is not None:
            self.sync_registry()
        self._thread.start()
        self._prober.start()
        self.telemetry_plane.start()
        return self.service_info

    def stop(self):
        self._running.clear()
        self._stop_evt.set()
        self.telemetry_plane.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._prober.join(timeout=5)

    # ---- observability -------------------------------------------------
    def _update_gauges(self):
        with self._lock:
            reps = list(self._replicas.values())
        telemetry.gauge("serving.fleet.replicas").set(len(reps))
        telemetry.gauge("serving.fleet.healthy").set(
            sum(1 for r in reps if r.routable()))

    def version_stats(self, version: str) -> dict:
        """Rolling stats for one version (the rollout gate's input):
        request/error counts plus latency percentiles over the last
        `_LAT_WINDOW` forwards."""
        with self._lock:
            st = self._vstats.get(version)
            if st is None:
                return {"requests": 0, "errors": 0, "error_rate": 0.0,
                        "latency_p50": None, "latency_p95": None}
            lat = sorted(st["lat"])
            n, errors = st["n"], st["errors"]

        def pct(q):
            if not lat:
                return None
            return lat[min(len(lat) - 1, int(q * len(lat)))]

        return {"requests": n, "errors": errors,
                "error_rate": (errors / n) if n else 0.0,
                "latency_p50": pct(0.50), "latency_p95": pct(0.95)}

    def describe(self) -> dict:
        with self._lock:
            reps = [r.describe() for r in self._replicas.values()]
            weights = dict(self._version_weights)
            versions = sorted(self._vstats)
        out = {
            "name": self.name,
            "path": self.path,
            "url": self.url,
            "replicas": reps,
            "version_weights": weights,
            "versions": {v: self.version_stats(v) for v in versions},
        }
        if self.rollout is not None:
            out["rollout"] = self.rollout.describe()
        if self.autoscale is not None:
            out["autoscale"] = self.autoscale.describe()
        out["telemetry"] = self.telemetry_plane.describe()
        return out

    # ---- routing -------------------------------------------------------
    def _choose(self, exclude: Set[str]) -> Optional[Replica]:
        with self._lock:
            pool = [r for r in self._replicas.values()
                    if r.key not in exclude and r.routable()]
            if not pool:
                return None
            groups: Dict[str, List[Replica]] = {}
            for r in pool:
                groups.setdefault(r.version, []).append(r)
            versions, weights = [], []
            for v, grp in groups.items():
                w = self._version_weights.get(
                    v, sum(r.weight for r in grp))
                if w > 0:
                    versions.append(v)
                    weights.append(w)
            if not versions:
                # every version pinned to 0: serve SOMETHING rather than
                # hard-fail a misconfigured split
                versions = list(groups)
                weights = [1.0] * len(versions)
            v = self._rng.choices(versions, weights=weights)[0]
            grp = groups[v]
            if len(grp) == 1:
                return grp[0]
            a, b = self._rng.sample(grp, 2)
            return a if a.inflight <= b.inflight else b

    @staticmethod
    def _parse_deadline_ms(headers: Dict[str, str]) -> Optional[float]:
        for k, v in headers.items():
            if k.lower() == "x-deadline-ms":
                try:
                    return float(v)
                except ValueError:
                    return None
        return None

    @staticmethod
    def _idempotent(headers: Dict[str, str]) -> bool:
        for k, v in headers.items():
            if k.lower() == "x-idempotent":
                return str(v).strip().lower() not in ("false", "0", "no")
        return True

    def _route(self, handler, body: bytes, headers: Dict[str, str],
               sp) -> str:
        """Pick a replica, forward, retry on an alternate within budget.
        Returns the outcome label for the request-latency histogram."""
        t_accept = time.monotonic()
        budget_ms = self._parse_deadline_ms(headers)
        retriable = self._idempotent(headers)
        tried: Set[str] = set()
        attempts = 0
        while True:
            if budget_ms is not None:
                remaining_ms = budget_ms - (
                    time.monotonic() - t_accept) * 1000.0
                if remaining_ms <= 0.0:
                    telemetry.incr("serving.fleet.deadline_expired")
                    self._reply_json(handler, 504, {
                        "error": "deadline exceeded at gateway"})
                    return "timeout"
            else:
                remaining_ms = None
            rep = self._choose(tried)
            if rep is None:
                telemetry.incr("serving.fleet.no_replica")
                self._reply_json(handler, 503, {
                    "error": "no routable replica"},
                    extra={"Retry-After": "1"})
                return "shed"
            tried.add(rep.key)
            sp.attrs["replica"] = rep.key
            sp.attrs["version"] = rep.version
            status, relayed, saved = self._attempt(
                handler, rep, body, headers, remaining_ms,
                may_retry=retriable and attempts < self.retries
                and self._choose(tried | {rep.key}) is not None)
            if relayed:
                return self._outcome(status)
            # not relayed: transport failure (saved=None) or a retryable
            # upstream status whose body we buffered
            attempts += 1
            if not retriable or attempts > self.retries:
                if saved is not None:
                    self._relay_saved(handler, *saved)
                    return self._outcome(saved[0])
                self._reply_json(handler, 502, {
                    "error": "upstream replica failed",
                    "attempts": attempts})
                return "error"
            telemetry.incr("serving.fleet.retry")

    @staticmethod
    def _outcome(status: int) -> str:
        if status < 400:
            return "ok"
        if status == 503:
            return "shed"
        if status == 504:
            return "timeout"
        return "error"

    # the HandlingUtils.advanced retryable set, minus 408/429
    # (request-timeout and rate-limit answers follow the request, not the
    # replica — forwarding them to another replica amplifies load)
    RETRYABLE_STATUS = frozenset({500, 502, 503, 504})

    def _attempt(self, handler, rep: Replica, body: bytes,
                 headers: Dict[str, str],
                 remaining_ms: Optional[float], may_retry: bool):
        """One forward to one replica.  Returns (status, relayed, saved):
        relayed=False means nothing was written to the client and the
        caller retries on an alternate replica; `saved` then carries the
        buffered upstream (status, headers, payload) — if it was a
        retryable HTTP response rather than a transport failure — so an
        exhausted retry budget can still relay the real upstream answer."""
        fwd_headers = {k: v for k, v in headers.items()
                       if k.lower() not in _HOP_HEADERS}
        if remaining_ms is not None:
            # the deadline decrement rule: the replica sees only what is
            # left of the client's budget after gateway time (fractional
            # ms — rounding would hand back budget the gateway spent)
            fwd_headers["X-Deadline-Ms"] = f"{remaining_ms:.3f}"
        # the gateway span is the active context on this thread, so the
        # replica's serving.request span becomes its child
        fwd_headers = telemetry.trace_headers(fwd_headers)
        timeout = self.forward_timeout_s
        if remaining_ms is not None:
            timeout = max(0.05, min(timeout, remaining_ms / 1000.0))
        with self._lock:
            rep.inflight += 1
        t0 = time.perf_counter()
        conn = None
        try:
            fault_point("fleet.forward")
            conn = http.client.HTTPConnection(
                rep.info.host, rep.info.port, timeout=timeout)
            conn.request("POST", rep.info.path, body=body,
                         headers=fwd_headers)
            resp = conn.getresponse()
        except Exception:  # noqa: BLE001 — transport failure = dead replica
            self._record_result(rep, ok=False, status=0,
                                dt=time.perf_counter() - t0)
            if conn is not None:
                conn.close()
            return 0, False, None
        try:
            status = resp.status
            if status in self.RETRYABLE_STATUS and may_retry:
                # shed (503), timed out (504), or errored (500/502): the
                # replica is ALIVE (an answer arrived — liveness is the
                # breaker's concern, quality is the canary gate's), but
                # an alternate may do better.  Buffer the answer so an
                # exhausted budget still relays it instead of a generic
                # 502.  Streams never reach here: a chunked body is
                # relayed immediately below, mid-body retries never.
                payload = resp.read()
                self._record_result(rep, ok=True, status=status,
                                    dt=time.perf_counter() - t0)
                return status, False, (status, resp.getheaders(), payload)
            if getattr(resp, "chunked", False):
                self._relay_stream(handler, resp)
                self._record_result(rep, ok=True, status=status,
                                    dt=time.perf_counter() - t0)
                return status, True, None
            payload = resp.read()
            self._record_result(rep, ok=True, status=status,
                                dt=time.perf_counter() - t0)
            self._relay_buffered(handler, resp, payload)
            return status, True, None
        finally:
            conn.close()

    def _record_result(self, rep: Replica, ok: bool, status: int,
                       dt: float):
        """Book one attempt's outcome: breaker, eject counter, per-
        replica histogram, per-version rolling stats."""
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)
            was_open = rep.breaker.state == "open"
            rep.breaker.record(ok)
            opened = (not was_open) and rep.breaker.state == "open"
            rep.forwarded += 1
            is_error = (not ok) or (status >= 500 and status != 503)
            if is_error:
                rep.errors += 1
            st = self._vstats.setdefault(rep.version, {
                "n": 0, "errors": 0, "lat": deque(maxlen=_LAT_WINDOW)})
            st["n"] += 1
            if is_error:
                st["errors"] += 1
            if ok:
                st["lat"].append(dt)
        if opened:
            telemetry.incr("serving.fleet.eject")
        telemetry.histogram("serving.fleet.replica.latency",
                            replica=rep.key,
                            version=rep.version).observe(dt)
        if opened:
            self._update_gauges()

    # ---- relaying ------------------------------------------------------
    @staticmethod
    def _copy_headers(handler, header_items):
        for k, v in header_items:
            if k.lower() in ("transfer-encoding", "content-length",
                             "connection", "keep-alive", "host",
                             "te", "upgrade", "proxy-connection"):
                continue
            handler.send_header(k, v)

    def _relay_saved(self, handler, status: int, header_items,
                     payload: bytes):
        handler.send_response(status)
        self._copy_headers(handler, header_items)
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        handler.wfile.write(payload)

    def _relay_buffered(self, handler, resp, payload: bytes):
        self._relay_saved(handler, resp.status, resp.getheaders(), payload)

    def _relay_stream(self, handler, resp):
        """Chunk-by-chunk pass-through of a streaming reply.  Once the
        first chunk is relayed the request is unretryable (mid-body); a
        failure here drops the client connection.  `read1` returns each
        upstream chunk as it arrives (`read(n)` of a chunked response
        blocks until n bytes or the end), so a token stream flushes per
        token through the gateway too."""
        handler.send_response(resp.status)
        self._copy_headers(handler, resp.getheaders())
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        try:
            while True:
                chunk = resp.read1(8192)
                if not chunk:
                    break
                handler.wfile.write(
                    f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                handler.wfile.flush()
            handler.wfile.write(b"0\r\n\r\n")
            handler.wfile.flush()
        except OSError:
            handler.close_connection = True

    def _reply_json(self, handler, status: int, payload: dict,
                    extra: Optional[Dict[str, str]] = None):
        body = json.dumps(payload).encode("utf-8")
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        for k, v in (extra or {}).items():
            handler.send_header(k, v)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    # ---- active health probing ----------------------------------------
    def _probe_loop(self):
        while self._running.is_set():
            if self._stop_evt.wait(self.probe_interval_s):
                return
            for rep in self.replicas():
                self._probe_one(rep)

    def _probe_one(self, rep: Replica) -> bool:
        ok = False
        draining = rep.draining
        try:
            fault_point("fleet.health")
            resp = send_request(HTTPRequestData(
                url=f"http://{rep.info.host}:{rep.info.port}/health",
                method="GET"), timeout=2.0)
            ok = resp.status_code == 200
            if ok:
                try:
                    draining = bool(resp.json().get("draining", False))
                except (ValueError, AttributeError):
                    draining = False
        except Exception:  # noqa: BLE001 — incl. injected fleet.health faults
            ok = False
        self._mark_probe(rep, ok, draining)
        return ok

    def _mark_probe(self, rep: Replica, ok: bool, draining: bool):
        with self._lock:
            was_routable = rep.routable()
            rep.draining = draining or rep.drain_requested
            if ok:
                rep.healthy = True
                if rep.breaker.state != "closed":
                    # active reinstatement: a live /health closes the
                    # circuit that passive failures opened
                    rep.breaker.record(True)
                now_routable = rep.routable()
            else:
                rep.healthy = False
                now_routable = False
        if ok and not was_routable and now_routable:
            telemetry.incr("serving.fleet.reinstate")
        elif not ok and was_routable:
            telemetry.incr("serving.fleet.eject")
        self._update_gauges()


class FleetTelemetry:
    """The gateway-side federated telemetry plane (HTTP half of
    `core/telemetry/fleet.py`).

    ``pull_once()`` copies the replica list (one brief gateway-lock
    acquisition), then performs every ``/metrics.json`` GET and the
    merge WITHOUT the routing lock — a slow replica scrape can never
    stall request routing.  The gateway's own registry rides along as
    source ``gateway``, so fleet-level gauges (``serving.fleet.healthy``
    / ``.replicas``) and the merged request histograms land in one view
    the :class:`~mmlspark_tpu_torch.core.telemetry.fleet.SLOEngine` evaluates.

    A pull failure is a health signal, not just a gap in the data: the
    replica is marked unhealthy immediately through the same
    ``_mark_probe`` path as an active probe failure (eject counter,
    gauges, breaker reinstatement later) — this closes the
    registry-TTL-on-read hole where a replica that died between
    registry syncs stayed routable until something else noticed.
    """

    def __init__(self, gateway: "FleetGateway",
                 pull_interval_s: Optional[float] = None,
                 pull_timeout_s: float = 2.0,
                 slos=None,
                 incident_dir: Optional[str] = None,
                 clock=None,
                 worst_traces: int = 3):
        self.gateway = gateway
        self.pull_interval_s = pull_interval_s
        self.pull_timeout_s = float(pull_timeout_s)
        self.worst_traces = int(worst_traces)
        kwargs = {} if clock is None else {"clock": clock}
        self.engine = telemetry.SLOEngine(
            slos if slos is not None else telemetry.default_slos(),
            **kwargs)
        self.recorder = (telemetry.FlightRecorder(incident_dir)
                         if incident_dir else None)
        if self.recorder is not None:
            self.engine.on_transition(self._on_transition)
        self._lock = make_lock("serving.fleet.telemetry")
        self._merged: Optional[dict] = None  #: guarded-by self._lock
        self._last_pull = 0.0  #: guarded-by self._lock (0 = never pulled)
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- pulling -------------------------------------------------------

    def _get_json(self, host: str, port: int, path: str) -> Optional[dict]:
        try:
            fault_point("fleet.pull")
            resp = send_request(HTTPRequestData(
                url=f"http://{host}:{port}{path}", method="GET"),
                timeout=self.pull_timeout_s)
            if not resp.ok:
                return None
            return resp.json()
        except Exception:  # noqa: BLE001 — incl. injected fleet.pull faults
            return None

    def pull_once(self) -> dict:
        """One full federated pull + merge + SLO evaluation.  Returns
        the merged fleet view (also cached for the endpoints)."""
        t0 = time.perf_counter()
        reps = self.gateway.replicas()  # brief lock; copied list
        sources: Dict[str, dict] = {
            "gateway": telemetry.export_snapshot(include_spans=False)}
        versions: Dict[str, str] = {}
        failed: List[str] = []
        for rep in reps:
            snap = self._get_json(rep.info.host, rep.info.port,
                                  "/metrics.json")
            if snap is None:
                failed.append(rep.key)
                telemetry.incr("fleet.pull_failed")
                telemetry.incr(f"fleet.pull_failed.{rep.key}")
                # dead-between-syncs replica: unroutable NOW, through
                # the same path as an active probe failure
                self.gateway._mark_probe(rep, ok=False,
                                         draining=rep.draining)
                continue
            sources[rep.key] = snap
            versions[rep.key] = rep.version
        merged = telemetry.merge_snapshots(sources, versions)
        merged["meta"]["gateway"] = self.gateway.name
        merged["meta"]["failed"] = failed
        telemetry.incr("fleet.pull")
        telemetry.gauge("fleet.pull.replicas").set(len(sources) - 1)
        telemetry.histogram("fleet.scrape.latency").observe(
            time.perf_counter() - t0)
        self.engine.observe(merged)
        with self._lock:
            self._merged = merged
            self._last_pull = time.monotonic()
        return merged

    def ensure_fresh(self, max_age_s: Optional[float] = None) -> dict:
        """The cached merged view, re-pulled when never pulled or older
        than `max_age_s` (default: the pull interval, else 0.5 s) — so a
        gateway without a background puller still answers /fleet/*."""
        if max_age_s is None:
            max_age_s = self.pull_interval_s or 0.5
        with self._lock:
            merged = self._merged
            fresh = (merged is not None
                     and time.monotonic() - self._last_pull < max_age_s)
        if fresh:
            return merged
        return self.pull_once()

    def merged(self) -> Optional[dict]:
        with self._lock:
            return self._merged

    # ---- trace stitching -----------------------------------------------

    def fetch_trace(self, trace_id: str) -> dict:
        """Fan one trace id out to every replica's ``/trace/<id>`` and
        stitch the gateway's own spans plus every hop's into one tree."""
        sources: Dict[str, list] = {
            "gateway": telemetry.get_trace(trace_id)}
        for rep in self.gateway.replicas():
            data = self._get_json(rep.info.host, rep.info.port,
                                  f"/trace/{trace_id}")
            if data and data.get("spans"):
                sources[rep.key] = data["spans"]
        return telemetry.stitch_spans(trace_id, sources)

    def _worst_trace_ids(self) -> List[str]:
        """Trace ids of the slowest recent gateway requests — what the
        flight recorder stitches into the incident bundle."""
        reqs = [r for r in telemetry.recent_spans()
                if r.get("name") == "serving.fleet.request"]
        reqs.sort(key=lambda r: r.get("wall_s", 0.0), reverse=True)
        out: List[str] = []
        for r in reqs:
            tid = r.get("trace_id")
            if tid and tid not in out:
                out.append(tid)
            if len(out) >= self.worst_traces:
                break
        return out

    # ---- incident hook -------------------------------------------------

    def _on_transition(self, slo, old: str, new: str, info: dict) -> None:
        if new != "firing" or self.recorder is None:
            return
        try:
            traces = {tid: self.fetch_trace(tid)
                      for tid in self._worst_trace_ids()}
            self.recorder.dump(
                f"slo_{slo.name}",
                merged=self.merged(),
                traces=traces,
                records=telemetry.recent_records()[-100:],
                health=self.gateway.describe(),
                alerts=self.engine.alerts())
        except Exception:  # noqa: BLE001 — recording must never break eval
            pass

    # ---- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self.pull_interval_s is None or self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"fleet-pull-{self.gateway.name}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.pull_interval_s):
            try:
                self.pull_once()
            except Exception:  # noqa: BLE001 — puller must survive anything
                pass

    def stop(self) -> None:
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def describe(self) -> dict:
        with self._lock:
            age = (time.monotonic() - self._last_pull
                   if self._merged is not None else None)
            n = (self._merged["meta"]["replica_count"]
                 if self._merged else 0)
        return {
            "pull_interval_s": self.pull_interval_s,
            "last_pull_age_s": round(age, 3) if age is not None else None,
            "sources": n,
            "alerts": {a["slo"]: a["state"]
                       for a in self.engine.alerts()},
            "incidents": (self.recorder.bundles()
                          if self.recorder else []),
        }
