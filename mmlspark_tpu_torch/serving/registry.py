"""Service registry: workers report endpoints to a coordinator service.

Reference: HTTPSourceV2.scala DriverServiceUtils (:133-194) — the Spark
driver hosts a registry every worker POSTs its ServiceInfo{host,port,...} to, and
HTTPSourceStateHolder.serviceInfoJson(name) exposes discovery (:409-416).

The registry runs on one coordinating process; workers register their
per-host serving endpoints with it over the network.  A copy of the JAX
package's `serving/registry.py` for this package: the same paths and
JSON, so replicas of either package register with either registry.

Entries are keyed by ``(name, host, port)``: re-registration is a
heartbeat (it refreshes ``last_seen``, never duplicates), entries older
than ``ttl_s`` are expired on every read so a dead worker stops being
discoverable within one TTL, and ``POST /deregister`` removes an entry
immediately (the graceful half — the gateway uses it when it drains a
replica out of a fleet, serving/fleet.py).

TTL caveat: expiry is evaluated on READ only — nothing here pushes a
death notification, so a replica that dies between a gateway's registry
syncs remains listed (and, on the gateway, routable) until the next
sync/probe notices.  The gateway-side close for that gap is the
federated telemetry puller (serving/fleet.py FleetTelemetry): a failed
``/metrics.json`` pull marks the replica unhealthy immediately through
the probe/breaker path.  ``prune()`` is the explicit server-side sweep
for operators/tests that want expiry without a read.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..io.http.clients import send_request
from ..io.http.schema import HTTPRequestData
from .server import ServiceInfo

__all__ = ["ServiceRegistry", "register_service", "deregister_service",
           "list_services"]


class ServiceRegistry:
    """Tiny registry server: POST /register, POST /deregister,
    GET /services[/name].

    `ttl_s` is the heartbeat contract: a worker that has not re-POSTed
    /register within `ttl_s` seconds is expired on the next read
    (`ttl_s=None` disables expiry).  The clock is injectable so tests
    can expire entries without sleeping.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ttl_s: Optional[float] = 30.0, clock=time.monotonic):
        # (name, host, port) -> info dict (+ "_last_seen" stamp)
        self._services: Dict[Tuple[str, str, int], dict] = {}
        self._lock = threading.Lock()
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self._clock = clock
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                path = self.path.rstrip("/")
                if path not in ("/register", "/deregister"):
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    info = json.loads(self.rfile.read(length))
                    key = (str(info["name"]), str(info["host"]),
                           int(info["port"]))
                except (ValueError, KeyError, TypeError):
                    self.send_error(400, "need JSON with name/host/port")
                    return
                if path == "/register":
                    outer._put(key, info)
                else:
                    outer._remove(key)
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")

            def do_GET(self):
                if not self.path.rstrip("/").startswith("/services"):
                    self.send_error(404)
                    return
                name = self.path.rstrip("/").split("/")[-1]
                if name and name != "services":
                    body = json.dumps(outer.services(name)).encode()
                else:
                    body = json.dumps(outer.services()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="svc-registry"
        )

    # ---- store ---------------------------------------------------------
    def _put(self, key: Tuple[str, str, int], info: dict):
        with self._lock:
            entry = dict(info)
            entry["_last_seen"] = self._clock()
            self._services[key] = entry

    def _remove(self, key: Tuple[str, str, int]):
        with self._lock:
            self._services.pop(key, None)

    def _prune_locked(self):
        if self.ttl_s is None:
            return
        cutoff = self._clock() - self.ttl_s
        for k in [k for k, v in self._services.items()
                  if v.get("_last_seen", 0.0) < cutoff]:
            del self._services[k]

    def prune(self) -> int:
        """Explicit TTL sweep (the read path runs this implicitly).
        Returns the number of entries remaining."""
        with self._lock:
            self._prune_locked()
            return len(self._services)

    @staticmethod
    def _public(entry: dict) -> dict:
        return {k: v for k, v in entry.items() if not k.startswith("_")}

    # ---- server lifecycle ---------------------------------------------
    @property
    def url(self) -> str:
        h, p = self._httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self) -> str:
        self._thread.start()
        return self.url

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    # ---- read side (TTL expiry happens here) --------------------------
    def services(self, name: Optional[str] = None):
        with self._lock:
            self._prune_locked()
            if name is not None:
                return [self._public(v) for (n, _h, _p), v
                        in self._services.items() if n == name]
            out: Dict[str, List[dict]] = {}
            for (n, _h, _p), v in self._services.items():
                out.setdefault(n, []).append(self._public(v))
            return out


def register_service(registry_url: str, info: ServiceInfo) -> bool:
    """Register (or heartbeat) one endpoint.  Idempotent: the registry
    keys on (name, host, port), so re-POSTing refreshes `last_seen`."""
    resp = send_request(HTTPRequestData(
        url=registry_url.rstrip("/") + "/register",
        headers={"Content-Type": "application/json"},
        entity=json.dumps(asdict(info)).encode(),
    ), timeout=10.0)
    return resp.ok


def deregister_service(registry_url: str, info: ServiceInfo) -> bool:
    """Remove one endpoint immediately (graceful shutdown / drain)."""
    resp = send_request(HTTPRequestData(
        url=registry_url.rstrip("/") + "/deregister",
        headers={"Content-Type": "application/json"},
        entity=json.dumps(asdict(info)).encode(),
    ), timeout=10.0)
    return resp.ok


def list_services(registry_url: str, name: str) -> List[dict]:
    resp = send_request(HTTPRequestData(
        url=registry_url.rstrip("/") + f"/services/{name}", method="GET",
    ), timeout=10.0)
    return resp.json() if resp.ok else []
