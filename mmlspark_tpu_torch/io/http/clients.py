"""HTTP clients: retry/backoff handling + bounded-concurrency async pipeline.

Reference: core io/http/HTTPClients.scala:65-156 (`HandlingUtils.advanced`
retry-with-backoff incl. 429 Retry-After) and Clients.scala:48-120
(`AsyncClient`: bounded-concurrency Future pipeline with ordered results).

Host-side only (urllib + thread pool) — the data plane between client and
device is Table columns, exactly like the reference's executor-side Apache
HttpClient pools.

A copy of the JAX package's `io/http/clients.py` for this package.
"""
from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional, Sequence

from ...core import telemetry
from ...utils.faults import fault_point
from .schema import HTTPRequestData, HTTPResponseData

__all__ = ["send_request", "HandlingUtils", "AsyncHTTPClient",
           "get_shared_client", "CircuitBreaker", "get_breaker"]


class CircuitBreaker:
    """Per-endpoint circuit breaker: closed → open after
    `failure_threshold` CONSECUTIVE retryable failures → (after
    `reset_timeout_s`) half-open, admitting exactly ONE probe at a time —
    probe success closes the circuit, probe failure re-opens it.

    While open, callers get a synthesized local 503 ("circuit open",
    Retry-After = seconds until the next probe window) without touching
    the network — the point is to stop hammering an endpoint that is
    down and to fail fast instead of burning the full retry/backoff
    ladder per request.  Opt-in: nothing constructs one unless asked
    (`AsyncHTTPClient(breaker=...)`, `get_breaker(host)`).

    Transitions are counted in core.telemetry: ``circuit.open``,
    ``circuit.half_open_probe``, ``circuit.closed`` (plus per-name
    variants), so a soak can assert the breaker actually cycled."""

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}")
        self.name = str(name)
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock  # injectable for deterministic tests
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request proceed right now?  A half-open `True` claims
        the single probe slot — the caller MUST follow with record()."""
        with self._lock:
            if self._state == "closed":
                return True
            if (self._state == "open"
                    and self._clock() - self._opened_at
                    >= self.reset_timeout_s):
                self._state = "half_open"
            if self._state == "half_open" and not self._probing:
                self._probing = True
                telemetry.incr("circuit.half_open_probe")
                telemetry.incr(f"circuit.half_open_probe.{self.name}")
                return True
            return False

    def retry_after_s(self) -> float:
        """Seconds until the next probe window (0 when not open)."""
        with self._lock:
            if self._state != "open":
                return 0.0
            return max(0.0, self.reset_timeout_s
                       - (self._clock() - self._opened_at))

    def record(self, ok: bool) -> None:
        with self._lock:
            was = self._state
            self._probing = False
            if ok:
                self._failures = 0
                self._state = "closed"
                if was != "closed":
                    telemetry.incr("circuit.closed")
                    telemetry.incr(f"circuit.closed.{self.name}")
                return
            self._failures += 1
            if was == "half_open" or self._failures >= self.failure_threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self._failures = 0
                if was != "open":
                    telemetry.incr("circuit.open")
                    telemetry.incr(f"circuit.open.{self.name}")


_BREAKERS: dict = {}
_BREAKERS_LOCK = threading.Lock()


def get_breaker(name: str, failure_threshold: int = 5,
                reset_timeout_s: float = 30.0) -> CircuitBreaker:
    """Process-shared breaker registry keyed by name (conventionally the
    endpoint host) — every client/transformer hitting the same endpoint
    shares one failure budget, like get_shared_client shares one pool.
    Config arguments apply only on first construction."""
    with _BREAKERS_LOCK:
        br = _BREAKERS.get(name)
        if br is None:
            br = _BREAKERS[name] = CircuitBreaker(
                name, failure_threshold, reset_timeout_s)
        return br


def _circuit_open_response(breaker: CircuitBreaker) -> HTTPResponseData:
    return HTTPResponseData(
        status_code=503, reason="circuit open",
        headers={"Retry-After": f"{breaker.retry_after_s():.3f}",
                 "X-Circuit": breaker.name},
    )


def send_request(req: HTTPRequestData, timeout: float = 60.0) -> HTTPResponseData:
    """One HTTP exchange; transport errors become status 0 / reason text.

    Trace propagation: when the calling thread is inside a span, the
    current context rides out as `X-Trace-Id`/`X-Span-Id` (caller-set
    headers win), the downstream server continues the trace, and the
    exchange is recorded as an `http.send` child span here."""
    headers = telemetry.trace_headers(req.headers)
    ctx = telemetry.current_context()
    r = urllib.request.Request(
        req.url, data=req.entity, headers=headers, method=req.method,
    )
    t0 = time.perf_counter()
    try:
        fault_point("http.send")
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            out = HTTPResponseData(
                status_code=resp.status, reason=resp.reason or "",
                headers=dict(resp.headers.items()), entity=resp.read(),
            )
    except urllib.error.HTTPError as e:
        out = HTTPResponseData(
            status_code=e.code, reason=str(e.reason),
            headers=dict(e.headers.items()) if e.headers else {},
            entity=e.read(),
        )
    except Exception as e:  # URLError, timeout, connection refused...
        out = HTTPResponseData(status_code=0,
                               reason=f"{type(e).__name__}: {e}")
    dt = time.perf_counter() - t0
    telemetry.histogram("io.http.request.latency").observe(dt)
    if ctx is not None:
        telemetry.record_span("http.send", ctx, dt,
                              url=req.url, status=out.status_code)
    return out


class HandlingUtils:
    """Retry policies (HTTPClients.scala HandlingUtils.advanced)."""

    RETRYABLE = frozenset({0, 408, 429, 500, 502, 503, 504})

    @staticmethod
    def advanced(req: HTTPRequestData, backoffs_ms: Sequence[int] = (100, 500, 1000),
                 timeout: float = 60.0,
                 breaker: Optional[CircuitBreaker] = None) -> HTTPResponseData:
        """Send with retries: exponential backoff list; 429 honors
        Retry-After; non-retryable statuses return immediately.  With a
        `breaker`, every attempt first asks the circuit: an open circuit
        short-circuits to a local 503 (no network, no backoff ladder),
        and each attempt's outcome feeds the breaker's failure count."""
        if breaker is not None and not breaker.allow():
            return _circuit_open_response(breaker)
        resp = send_request(req, timeout)
        if breaker is not None:
            breaker.record(resp.status_code not in HandlingUtils.RETRYABLE)
        for backoff in backoffs_ms:
            if resp.status_code not in HandlingUtils.RETRYABLE:
                return resp
            wait_s = backoff / 1000.0
            if resp.status_code == 429:
                ra = resp.headers.get("Retry-After") or resp.headers.get(
                    "retry-after"
                )
                if ra is not None:
                    try:
                        wait_s = max(float(ra), wait_s)
                    except ValueError:
                        pass
            time.sleep(wait_s)
            if breaker is not None and not breaker.allow():
                return _circuit_open_response(breaker)
            resp = send_request(req, timeout)
            if breaker is not None:
                breaker.record(
                    resp.status_code not in HandlingUtils.RETRYABLE)
        return resp

    @staticmethod
    def basic(req: HTTPRequestData, timeout: float = 60.0) -> HTTPResponseData:
        return send_request(req, timeout)


class AsyncHTTPClient:
    """Bounded-concurrency request pipeline with ORDERED results.

    Reference: Clients.scala:48 AsyncClient — requests are dispatched up to
    `concurrency` at a time; results come back in submission order.
    """

    def __init__(self, concurrency: int = 8, timeout: float = 60.0,
                 backoffs_ms: Sequence[int] = (100, 500, 1000),
                 breaker: Optional[CircuitBreaker] = None):
        self.concurrency = int(concurrency)
        self.timeout = float(timeout)
        self.backoffs_ms = tuple(backoffs_ms)
        self.breaker = breaker  # opt-in; see CircuitBreaker/get_breaker
        self._pool = ThreadPoolExecutor(max_workers=self.concurrency)

    def send(self, req: HTTPRequestData,
             breaker: Optional[CircuitBreaker] = None) -> HTTPResponseData:
        return HandlingUtils.advanced(
            req, self.backoffs_ms, self.timeout,
            breaker=breaker if breaker is not None else self.breaker)

    def send_all(self, requests: Iterable[Optional[HTTPRequestData]],
                 breaker: Optional[CircuitBreaker] = None,
                 ) -> List[Optional[HTTPResponseData]]:
        """None requests yield None responses (null-safe, like the
        reference's sendRequestsWithContext).  `breaker` overrides the
        instance breaker for this batch — the hook cognitive services
        use to route calls through their per-host shared breaker without
        forking the process-shared client."""

        def one(req):
            if req is None:
                return None
            return self.send(req, breaker=breaker)

        return list(self._pool.map(one, requests))

    def close(self):
        self._pool.shutdown(wait=False)


def get_shared_client(concurrency: int, timeout: float) -> AsyncHTTPClient:
    """Process-shared client keyed by config (SharedVariable semantics) —
    the one place the cache key is built, used by HTTPTransformer and every
    cognitive service."""
    from ...core.shared import shared_singleton

    key = ("AsyncHTTPClient", int(concurrency), float(timeout))
    return shared_singleton(
        key, lambda: AsyncHTTPClient(int(concurrency), float(timeout))
    )
