"""Low-latency model serving: embedded HTTP servers + continuous batching.

Reference: the Spark Serving subsystem (SURVEY §2.4/§3.4) —
HTTPSourceV2.scala:114-735 (per-executor embedded `WorkerServer`, epoch
request queues, `routingTable` correlating request-id -> held exchange,
`historyQueues`/`recoveredPartitions` replay), HTTPSinkV2.scala:55-150
(`replyTo` over the held socket), DistributedHTTPSource.scala (per-JVM shared
server), DriverServiceUtils (:133-194, worker ServiceInfo registry).

TPU-native redesign: one embedded server per host process feeds a
continuous-batching loop — requests are drained into a columnar Table
micro-batch, run through a (jit-compiled) Transformer, and answered over the
held connections.  The data path never leaves the host that accepted the
request (the reference's sub-ms claim rests on the same property).

A copy of the JAX package's `serving/server.py` for this package; its
`/metrics` and `/metrics.json` scrapes sample device memory
(`telemetry.sample_device_memory`) first.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core import telemetry
from ..core.schema import Table
from ..io.http.schema import HTTPRequestData, HTTPResponseData
from ..core.flow import deadline_expired, deadline_from_ms
from ..utils.sync import make_lock
from ..utils.fault_tolerance import Overloaded
from ..utils.faults import fault_point
from .journal import EpochJournal

__all__ = ["CachedRequest", "WorkerServer", "ServingServer", "ServiceInfo",
           "StreamWriter", "parse_request", "make_reply"]


@dataclass
class ServiceInfo:
    """What a worker reports to the registry (HTTPSourceV2 ServiceInfo).

    `version` and `weight` feed the fleet control plane (serving/fleet.py):
    the gateway groups replicas by version for canary splits and uses the
    per-replica weight inside a version group."""

    name: str
    host: str
    port: int
    path: str
    version: str = "v1"
    weight: float = 1.0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.path}"


@dataclass
class CachedRequest:
    """A held exchange: the handler thread parks on `done` until the batch
    loop replies (routingTable entry in the reference)."""

    id: str
    request: HTTPRequestData
    done: threading.Event = field(default_factory=threading.Event)
    response: Optional[HTTPResponseData] = None
    attempts: int = 0
    # streaming reply (stream_to): chunk queue drained by the handler
    # thread; None sentinel closes the stream.  handler_gone flips when
    # the handler thread exits (disconnect, timeout, drain done) so the
    # producer stops writing into a queue nobody reads.
    stream: Optional["Queue[Optional[bytes]]"] = None
    stream_headers: Optional[Dict[str, str]] = None
    handler_gone: threading.Event = field(default_factory=threading.Event)
    # journal-recovered after a restart: no client holds this exchange
    recovered: bool = False
    # absolute time.monotonic() budget from the X-Deadline-Ms header; an
    # expired request is failed fast at batch admission, never computed
    deadline: Optional[float] = None
    # trace context (trace_id, span_id) of the handler's serving.request
    # span: the batch loop runs on ANOTHER thread, so propagation across
    # that hop is explicit — the loop re-activates this via use_trace()
    trace: Optional[Tuple[str, str]] = None
    # when the request entered the queue (monotonic): queue-wait span
    accepted_at: Optional[float] = None


class WorkerServer:
    """Embedded threaded HTTP server with request queue + routing table.

    Reference: HTTPSourceV2.scala WorkerServer (:475-696).
    """

    def __init__(self, name: str, host: str = "127.0.0.1", port: int = 0,
                 path: str = "/", handler_timeout: float = 30.0,
                 journal: Optional["EpochJournal"] = None,
                 max_queue: Optional[int] = 1024):
        self.name = name
        self.path = path if path.startswith("/") else "/" + path
        # the queue object stays unbounded: requeue/recover/journal-replay
        # re-insert ALREADY-ACCEPTED requests and must never block or drop.
        # The bound is enforced at HTTP admission (do_POST sheds with 503 +
        # Retry-After once qsize reaches max_queue) — bounded by default so
        # a stalled consumer can't grow the queue without limit.
        self.queue: "Queue[CachedRequest]" = Queue()  # graftlint: disable=G403
        self.max_queue = None if max_queue is None else int(max_queue)
        # draining: admission sheds everything while held exchanges finish
        # (the graceful half of ServingServer.stop())
        self._draining = threading.Event()
        self.routing: Dict[str, CachedRequest] = {}
        self._routing_lock = make_lock("serving.server.routing")
        self.handler_timeout = handler_timeout
        # epoch-scoped request history for replay-on-retry + commit GC
        # (HTTPSourceV2.scala historyQueues :488-505, commit :555-567)
        self.epoch = 0
        self.history: Dict[int, List[CachedRequest]] = {}
        self._epoch_lock = make_lock("serving.server.epoch")
        # optional disk journal: process-restart persistence (the streaming
        # checkpointLocation analog — see serving/journal.py)
        self.journal = journal
        if journal is not None:
            # recovered requests are already on disk in the journal (it
            # compacts, never truncates) — just requeue them
            for req_id, entity, headers in journal.recovered_requests():
                req = CachedRequest(
                    id=req_id,
                    request=HTTPRequestData(url=self.path, method="POST",
                                            headers=headers, entity=entity),
                    recovered=True)
                with self._routing_lock:
                    self.routing[req.id] = req
                self.queue.put(req)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: a client can pipeline many requests over
            # one connection, so ThreadingHTTPServer's thread-per-CONNECTION
            # cost (and TCP setup) is paid once, not per request; NODELAY
            # stops Nagle from holding back the small JSON replies.
            # Measured on loopback (1-core host): serial p50 0.93ms -> 0.32ms.
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def do_POST(self):
                if self.path.rstrip("/") == "/admin/drain":
                    # remote rolling-drain hook (fleet rollouts): flip to
                    # draining, let the poller watch /health for drained
                    length = int(self.headers.get("Content-Length", 0))
                    if length:
                        self.rfile.read(length)  # keep-alive framing
                    outer.begin_drain()
                    self._reply_bytes(200, b'{"draining": true}',
                                      {"Content-Type": "application/json"})
                    return
                if self.path.rstrip("/") != outer.path.rstrip("/"):
                    self.send_error(404)
                    return
                # continue the caller's trace (X-Trace-Id / X-Span-Id) or
                # root a fresh one; the whole held exchange is one span
                ctx = telemetry.extract_trace(self.headers)
                t0 = time.perf_counter()
                outcome = "error"
                try:
                    with telemetry.span("serving.request", parent_ctx=ctx,
                                        endpoint=outer.path) as sp:
                        outcome = self._handle_post(sp)
                        sp.attrs["outcome"] = outcome
                finally:
                    telemetry.histogram(
                        "serving.request.latency",
                        endpoint=outer.path, outcome=outcome,
                    ).observe(time.perf_counter() - t0)

            def _handle_post(self, sp) -> str:
                """The held-exchange body; returns the outcome label for
                the serving.request.latency histogram ("ok" / "shed" /
                "timeout" / "error")."""
                # keep-alive framing safety: an unread chunked body would be
                # parsed as the NEXT request on this held connection
                if "chunked" in self.headers.get(
                        "Transfer-Encoding", "").lower():
                    self.send_error(501, "chunked transfer not supported")
                    return "error"
                length = int(self.headers.get("Content-Length", 0))
                # read the body BEFORE any early reply: unread bytes would
                # frame as the next request on this keep-alive connection
                body = self.rfile.read(length) if length else b""
                if outer._draining.is_set() or (
                        outer.max_queue is not None
                        and outer.queue.qsize() >= outer.max_queue):
                    # load shedding: a bounded queue answers "not now"
                    # immediately instead of queueing work it can't keep
                    # up with (admission control; 503 is retryable)
                    telemetry.incr("serving.shed")
                    self._reply_bytes(
                        503, b'{"error": "server overloaded, retry later"}',
                        {"Retry-After": "1",
                         "Content-Type": "application/json"})
                    return "shed"
                # the runtime's one deadline model (core/flow.py):
                # malformed budgets mean no deadline
                deadline = deadline_from_ms(
                    self.headers.get("X-Deadline-Ms"))
                req = CachedRequest(
                    id=uuid.uuid4().hex,
                    request=HTTPRequestData(
                        url=self.path, method="POST",
                        headers=dict(self.headers.items()), entity=body,
                    ),
                    deadline=deadline,
                    trace=(sp.trace_id, sp.span_id),
                    accepted_at=time.monotonic(),
                )
                if outer.journal is not None:
                    outer.journal.log_request(req.id, body,
                                              req.request.headers)
                with outer._routing_lock:
                    outer.routing[req.id] = req
                outer.queue.put(req)
                try:
                    if not req.done.wait(outer.handler_timeout):
                        outer._finish(req.id)
                        self.send_error(504, "model timed out")
                        return "timeout"
                    if req.stream is not None:
                        self._drain_stream(req)
                        return "ok"
                finally:
                    # all exits (reply sent, 504, disconnect) tell the
                    # producer this exchange is over — StreamWriter.write
                    # raises instead of filling a queue nobody drains
                    req.handler_gone.set()
                resp = req.response or HTTPResponseData(500, "no response")
                body = resp.entity or b""
                self.send_response(resp.status_code)
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                sc = resp.status_code
                if sc < 400:
                    return "ok"
                if sc == 503:
                    return "shed"
                if sc == 504:
                    return "timeout"
                return "error"

            def do_GET(self):
                """Observability endpoints on every worker server:
                `/metrics` (Prometheus text exposition of the process
                registry), `/trace/<id>` (one trace's spans + nested
                tree as JSON) and `/trace.json` (the whole span ring as
                Chrome/Perfetto trace-event JSON)."""
                path = self.path.split("?", 1)[0]
                if path.rstrip("/") == "/health":
                    # liveness + drain progress for the fleet gateway's
                    # active prober and rolling-drain poller.  Always 200
                    # while the process serves: "draining" is a routing
                    # hint, not an error.
                    draining = outer._draining.is_set()
                    payload = json.dumps({
                        "status": "draining" if draining else "ok",
                        "draining": draining,
                        "drained": outer.drained(),
                        "queue_depth": outer.queue.qsize(),
                    }).encode("utf-8")
                    self._reply_bytes(200, payload,
                                      {"Content-Type": "application/json"})
                    return
                if path.rstrip("/") == "/metrics":
                    try:
                        # freshen the device gauges on every scrape;
                        # passive no-op when CUDA is not initialised
                        telemetry.sample_device_memory()
                    except Exception:
                        pass
                    payload = telemetry.render_prometheus().encode("utf-8")
                    self._reply_bytes(
                        200, payload,
                        {"Content-Type":
                         "text/plain; version=0.0.4; charset=utf-8"})
                    return
                if path.rstrip("/") == "/metrics.json":
                    # the federated-pull wire format: the full registry
                    # as an export_snapshot dict (what the gateway's
                    # FleetTelemetry merges across the pool)
                    try:
                        telemetry.sample_device_memory()
                    except Exception:
                        pass
                    payload = json.dumps(
                        telemetry.export_snapshot(include_spans=False),
                        default=repr).encode("utf-8")
                    self._reply_bytes(200, payload,
                                      {"Content-Type": "application/json"})
                    return
                if path.rstrip("/") == "/trace.json":
                    payload = json.dumps(
                        telemetry.render_chrome_trace()).encode("utf-8")
                    self._reply_bytes(200, payload,
                                      {"Content-Type": "application/json"})
                    return
                if path.startswith("/trace/"):
                    tid = path[len("/trace/"):].strip("/")
                    spans = telemetry.get_trace(tid)
                    if not spans:
                        self._reply_bytes(
                            404, b'{"error": "unknown trace id"}',
                            {"Content-Type": "application/json"})
                        return
                    payload = json.dumps({
                        "trace_id": tid,
                        "spans": spans,
                        "tree": telemetry.span_tree(tid),
                    }).encode("utf-8")
                    self._reply_bytes(200, payload,
                                      {"Content-Type": "application/json"})
                    return
                self.send_error(404)

            def _reply_bytes(self, status: int, body: bytes,
                             headers: Dict[str, str]):
                """Direct small reply (shed/error) preserving keep-alive."""
                self.send_response(status)
                for k, v in headers.items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _drain_stream(self, req: CachedRequest):
                """Chunked streaming reply (stream_to): each queued buffer
                flushes to the socket as its own chunk, so the client sees
                tokens as they are produced; the 0-length terminator keeps
                the connection reusable."""
                self.send_response(200)
                for k, v in (req.stream_headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    while True:
                        try:
                            chunk = req.stream.get(
                                timeout=outer.handler_timeout)
                        except Empty:
                            # producer stalled without close(): abandon,
                            # and drop the connection so the unterminated
                            # chunked body can't poison keep-alive
                            self.close_connection = True
                            return
                        if chunk is None:
                            break
                        if chunk:
                            self.wfile.write(
                                f"{len(chunk):X}\r\n".encode() + chunk
                                + b"\r\n")
                            self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:  # client went away mid-stream
                    self.close_connection = True

            def log_message(self, *a):  # quiet
                pass

        # a deep listen backlog keeps admission control OURS: a connect
        # burst must reach the shed check (503 + Retry-After) instead of
        # dying in the kernel's SYN queue (ThreadingHTTPServer's default
        # request_queue_size is 5 — connection resets under any burst)
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name=f"serve-{name}", daemon=True
        )

    @property
    def service_info(self) -> ServiceInfo:
        h, p = self._httpd.server_address[:2]
        return ServiceInfo(self.name, h, p, self.path)

    def start(self):
        self._thread.start()

    def begin_drain(self):
        """Graceful-stop phase 1: new requests shed (503 + Retry-After)
        while already-accepted work keeps flowing to the consumer."""
        self._draining.set()

    def drained(self) -> bool:
        """Nothing queued and no held exchange waiting on a reply."""
        with self._routing_lock:
            held = any(not r.done.is_set() for r in self.routing.values())
        return self.queue.qsize() == 0 and not held

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def _finish(self, request_id: str):
        with self._routing_lock:
            self.routing.pop(request_id, None)

    def _admit(self, req: CachedRequest) -> bool:
        """Deadline gate at batch admission: an expired request is failed
        fast (504, no model compute) — the client's budget is already
        blown, computing the answer would only steal capacity from
        requests that can still make theirs."""
        if deadline_expired(req.deadline):
            telemetry.incr("serving.deadline_expired")
            self.reply_to(req.id, HTTPResponseData(
                504, "deadline exceeded", {"Content-Type": "application/json"},
                b'{"error": "deadline exceeded before processing"}'))
            return False
        return True

    def get_batch(self, max_batch: int, timeout_ms: float,
                  block: bool = True) -> List[CachedRequest]:
        """Drain up to max_batch requests; blocks up to timeout_ms for the
        first one (continuous-batching feed).  `block=False` drains only
        what is already queued (the microbatch-trigger feed).  Requests
        whose X-Deadline-Ms budget already expired are answered 504 here
        and never enter the batch."""
        out: List[CachedRequest] = []
        if block:
            stop_at = time.monotonic() + timeout_ms / 1000.0
            while not out:
                remaining = stop_at - time.monotonic()
                if remaining <= 0:
                    return out
                try:
                    req = self.queue.get(timeout=remaining)
                except Empty:
                    return out
                if self._admit(req):
                    out.append(req)
        while len(out) < max_batch:
            try:
                req = self.queue.get_nowait()
            except Empty:
                break
            if self._admit(req):
                out.append(req)
        return out

    def get_epoch_batch(self, max_batch: int, timeout_ms: float,
                        block: bool = True):
        """(epoch, batch): drain a batch and record it under a fresh epoch
        so an uncommitted consumer death can replay it (the reference's
        per-epoch requestQueues, HTTPSourceV2.scala:646-661)."""
        batch = self.get_batch(max_batch, timeout_ms, block=block)
        with self._epoch_lock:
            self.epoch += 1
            epoch = self.epoch
            if batch:
                self.history[epoch] = list(batch)
        return epoch, batch

    def commit(self, epoch: int):
        """Answered epochs need no replay: GC their history
        (HTTPSinkV2.scala:112 commit -> HTTPSourceV2 :555-567)."""
        with self._epoch_lock:
            for e in [e for e in self.history if e <= epoch]:
                del self.history[e]
        if self.journal is not None:
            self.journal.flush()  # reply lines become durable; may compact

    def recover(self, max_attempts: Optional[int] = None) -> int:
        """Replay every unanswered request of every uncommitted epoch
        (recoveredPartitions, HTTPSourceV2.scala:488-505,608-613).  Returns
        the number of requests requeued.  Answered requests in uncommitted
        epochs are dropped from history, not replayed twice.  With
        `max_attempts`, requests that already burned their retries are
        answered 500 instead of requeued — otherwise a poison batch that
        kills the consumer would crash-loop forever."""
        with self._epoch_lock:
            epochs = sorted(self.history)
            replay: List[CachedRequest] = []
            for e in epochs:
                replay.extend(r for r in self.history[e] if not r.done.is_set())
                del self.history[e]
        requeued = 0
        for req in replay:
            if max_attempts is not None and req.attempts + 1 >= max_attempts:
                self.reply_to(req.id, HTTPResponseData(
                    500, "consumer died", {},
                    b'{"error": "consumer died processing this request"}'))
            else:
                self.requeue(req)
                requeued += 1
        return requeued

    def requeue(self, req: CachedRequest):
        """Replay a failed request (historyQueues/recoveredPartitions)."""
        req.attempts += 1
        self.queue.put(req)

    def stream_to(self, request_id: str,
                  headers: Optional[Dict[str, str]] = None) -> "StreamWriter":
        """Open a chunked streaming reply over the held exchange — the
        token-by-token serving shape for generation (beyond-reference: the
        reference's replyTo is single-shot, HTTPSinkV2.scala:535-553).
        Returns a writer: `.write(bytes)` flushes one chunk to the client
        immediately, `.close()` ends the stream (and journals the reply).
        At-most-once: a crash mid-stream is the client's to retry."""
        with self._routing_lock:
            req = self.routing.pop(request_id, None)
        if req is None:
            raise KeyError(f"no held exchange for request {request_id!r}")
        # chunks of one in-flight reply, drained by the held HTTP
        # exchange as fast as the writer produces them
        req.stream = Queue()  # graftlint: disable=G403
        req.stream_headers = dict(headers or {})
        req.done.set()
        return StreamWriter(self, req)

    def reply_to(self, request_id: str, response: HTTPResponseData):
        """HTTPSinkV2 replyTo: answer over the held exchange."""
        with self._routing_lock:
            req = self.routing.pop(request_id, None)
        if req is not None:
            req.response = response
            req.done.set()
        if self.journal is not None:
            # journal the reply even when the exchange is gone (handler
            # 504 timeout popped it): the model DID process the request,
            # and an un-journaled reply would replay it after restart
            self.journal.log_reply(request_id)


class StreamWriter:
    """Handle returned by WorkerServer.stream_to: chunk sink for one held
    exchange.  Thread-safe hand-off via the request's queue; the handler
    thread owns the socket."""

    def __init__(self, server: WorkerServer, req: CachedRequest):
        self._server = server
        self._id = req.id
        self._req = req
        self._closed = False

    def write(self, data: bytes):
        if self._closed:
            raise ValueError(f"stream for {self._id!r} is closed")
        if self._req.handler_gone.is_set():
            # disconnect or handler timeout: fail the producer loop instead
            # of queueing tokens nobody will read
            raise BrokenPipeError(
                f"client for stream {self._id!r} is gone")
        self._req.stream.put(bytes(data))

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._req.stream.put(None)
        if self._server.journal is not None:
            self._server.journal.log_reply(self._id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def parse_request(batch: List[CachedRequest],
                  schema: Optional[List[str]] = None):
    """JSON request bodies -> columnar micro-batch (IOImplicits.parseRequest).

    Every body must be a JSON object; `schema` restricts/orders the columns.
    Returns (table, id_col): the routing-id column name is chosen to never
    collide with a body field (a client field named 'id' must not clobber
    reply routing).
    """
    from ..core.schema import find_unused_column_name

    rows = []
    for req in batch:
        try:
            rows.append(json.loads(req.request.entity or b"{}"))
        except json.JSONDecodeError:
            rows.append({})
    cols = schema or sorted({k for r in rows for k in r})
    id_col = find_unused_column_name("request_id", cols)
    data: Dict[str, Any] = {id_col: [r.id for r in batch]}
    for c in cols:
        vals = [r.get(c) for r in rows]
        try:
            data[c] = np.asarray(vals)
            if data[c].dtype.kind in "OSU" and not all(
                isinstance(v, str) for v in vals
            ):
                raise ValueError
        except (ValueError, TypeError):
            arr = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                arr[i] = v
            data[c] = arr
    return Table(data), id_col


def make_reply(table: Table, reply_col: str, server: WorkerServer,
               id_col: str = "request_id"):
    """Answer every row's held exchange with the reply column as JSON
    (IOImplicits.makeReply + HTTPSinkV2 write)."""
    ids = table[id_col]
    vals = table[reply_col]
    for i in range(len(table)):
        v = vals[i]
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, np.generic):
            v = v.item()
        body = json.dumps({reply_col: v}).encode("utf-8")
        server.reply_to(
            ids[i],
            HTTPResponseData(200, "OK",
                             {"Content-Type": "application/json"}, body),
        )


class ServingServer:
    """Turn any Transformer into a web service with continuous batching.

    Reference API surface: `spark.readStream.server(...).parseRequest ...
    .makeReply(col).writeStream.server()` (IOImplicits.scala:22-199); here
    the source-query-sink triple is one object.

    model: a Transformer whose transform consumes the parsed request columns
    and produces `reply_col`.

    Engine modes (the reference's trigger duality, SURVEY §2.4 #29):
      - "continuous": a long-running consumer blocks on the queue and drains
        opportunistic batches — the sub-ms path (HTTPSourceV2 continuous).
      - "microbatch": the consumer wakes every `trigger_interval_ms`, drains
        everything that arrived, processes, commits (HTTPSource V1 offsets-
        as-request-counts semantics).

    Every drained batch is an epoch recorded in the server's history;
    commit happens only after all replies are written, so a consumer death
    mid-batch replays the unanswered requests: a supervisor thread restarts
    the loop and calls `recover()` (the Spark task-retry analog).
    """

    def __init__(self, model, reply_col: Optional[str] = None,
                 name: str = "serving",
                 host: str = "127.0.0.1", port: int = 0, path: str = "/",
                 input_schema: Optional[List[str]] = None,
                 max_batch: int = 64, batch_timeout_ms: float = 10.0,
                 max_attempts: int = 2, mode: str = "continuous",
                 trigger_interval_ms: float = 20.0,
                 journal_path: Optional[str] = None,
                 stream_fn: Optional[Any] = None,
                 stream_workers: int = 8,
                 max_queue: Optional[int] = 1024,
                 drain_timeout_s: float = 5.0):
        if mode not in ("continuous", "microbatch"):
            raise ValueError("mode must be 'continuous' or 'microbatch'")
        if stream_fn is None and (model is None or reply_col is None):
            raise ValueError("need model + reply_col, or stream_fn")
        self.model = model
        self.reply_col = reply_col
        # streaming mode: per-request `fn(row) -> iterable of str/bytes`
        # chunks, delivered incrementally over the held exchange
        # (WorkerServer.stream_to).  At-most-once; runs on a pool
        # (`stream_workers` wide) so one slow generation doesn't stall
        # the intake loop.
        self.stream_fn = stream_fn
        self._stream_pool = (
            ThreadPoolExecutor(max_workers=int(stream_workers),
                               thread_name_prefix=f"stream-{name}")
            if stream_fn is not None else None)
        self.input_schema = input_schema
        self.max_batch = int(max_batch)
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.max_attempts = int(max_attempts)
        self.mode = mode
        self.trigger_interval_ms = float(trigger_interval_ms)
        # journal_path makes accepted requests durable across process
        # restarts: a fresh ServingServer at the same path replays every
        # journaled-but-unanswered request through the model
        self.journal = (EpochJournal(journal_path)
                        if journal_path is not None else None)
        self.drain_timeout_s = float(drain_timeout_s)
        self.server = WorkerServer(name, host, port, path,
                                   journal=self.journal,
                                   max_queue=max_queue)
        self._running = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._supervisor: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "recoveries": 0, "replayed": 0}

    @property
    def service_info(self) -> ServiceInfo:
        return self.server.service_info

    def _loop(self):
        while self._running.is_set():
            if self.mode == "microbatch":
                time.sleep(self.trigger_interval_ms / 1000.0)
                epoch, batch = self.server.get_epoch_batch(
                    self.max_batch, 0, block=False)
            else:
                epoch, batch = self.server.get_epoch_batch(
                    self.max_batch, self.batch_timeout_ms)
            telemetry.gauge("serving.queue.depth").set(
                self.server.queue.qsize())
            if not batch:
                self.server.commit(epoch)  # empty epochs GC immediately
                continue
            telemetry.histogram("serving.batch.fill").observe(
                len(batch) / max(1, self.max_batch))
            now = time.monotonic()
            for req in batch:
                # attribute each request's queue wait back onto ITS trace:
                # the handler thread's serving.request span is the parent
                if req.trace is not None and req.accepted_at is not None:
                    telemetry.record_span("serving.batcher.queue",
                                          req.trace, now - req.accepted_at)
            # the batch span continues the first traced request's context
            # across the thread hop (a batch serves many traces; the rest
            # keep their queue-wait spans above)
            batch_ctx = next((r.trace for r in batch if r.trace), None)
            with telemetry.use_trace(batch_ctx), \
                    telemetry.span("serving.batcher.batch",
                                   batch_size=len(batch), epoch=epoch):
                # chaos hook: an InjectedCrash here escapes except Exception
                # below and kills the consumer thread mid-batch — exactly the
                # death the supervisor + epoch replay must absorb (the batch
                # is already recorded in the epoch history)
                fault_point("serving.batch_loop")
                if self.stream_fn is not None:
                    # rows come straight from each request's JSON body: the
                    # columnar parse would coerce types batch-dependently (a
                    # lone list becomes an ndarray slice; co-batched ragged
                    # lists stay lists) — stream_fn must see stable types
                    for req in batch:
                        if req.recovered:
                            # a journal-replayed stream has NO client socket:
                            # generating into it would be pure waste.  Streams
                            # are at-most-once; mark replied and move on.
                            self.server.reply_to(req.id, HTTPResponseData(
                                410, "client gone across restart"))
                            continue
                        try:
                            row = json.loads(req.request.entity or b"{}")
                        except json.JSONDecodeError:
                            row = {}
                        if self.input_schema is not None:
                            row = {k: row.get(k) for k in self.input_schema}
                        self._stream_pool.submit(self._stream_one, req.id,
                                                 row, req.trace)
                    self.stats["requests"] += len(batch)
                    self.stats["batches"] += 1
                    self.server.commit(epoch)  # at-most-once past this point
                    continue
                try:
                    table, id_col = parse_request(batch, self.input_schema)
                    out = self.model.transform(table)
                    make_reply(out, self.reply_col, self.server,
                               id_col=id_col)
                    self.stats["requests"] += len(batch)
                    self.stats["batches"] += 1
                    self.server.commit(epoch)
                except Exception as e:  # noqa: BLE001 — serving must survive
                    self.stats["errors"] += 1
                    for req in batch:
                        if req.done.is_set():
                            continue  # make_reply answered it before failing
                        if req.attempts + 1 < self.max_attempts:
                            self.server.requeue(req)
                        else:
                            self.server.reply_to(
                                req.id,
                                HTTPResponseData(
                                    500, "model error", {},
                                    json.dumps({"error": str(e)}).encode(),
                                ),
                            )
                    self.server.commit(epoch)  # history done

    def _stream_one(self, request_id: str, row: Dict[str, Any],
                    trace: Optional[Tuple[str, str]] = None):
        """Produce one request's chunk stream on the pool.

        The chunked exchange opens only once the FIRST chunk exists: a
        stream_fn that fails before producing anything still gets a real
        HTTP 500 (the status line isn't spent yet).  An error after the
        first chunk can only be reported in-band; BrokenPipeError means
        the client left — stop generating."""
        with telemetry.use_trace(trace):
            self._stream_one_traced(request_id, row)

    def _stream_one_traced(self, request_id: str, row: Dict[str, Any]):
        def enc(c):
            return c.encode("utf-8") if isinstance(c, str) else c

        try:
            it = iter(self.stream_fn(row))
            first = next(it, None)
        except Overloaded as e:
            # bounded-intake rejection (e.g. ContinuousBatcher.submit with
            # max_pending): shed, don't error — clients retry 503s
            telemetry.incr("serving.shed")
            self.server.reply_to(request_id, HTTPResponseData(
                503, "overloaded", {"Retry-After": "1",
                                    "Content-Type": "application/json"},
                json.dumps({"error": str(e)}).encode()))
            return
        except Exception as e:  # noqa: BLE001 — pre-stream failure: real 500
            self.stats["errors"] += 1
            self.server.reply_to(request_id, HTTPResponseData(
                500, "stream error", {},
                json.dumps({"error": str(e)}).encode()))
            return
        try:
            writer = self.server.stream_to(
                request_id,
                headers={"Content-Type": "text/plain; charset=utf-8"})
        except KeyError:
            return  # handler timed out and dropped the exchange
        try:
            if first is not None:
                writer.write(enc(first))
            for chunk in it:
                writer.write(enc(chunk))
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — serving must survive
            self.stats["errors"] += 1
            try:
                writer.write(json.dumps({"error": str(e)}).encode())
            except BrokenPipeError:
                pass
        finally:
            writer.close()

    def _supervise(self):
        """Restart a dead consumer and replay its uncommitted epochs —
        the Spark task-retry + recoveredPartitions path."""
        while self._running.is_set():
            time.sleep(0.05)
            if self._running.is_set() and not self._worker.is_alive():
                self.stats["recoveries"] += 1
                self.stats["replayed"] += self.server.recover(self.max_attempts)
                self._worker = threading.Thread(
                    target=self._loop, daemon=True, name="serving-batch-loop")
                self._worker.start()

    def start(self) -> ServiceInfo:
        self.server.start()
        self._running.set()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-batch-loop")
        self._worker.start()
        self._supervisor = threading.Thread(target=self._supervise, daemon=True,
                                            name="serving-supervisor")
        self._supervisor.start()
        return self.service_info

    def stop(self, drain: bool = True):
        """Graceful by default: shed new arrivals (503 + Retry-After),
        let the consumer answer everything already accepted (bounded by
        `drain_timeout_s`), then tear the threads down.  `drain=False`
        is the hard stop (process-death simulation; the journal replays
        what was lost)."""
        if drain and self._running.is_set():
            self.server.begin_drain()
            stop_at = time.monotonic() + self.drain_timeout_s
            while time.monotonic() < stop_at and not self.server.drained():
                time.sleep(0.01)
        self._running.clear()
        if self._worker is not None:
            self._worker.join(timeout=5)
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        if self._stream_pool is not None:
            # don't wait on in-flight generations: their writers fail fast
            # once the handlers go away, and queued tasks are cancelled so
            # non-daemon pool threads can't block interpreter exit
            self._stream_pool.shutdown(wait=False, cancel_futures=True)
        self.server.stop()
        if self.journal is not None:
            self.journal.close()
