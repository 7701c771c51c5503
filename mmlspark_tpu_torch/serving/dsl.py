"""Streaming DSL: the `readStream.server ... makeReply ... writeStream`
surface.

Reference: io/IOImplicits.scala:22-199 —

    spark.readStream.server(host, port, api)       (HTTPSource, microbatch)
         .continuousServer(...)                    (HTTPSourceV2 continuous)
    df.parseRequest(apiName, schema)
      .mlTransform(model)
      .makeReply(col)
      .writeStream.server(...).start()

The source/query/sink triple builds a `ServingServer`, so the fluent
chain configures what `start()` launches:

    query = (read_stream()
             .continuous_server(host, port, name="lm", path="/lm")
             .parse_request(schema=["prompt"])
             .generate_stream(bundle, max_new_tokens=32, paged=True)
             .start())
    query.service_info.url -> POST {"prompt": [ids...]} here
    query.stop()

Counterpart of the JAX package's `serving/dsl.py`; `generate_stream`
takes a `TorchBundle` (and a `device`, ``cuda`` by default).
`distributed_server(replicas=k)` starts k servers in this process that
share the model — with `generate_stream`, one `ContinuousBatcher` over
one copy of the bundle — the per-JVM shared-server round robin of
DistributedHTTPSource.scala:39-426, and registers every replica with an
optional `ServiceRegistry` for discovery (DriverServiceUtils :133-194);
a `FleetGateway` routes over them.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

from ..core.pipeline import LambdaTransformer, Transformer
from .registry import register_service
from .server import ServiceInfo, ServingServer

__all__ = ["read_stream", "StreamReader", "StreamingQuery",
           "DistributedServingServer"]


class StreamingQuery:
    """A started serving pipeline (the StreamingQuery analog)."""

    def __init__(self, servers: List[ServingServer], on_stop=()):
        self._servers = servers
        self._on_stop = list(on_stop)

    @property
    def service_info(self) -> ServiceInfo:
        return self._servers[0].service_info

    @property
    def service_infos(self) -> List[ServiceInfo]:
        return [s.service_info for s in self._servers]

    @property
    def stats(self) -> dict:
        agg: dict = {}
        for s in self._servers:
            for k, v in s.stats.items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def is_active(self) -> bool:
        return any(s._running.is_set() for s in self._servers)

    def stop(self) -> None:
        for s in self._servers:
            s.stop()
        for fn in self._on_stop:
            fn()


class StreamReader:
    """Fluent builder; every method returns self until `start()`."""

    def __init__(self):
        self._host = "127.0.0.1"
        self._port = 0
        self._name = "serving"
        self._path = "/"
        self._mode = "continuous"
        self._schema: Optional[List[str]] = None
        self._model: Optional[Transformer] = None
        self._reply_col: Optional[str] = None
        self._max_batch = 64
        self._batch_timeout_ms = 10.0
        self._trigger_interval_ms = 20.0
        self._journal_path: Optional[str] = None
        self._stream_fn = None
        self._gen_cfg = None
        self._stream_workers = 8
        self._replicas = 1
        self._registry_url: Optional[str] = None

    # ---- sources (IOImplicits server/distributedServer/continuousServer)
    def server(self, host: str = "127.0.0.1", port: int = 0,
               name: str = "serving", path: str = "/") -> "StreamReader":
        """Head-node microbatch server (HTTPSource V1 semantics)."""
        self._host, self._port, self._name, self._path = host, port, name, path
        self._mode = "microbatch"
        return self

    def continuous_server(self, host: str = "127.0.0.1", port: int = 0,
                          name: str = "serving", path: str = "/"
                          ) -> "StreamReader":
        """Continuous-batching server (HTTPSourceV2 continuous mode)."""
        self._host, self._port, self._name, self._path = host, port, name, path
        self._mode = "continuous"
        return self

    def distributed_server(self, host: str = "127.0.0.1", port: int = 0,
                           name: str = "serving", path: str = "/",
                           replicas: int = 2,
                           registry_url: Optional[str] = None
                           ) -> "StreamReader":
        """N per-process servers sharing the model (DistributedHTTPSource's
        per-JVM shared servers); replicas register with the registry for
        discovery.  A fixed port only makes sense for one replica."""
        if replicas > 1 and port != 0:
            raise ValueError("distributed_server with replicas > 1 needs "
                             "port=0 (each replica binds its own)")
        self._host, self._port, self._name, self._path = host, port, name, path
        self._mode = "continuous"
        self._replicas = int(replicas)
        self._registry_url = registry_url
        return self

    # ---- query ---------------------------------------------------------
    def parse_request(self, schema: Optional[Sequence[str]] = None
                      ) -> "StreamReader":
        self._schema = list(schema) if schema is not None else None
        return self

    def transform(self, model: Union[Transformer, Callable]) -> "StreamReader":
        if not isinstance(model, Transformer):
            model = LambdaTransformer(model)
        self._model = model
        return self

    def make_reply(self, reply_col: str) -> "StreamReader":
        self._reply_col = reply_col
        return self

    def stream_reply(self, fn) -> "StreamReader":
        """Streaming sink (replaces transform+make_reply): `fn(row) ->
        iterable of str/bytes` chunks, flushed to the client as produced —
        the token-by-token generation shape.  At-most-once delivery."""
        self._stream_fn = fn
        self._gen_cfg = None   # the sinks are mutually exclusive
        return self

    def generate_stream(self, bundle, tokenizer=None,
                        max_new_tokens: int = 32, max_slots: int = 8,
                        kv_cache_dtype=None,
                        paged: bool = False, page_size: int = 64,
                        num_pages=None, draft_model=None, gamma: int = 4,
                        device=None) -> "StreamReader":
        """The whole LM endpoint in one call: a ContinuousBatcher over
        `bundle` owns the decode (concurrent clients share one slotted
        device step) and stops with the query.  With a `tokenizer`
        (encode/decode/eos_id), requests post {"prompt": "<text>"} and
        stream decoded text chunks; without one, {"prompt": [ids...]}
        streams token ids.  The batcher is built PER start() call, so a
        builder can start several independent queries.  `paged=True`
        serves from page pools (pay-per-page KV memory, the paged decode
        kernel on the card); `draft_model`, a TransformerLM bundle, turns
        on speculative continuous batching (up to gamma + 1 tokens a slot
        a target forward, the streams still exactly the target's)."""
        self._gen_cfg = dict(bundle=bundle, tokenizer=tokenizer,
                             max_new_tokens=int(max_new_tokens),
                             max_slots=int(max_slots),
                             kv_cache_dtype=kv_cache_dtype,
                             paged=bool(paged), page_size=int(page_size),
                             num_pages=num_pages, draft_model=draft_model,
                             gamma=int(gamma), device=device)
        self._stream_fn = None
        return self

    def options(self, max_batch: Optional[int] = None,
                batch_timeout_ms: Optional[float] = None,
                trigger_interval_ms: Optional[float] = None,
                journal_path: Optional[str] = None,
                stream_workers: Optional[int] = None) -> "StreamReader":
        """journal_path is the `checkpointLocation` analog: accepted
        requests survive process restart (replicas > 1 each get their own
        `<path>-<replica>` file).  stream_workers sizes the stream_reply
        producer pool (concurrent generations per replica)."""
        if max_batch is not None:
            self._max_batch = int(max_batch)
        if batch_timeout_ms is not None:
            self._batch_timeout_ms = float(batch_timeout_ms)
        if trigger_interval_ms is not None:
            self._trigger_interval_ms = float(trigger_interval_ms)
        if journal_path is not None:
            self._journal_path = journal_path
        if stream_workers is not None:
            self._stream_workers = int(stream_workers)
        return self

    # ---- sink ----------------------------------------------------------
    def start(self) -> StreamingQuery:
        if (self._stream_fn is None and self._gen_cfg is None and (
                self._model is None or self._reply_col is None)):
            raise ValueError("streaming query needs .transform(model) and "
                             ".make_reply(col) — or .stream_reply(fn) / "
                             ".generate_stream(...) — before start()")
        batcher = None
        stream_fn = self._stream_fn
        if self._gen_cfg is not None:
            from .batcher import ContinuousBatcher

            cfg = self._gen_cfg
            # generate_stream populates every key; defaults live THERE
            batcher = ContinuousBatcher(
                cfg["bundle"], max_slots=cfg["max_slots"],
                kv_cache_dtype=cfg["kv_cache_dtype"], paged=cfg["paged"],
                page_size=cfg["page_size"], num_pages=cfg["num_pages"],
                draft_model=cfg["draft_model"], gamma=cfg["gamma"],
                device=cfg["device"])

            def stream_fn(row, _b=batcher, _c=cfg):
                if _c["tokenizer"] is not None:
                    yield from _b.stream_text(_c["tokenizer"],
                                              str(row["prompt"]),
                                              _c["max_new_tokens"])
                else:
                    for tok in _b.submit([int(t) for t in row["prompt"]],
                                         _c["max_new_tokens"]):
                        yield f"{tok} "

        servers = []
        for r in range(self._replicas):
            srv = ServingServer(
                model=self._model, reply_col=self._reply_col,
                stream_fn=stream_fn,
                stream_workers=self._stream_workers,
                name=self._name if self._replicas == 1
                else f"{self._name}-{r}",
                host=self._host, port=self._port, path=self._path,
                input_schema=self._schema, max_batch=self._max_batch,
                batch_timeout_ms=self._batch_timeout_ms, mode=self._mode,
                trigger_interval_ms=self._trigger_interval_ms,
                journal_path=(None if self._journal_path is None
                              else self._journal_path if self._replicas == 1
                              else f"{self._journal_path}-{r}"))
            info = srv.start()
            if self._registry_url:
                register_service(self._registry_url,
                                 ServiceInfo(self._name, info.host,
                                             info.port, info.path))
            servers.append(srv)
        on_stop = []
        if batcher is not None:
            batcher.start()
            on_stop.append(batcher.stop)
        query = StreamingQuery(servers, on_stop=on_stop)
        query._batcher = batcher   # observability (tests, diagnostics)
        return query


def read_stream() -> StreamReader:
    """Entry point mirroring `spark.readStream` (IOImplicits.scala:22)."""
    return StreamReader()


class DistributedServingServer:
    """Convenience wrapper: N replicas + a registry in one object."""

    def __init__(self, model, reply_col: str, name: str = "serving",
                 path: str = "/", replicas: int = 2, registry=None,
                 **options):
        from .registry import ServiceRegistry

        self._own_registry = registry is None
        self._registry_started = False
        self.registry = registry or ServiceRegistry()
        self._builder = (read_stream()
                         .distributed_server(name=name, path=path,
                                             replicas=replicas)
                         .transform(model)
                         .make_reply(reply_col)
                         .options(**options))
        self.query: Optional[StreamingQuery] = None

    def start(self) -> List[ServiceInfo]:
        if self.query is not None:
            raise RuntimeError("DistributedServingServer already started")
        if self._own_registry:
            self.registry.start()
            self._registry_started = True
        self._builder._registry_url = self.registry.url
        self.query = self._builder.start()
        return self.query.service_infos

    def stop(self):
        if self.query is not None:
            self.query.stop()
            self.query = None
        # shutting down a never-started ThreadingHTTPServer deadlocks
        # (socketserver waits on serve_forever's event): only stop what ran
        if self._own_registry and self._registry_started:
            self.registry.stop()
            self._registry_started = False
