"""Model serving: an embedded per-host HTTP server and continuous
batching for autoregressive decode.

Counterpart of the JAX package's `serving/`: `ServingServer` /
`WorkerServer` (the held-exchange HTTP server with epoch replay and an
optional request journal), the `read_stream()` DSL with its one-call LM
endpoint `generate_stream`, and `ContinuousBatcher` (dense or paged KV
slots, int8 caches, shared prefixes, deadlines and load shedding).  The
fleet, registry, rollout and autoscale layers and
`DistributedServingServer` are not ported yet (ROADMAP A15).
"""
from .batcher import ContinuousBatcher, TokenStream
from .dsl import DistributedServingServer, StreamingQuery, StreamReader, read_stream
from .journal import EpochJournal
from .server import (
    CachedRequest,
    ServiceInfo,
    ServingServer,
    StreamWriter,
    WorkerServer,
    make_reply,
    parse_request,
)

__all__ = [
    "ContinuousBatcher",
    "TokenStream",
    "EpochJournal",
    "ServingServer",
    "WorkerServer",
    "StreamWriter",
    "CachedRequest",
    "ServiceInfo",
    "parse_request",
    "make_reply",
    "read_stream",
    "StreamReader",
    "StreamingQuery",
    "DistributedServingServer",
]
