"""Model serving: embedded per-host HTTP servers, continuous batching for
autoregressive decode, and the fleet above them.

Counterpart of the JAX package's `serving/`: `ServingServer` /
`WorkerServer` (the held-exchange HTTP server with epoch replay and an
optional request journal), the `read_stream()` DSL with its one-call LM
endpoint `generate_stream` and its multi-replica form
`distributed_server` / `DistributedServingServer`, and
`ContinuousBatcher` (dense or paged KV slots, int8 caches, shared
prefixes, deadlines and load shedding).

Fleet layer: `ServiceRegistry` (discovery), `FleetGateway` routing across
replica pools (p2c balancing, deadline decrement, retry, breaker
ejection + probe reinstatement), `RolloutController` (metrics-gated
canaries), `FleetTelemetry` (federated ``/fleet/metrics``, a stitched
``/trace/<id>``, SLO burn-rate alerts) and `AutoscaleController`
(replica counts from the merged signals).
"""
from .autoscale import AutoscaleController, CapacityModel
from .batcher import ContinuousBatcher, TokenStream
from .dsl import DistributedServingServer, StreamingQuery, StreamReader, read_stream
from .fleet import FleetGateway, FleetTelemetry, Replica
from .journal import EpochJournal
from .registry import (
    ServiceRegistry,
    deregister_service,
    list_services,
    register_service,
)
from .rollout import ROLLOUT_METRICS, RolloutController, drain_and_stop
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
    "ServiceRegistry",
    "register_service",
    "deregister_service",
    "list_services",
    "parse_request",
    "make_reply",
    "read_stream",
    "StreamReader",
    "StreamingQuery",
    "DistributedServingServer",
    "FleetGateway",
    "FleetTelemetry",
    "Replica",
    "RolloutController",
    "ROLLOUT_METRICS",
    "drain_and_stop",
    "AutoscaleController",
    "CapacityModel",
]
