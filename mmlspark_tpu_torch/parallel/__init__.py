"""The port's parallelism: device meshes and partition rules over
`torch.distributed` / DTensor, sequence-parallel attention, the GPipe
schedule, and the elastic multi-process runtime (SPMD: one process per
rank; see parallel/mesh.py)."""
from .mesh import (
    MESH_AXIS_NAMES,
    MeshContext,
    MeshPlan,
    batch_sharding,
    default_mesh,
    host_device_groups,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from .distributed import (
    DIST_FAULT_POINTS,
    CollectiveTimeout,
    ElasticContext,
    HeartbeatMonitor,
    HostInfo,
    HostTelemetryServer,
    MembershipStore,
    MembershipView,
    RendezvousError,
    StaleMembershipError,
    barrier,
    initialize_distributed,
    is_coordinator,
    local_host_info,
    run_with_deadline,
)
from .sharding_rules import (
    PARAM_PATH_MANIFEST,
    match_partition_rules,
    validate_coverage,
    validate_rules,
)
