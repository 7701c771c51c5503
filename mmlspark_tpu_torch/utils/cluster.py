"""Cluster/device topology: the ClusterUtil analog.

Counterpart of the JAX package's `utils/cluster.py`, read off
`torch.distributed` and `torch.cuda` instead of the jax runtime.  The
port runs SPMD: one process per rank, one device per rank
(parallel/mesh.py).  So a rank is the unit the JAX package calls a
device, its process is the rank itself, and the "slice" — the group of
devices joined by the fast interconnect, ICI on a TPU pod — is the host:
the ranks of one machine share NVLink, ranks on different machines talk
over the network (the DCN of a pod).  `make_mesh(dcn_data=...)` keeps
the data axis outermost across hosts, as the JAX package keeps it
across slices.

Reference: core/utils/ClusterUtil.scala:20-175 infers #executors, tasks per
executor, and the driver host from SparkConf/BlockManager to size LightGBM/VW
communication rings.
"""
from __future__ import annotations

import dataclasses
import socket
from typing import List

import numpy as np

__all__ = ["ClusterInfo", "cluster_info", "get_num_shards", "DeviceInfo",
           "DeviceTopology", "device_topology", "process_mesh_placement",
           "find_open_port"]


def _dist():
    """`torch.distributed` when a process group is up, else None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    platform: str
    host: str

    @property
    def is_distributed(self) -> bool:
        return self.process_count > 1

    @property
    def devices_per_process(self) -> int:
        return self.global_device_count // max(self.process_count, 1)


def cluster_info() -> ClusterInfo:
    """This rank's place in the job.  Inside a process group: its rank and
    the world size, one device a rank, and the platform its backend
    drives (`nccl` -> cuda, else cpu).  Outside one: a single process
    over the local cards (or the CPU when there is none)."""
    import torch

    dist = _dist()
    if dist is not None:
        world = dist.get_world_size()
        platform = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return ClusterInfo(process_index=dist.get_rank(),
                           process_count=world, local_device_count=1,
                           global_device_count=world, platform=platform,
                           host=socket.gethostname())
    n = torch.cuda.device_count()
    return ClusterInfo(process_index=0, process_count=1,
                       local_device_count=max(n, 1),
                       global_device_count=max(n, 1),
                       platform="cuda" if n else "cpu",
                       host=socket.gethostname())


def get_num_shards() -> int:
    """Number of data shards to split work into (== global devices): the
    world size inside a process group, else the local card count (1 on
    a machine without one)."""
    return cluster_info().global_device_count


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """One device's place in the job (ClusterUtil.scala's executor/task
    inference, rebuilt from the torch runtime): `id` is the rank,
    `process_index` the rank's process (the rank itself), `slice_index`
    the host it runs on."""

    id: int
    process_index: int
    slice_index: int
    coords: tuple  # interconnect coordinates; () on every CUDA host


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Hosts-per-slice / devices-per-host map of the running job.

    Reference: ClusterUtil.getNumExecutorTasks/getNumTasksPerExecutor
    (core/utils/ClusterUtil.scala:20-175) sized the LightGBM/VW rings from
    SparkConf; here ring sizing IS the mesh, and this is the placement
    oracle `make_mesh` uses to keep network-crossing axes outermost.
    """

    devices: tuple  # DeviceInfo, in rank order

    @property
    def num_slices(self) -> int:
        return len({d.slice_index for d in self.devices})

    @property
    def num_hosts(self) -> int:
        return len({d.process_index for d in self.devices})

    @property
    def devices_per_host(self) -> int:
        return len(self.devices) // max(self.num_hosts, 1)

    @property
    def hosts_per_slice(self) -> int:
        return self.num_hosts // max(self.num_slices, 1)

    def slice_groups(self) -> "List[List[int]]":
        """Device ordinals (into the constructing device list) grouped by
        slice, slice-major — the network-outermost ordering."""
        groups: dict = {}
        for i, d in enumerate(self.devices):
            groups.setdefault(d.slice_index, []).append(i)
        return [groups[s] for s in sorted(groups)]

    def local_ordinals(self, process_index: int) -> "List[int]":
        """This process's device ordinals (local feed placement)."""
        return [i for i, d in enumerate(self.devices)
                if d.process_index == process_index]


def device_topology(devices=None) -> DeviceTopology:
    """The topology of the running job: inside a process group one
    DeviceInfo a rank, its slice the index of its host among the hosts
    (an `all_gather_object` of host names, so every rank must call it);
    outside one, the local cards (or the CPU) of this single process,
    one slice.  `devices` (a list of ranks) restricts it to those."""
    dist = _dist()
    if dist is not None:
        names: list = [None] * dist.get_world_size()
        dist.all_gather_object(names, socket.gethostname())
        hosts = sorted(set(names), key=names.index)
        ranks = list(range(len(names))) if devices is None else \
            [int(r) for r in devices]
        infos = [DeviceInfo(id=r, process_index=r,
                            slice_index=hosts.index(names[r]), coords=())
                 for r in ranks]
    else:
        n = cluster_info().global_device_count
        ranks = list(range(n)) if devices is None else \
            [int(r) for r in devices]
        infos = [DeviceInfo(id=r, process_index=0, slice_index=0, coords=())
                 for r in ranks]
    return DeviceTopology(devices=tuple(infos))


def process_mesh_placement(mesh) -> dict:
    """process_index -> list of mesh index tuples owned by that process —
    where each rank's data feed lands on the mesh (a `DeviceMesh`, or a
    `MeshPlan` / anything with a `.mesh`).  A rank is its own process, so
    every rank owns exactly one coordinate."""
    mesh = mesh if hasattr(mesh, "mesh_dim_names") else mesh.mesh
    arr = np.asarray(mesh.mesh.cpu())
    placement: dict = {}
    for idx in np.ndindex(arr.shape):
        placement.setdefault(int(arr[idx]), []).append(idx)
    return placement


def find_open_port(start: int = 12400, tries: int = 200) -> int:
    """Port scan from a base — reference lightgbm/TrainUtils.scala:193-220."""
    for p in range(start, start + tries):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("", p))
                return p
            except OSError:
                continue
    raise OSError(f"no open port in [{start}, {start + tries})")
