"""Device mesh management: the port's parallelism substrate.

Counterpart of the JAX package's `parallel/mesh.py`.  The JAX package is
single-controller: one process sees every device and `shard_map` /
`NamedSharding` place the work.  The port is SPMD, the PyTorch idiom:
one process per rank over `torch.distributed`, each rank driving ONE
device, and a `torch.distributed.device_mesh.DeviceMesh` over the ranks
with the same named axes:

    data    — batch/data parallel
    model   — tensor parallel (megatron pairing)
    seq     — sequence/context parallel (ring / Ulysses attention)
    pipe    — pipeline stages (GPipe)

Every function here runs on every rank of the group (SPMD): the mesh is
built collectively, and each rank reads its own coordinate from it.  A
"device" of the JAX package's signatures is a rank here (`devices=` is
a list of ranks, default: the whole world).

Where it runs: on `cuda` with the `nccl` backend unless the caller passes
``device="cpu"``, which selects `gloo`; without a card the cuda default
raises (models.device.resolve_device).  A process group that is already
up must run the backend the device needs — nothing falls from nccl to
gloo.  Without one, the mesh functions start a single-process group
(world size 1) over a loopback TCP store.  NCCL refuses two ranks on
one card, so on one H100 every group has world size 1; more ranks run
on the CPU under gloo (the tests spawn up to 4).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .sharding_rules import P, distribute, placements

__all__ = [
    "MESH_AXIS_NAMES",
    "as_device_mesh",
    "ensure_process_group",
    "make_mesh",
    "MeshPlan",
    "default_mesh",
    "MeshContext",
    "NamedSharding",
    "batch_sharding",
    "replicated_sharding",
    "addressable_shard_layout",
    "host_device_groups",
    "shard_batch",
    "pad_to_multiple",
    "data_size",
]

# Every axis name a mesh in this package may declare (the JAX package's
# tuple, copied); sharding_rules.validate_rules checks specs against it.
MESH_AXIS_NAMES = ("data", "model", "seq", "pipe")

_CURRENT: Dict[str, object] = {"mesh": None}


def as_device_mesh(mesh):
    """The `DeviceMesh` of a DeviceMesh or of a MeshPlan."""
    return mesh if hasattr(mesh, "mesh_dim_names") else mesh.mesh


def _backend_for(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def ensure_process_group(device=None) -> torch.device:
    """The device this rank drives, with a process group running the
    backend it needs: the existing group (which must run that backend —
    a gloo group asked for cuda raises, and so does the reverse), else a
    new single-process group over a loopback TCP store.  On cuda the
    rank's card (`rank % device_count`) becomes the current device."""
    import torch.distributed as dist

    from ..utils.cluster import find_open_port

    dev = resolve_device(device)
    backend = _backend_for(dev)
    if dist.is_initialized():
        have = str(dist.get_backend())
        if backend not in have:
            raise RuntimeError(
                f"the process group runs {have!r} and {dev.type} needs "
                f"{backend!r}: start the group for the device the mesh "
                "runs on (nothing falls back from nccl to gloo)")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{find_open_port()}",
            rank=0, world_size=1)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            dist.get_rank() % torch.cuda.device_count()
        torch.cuda.set_device(idx)
        dev = torch.device("cuda", idx)
    return dev


def _device_mesh(dev: torch.device, ranks: np.ndarray, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=tuple(names))


def _world_ranks(devices) -> List[int]:
    import torch.distributed as dist

    if devices is None:
        return list(range(dist.get_world_size()))
    return [int(getattr(d, "id", d)) for d in devices]


def make_mesh(
    data: int = -1,
    model: int = 1,
    seq: int = 1,
    devices: Optional[Sequence] = None,
    dcn_data: int = 1,
    device=None,
):
    """Build a (data, model, seq) `DeviceMesh`.  `data=-1` absorbs the
    remaining ranks.  Collective: every rank of the group calls it.

    `dcn_data` > 1 declares a multi-host layout: the data axis's leading
    `dcn_data` blocks each live on one host, so only data-parallel
    collectives cross the network while model/seq collectives stay on
    NVLink (placement from utils.cluster.device_topology).  When the job
    runs on fewer hosts than requested (every rank on one machine), the
    ranks are grouped into `dcn_data` contiguous virtual hosts so the
    layout is still exercised."""
    n = len(devices) if devices is not None else None
    if n is not None:
        _check_shape(n, data, model, seq, dcn_data)
    dev = ensure_process_group(device)
    ranks = _world_ranks(devices)
    # a mesh is built once a group: every rank makes the same calls, so
    # the cache hits (or misses, collectively) on all of them alike
    key = (dev.type, tuple(ranks), data, model, seq, dcn_data)
    group = _default_group()
    hit = _MESHES.get(key)
    if hit is not None and hit[0] is group:
        return hit[1]
    mesh = _make_mesh(dev, ranks, data, model, seq, dcn_data)
    _MESHES[key] = (group, mesh)
    return mesh


def _default_group():
    import torch.distributed.distributed_c10d as c10d

    return c10d._get_default_group()


# (device type, ranks, shape) -> (the default group it was built in, mesh)
_MESHES: Dict[tuple, tuple] = {}


def _make_mesh(dev, ranks, data, model, seq, dcn_data):
    data = _check_shape(len(ranks), data, model, seq, dcn_data)
    if dcn_data > 1:
        from ..utils.cluster import device_topology

        topo = device_topology(ranks)
        if topo.num_slices == dcn_data:
            groups = topo.slice_groups()
        elif topo.num_slices <= 1:
            per = len(ranks) // dcn_data
            groups = [list(range(g * per, (g + 1) * per))
                      for g in range(dcn_data)]
        else:
            # a real multi-host job with a mismatched request must not be
            # silently laid out across host boundaries
            raise ValueError(
                f"dcn_data={dcn_data} does not match the runtime's "
                f"{topo.num_slices} slices")
        if len({len(g) for g in groups}) != 1:
            raise ValueError("unequal slice sizes cannot form a mesh")
        ranks = [ranks[i] for g in groups for i in g]
    arr = np.asarray(ranks).reshape(data, model, seq)
    return _device_mesh(dev, arr, ("data", "model", "seq"))


def _check_shape(n: int, data: int, model: int, seq: int,
                 dcn_data: int) -> int:
    if data == -1:
        if n % (model * seq) != 0:
            raise ValueError(
                f"{n} devices not divisible by model*seq={model * seq}")
        data = n // (model * seq)
    if data * model * seq != n:
        raise ValueError(f"mesh {data}x{model}x{seq} != {n} devices")
    if dcn_data > 1 and data % dcn_data != 0:
        raise ValueError(f"data={data} not divisible by dcn_data={dcn_data}")
    return data


class MeshPlan:
    """One (data, model, pipe) layout for the 3D trainer: D-way data
    parallelism x T-way megatron tensor parallelism x P-way GPipe
    pipeline parallelism on ONE `DeviceMesh` (`.mesh`), the substrate of
    `models.training.make_lm_train_step_3d`.

    ``data=-1`` absorbs the remaining ranks; ``d*t*p`` must equal the
    rank count.  The axis names are the plan's contract with every
    partition-rule table — `validate_specs` checks a table against them.
    `devices` (ranks) is validated before any collective; the mesh
    itself is built collectively on `device` (cuda unless "cpu")."""

    AXES = ("data", "model", "pipe")

    def __init__(self, data: int = -1, model: int = 1, pipe: int = 1,
                 devices: Optional[Sequence] = None, device=None):
        if model < 1 or pipe < 1:
            raise ValueError(f"model={model} and pipe={pipe} must be >= 1")
        if devices is not None:
            data = self._resolve(len(devices), data, model, pipe)
        dev = ensure_process_group(device)
        ranks = _world_ranks(devices)
        data = self._resolve(len(ranks), data, model, pipe)
        self.data, self.model, self.pipe = int(data), int(model), int(pipe)
        self.device = dev
        arr = np.asarray(ranks).reshape(self.data, self.model, self.pipe)
        self.mesh = _device_mesh(dev, arr, self.AXES)

    @staticmethod
    def _resolve(n: int, data: int, model: int, pipe: int) -> int:
        if data == -1:
            if n % (model * pipe) != 0:
                raise ValueError(
                    f"{n} devices not divisible by model*pipe="
                    f"{model * pipe}")
            data = n // (model * pipe)
        if data * model * pipe != n:
            raise ValueError(
                f"mesh plan {data}x{model}x{pipe} != {n} devices")
        return data

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model, "pipe": self.pipe}

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's (data, model, pipe) coordinate."""
        c = self.mesh.get_coordinate()
        return dict(zip(self.AXES, c))

    def group(self, axis: str):
        """This rank's process group along `axis`."""
        return self.mesh.get_group(axis)

    def validate_specs(self, rules) -> None:
        """Raise if any rule's spec names an axis this plan's mesh does
        not declare."""
        from .sharding_rules import validate_rules

        validate_rules(rules, self.AXES)

    def __repr__(self) -> str:
        return (f"MeshPlan(data={self.data}, model={self.model}, "
                f"pipe={self.pipe})")


def default_mesh(device=None):
    """The ambient mesh: explicitly-entered MeshContext, else every rank
    on the data axis."""
    if _CURRENT["mesh"] is not None:
        return _CURRENT["mesh"]
    return make_mesh(device=device)


@contextlib.contextmanager
def MeshContext(mesh):
    prev = _CURRENT["mesh"]
    _CURRENT["mesh"] = mesh
    try:
        yield mesh
    finally:
        _CURRENT["mesh"] = prev


class NamedSharding:
    """A spec over a mesh (the JAX type's counterpart); `.placements` are
    its DTensor placements."""

    def __init__(self, mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"


def batch_sharding(mesh, ndim: int = 1, batch_axis: int = 0) -> NamedSharding:
    """Shard the batch axis over 'data'; everything else replicated."""
    spec = [None] * ndim
    spec[batch_axis] = "data"
    return NamedSharding(mesh, P(*spec))


def replicated_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def addressable_shard_layout(sharding: NamedSharding, shape):
    """[(device, index)] for every shard of `shape` under `sharding` this
    rank holds — one, its own — or None when the shape does not divide
    evenly (callers fall back to one coalesced transfer)."""
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    names = mesh.mesh_dim_names
    index = [slice(None)] * len(shape)
    for i, entry in enumerate(tuple(sharding.spec)):
        axes = [a for a in (entry if isinstance(entry, (tuple, list))
                            else (entry,)) if a is not None]
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            k = names.index(a)
            idx = idx * mesh.size(k) + coord[k]
            n *= mesh.size(k)
        if shape[i] % n:
            return None
        step = shape[i] // n
        index[i] = slice(idx * step, (idx + 1) * step)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return [(dev, tuple(index))]


def host_device_groups(devices, num_hosts: int):
    """Partition `devices` (ranks) into `num_hosts` equal contiguous
    groups — the simulated-host layout the elastic tests use."""
    devices = list(devices)
    n = len(devices)
    if num_hosts < 1 or n % num_hosts != 0:
        raise ValueError(
            f"{n} devices do not split into {num_hosts} equal hosts")
    per = n // num_hosts
    return [devices[i * per:(i + 1) * per] for i in range(num_hosts)]


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0) -> Tuple[np.ndarray, int]:
    """Pad `axis` up to a multiple (padded rows repeat the last row and
    are dropped after unbatching).  Returns (padded, original_len)."""
    n = arr.shape[axis]
    target = math.ceil(max(n, 1) / multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(arr, pad_width, mode="edge"), n


def data_size(mesh) -> int:
    """The size of a mesh's `data` axis (1 when it has none)."""
    mesh = as_device_mesh(mesh)
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index("data")) if "data" in names else 1


def shard_batch(arr: np.ndarray, mesh=None):
    """Pad the leading axis to the data-parallel degree and place it with
    a batch sharding: (DTensor holding this rank's rows, original
    length).  Every rank passes the same host batch."""
    mesh = mesh if mesh is not None else default_mesh()
    dp = data_size(mesh)
    padded, n = pad_to_multiple(np.asarray(arr), dp, axis=0)
    full = torch.from_numpy(np.ascontiguousarray(padded)).to(
        torch.device(mesh.device_type) if mesh.device_type == "cpu" else
        torch.device("cuda", torch.cuda.current_device()))
    return distribute(full, mesh, batch_sharding(mesh, padded.ndim).spec), n
