"""Elastic multi-host runtime: rendezvous, membership, host-death detection.

Counterpart of the JAX package's `parallel/distributed.py`, over
`torch.distributed` and a `TCPStore`.  The data plane is the process
group's collectives (nccl on cards, gloo on the CPU); what remains ours
to build is everything around them:

* **Rendezvous** — `initialize_distributed` joins the job with bounded
  retries, full-jitter backoff and a hard deadline, every attempt
  crossing the `dist.rendezvous` fault point.  The coordinator (rank 0)
  hosts a `TCPStore` at the coordinator address; the process group is
  built over it (a `PrefixStore` per membership epoch, so a shrunken
  job regroups over the same store).  A group that is already up is
  detected precisely (`dist.is_initialized()`, or the runtime's
  "already initialized" refusal — not any message that merely contains
  "already").  No coordinator address means a single-process job: no
  runtime call, this process is the coordinator, and the mesh functions
  start their own world-1 group when they need one.
* **Membership** — an epoch-numbered view of the job (host id, process
  index, device count) persisted by the coordinator through
  :class:`MembershipStore` with the durable tmp+fsync+rename idiom.  A
  view can only advance: publishing a stale epoch raises
  :class:`StaleMembershipError` (and counts ``dist.membership.stale``).
  The store doubles as a file-based rendezvous/heartbeat plane.
* **Host-death detection** — :class:`HeartbeatMonitor`, a lease monitor
  (clock-injectable) that declares a silent peer lost EXACTLY once
  (``dist.host.lost``), instead of the loss being discovered by a wedged
  all-reduce.  Beats cross the ``dist.heartbeat`` fault point.
* **Hang-budget collectives** — `run_with_deadline` bounds every
  collective entry (`barrier`, the 3D trainer's step) by a wall budget,
  turning a silent wedge into a :class:`CollectiveTimeout`.
* **Elasticity** — :class:`ElasticContext`, the per-step harness
  `fit_epochs_resumable` polls: beat own lease, detect/adopt peer loss,
  and rebuild the mesh over the survivors.  SPMD adds one step the
  single-controller JAX package does not need: the survivors re-form the
  process group without the lost ranks (`ElasticContext.regroup`: a new
  group over the coordinator's store, ranks renumbered in view order)
  before the mesh is rebuilt on it.  The ``training.host_lost`` fault
  point injects a simulated death of the first live peer that is not the
  coordinator (every rank picks the same victim).
* **Per-host observability** — :class:`HostTelemetryServer`, a minimal
  ``/metrics.json`` + ``/health`` endpoint serving this process's
  ``export_snapshot`` in the wire format `core/telemetry/fleet.py`
  ``merge_snapshots`` merges.

Fault points and counters are the JAX package's (DIST_FAULT_POINTS;
core/telemetry/metrics.py DECLARED_METRICS).
"""
from __future__ import annotations

import datetime
import json
import os
import random
import re
import socket
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import telemetry as core_telemetry
from ..utils.faults import InjectedFault, fault_point, monotonic, sleep
from ..utils.sync import make_lock

__all__ = [
    "initialize_distributed",
    "barrier",
    "is_coordinator",
    "reset_distributed_state",
    "run_with_deadline",
    "RendezvousError",
    "StaleMembershipError",
    "CollectiveTimeout",
    "HostInfo",
    "local_host_info",
    "MembershipView",
    "MembershipStore",
    "HeartbeatMonitor",
    "ElasticContext",
    "HostTelemetryServer",
    "DIST_FAULT_POINTS",
]

DIST_FAULT_POINTS = ("dist.rendezvous", "dist.heartbeat",
                     "training.host_lost")


class RendezvousError(RuntimeError):
    """Joining the multi-host job failed past the retry/deadline budget."""


class StaleMembershipError(ValueError):
    """A membership view with a non-advancing epoch was published or
    required — acting on it would resurrect a dead host's devices."""


class CollectiveTimeout(TimeoutError):
    """A collective entry exceeded its hang budget.  The underlying call
    cannot be cancelled (the worker thread is abandoned as daemon); this
    makes the wedge a loud, typed event instead of slow training."""


# ---------------------------------------------------------------------------
# Rendezvous
# ---------------------------------------------------------------------------

# precise already-initialized detection: the runtimes' refusals ("...
# is already initialized", torch's "trying to initialize the default
# process group twice") — not any message that merely says "already"
_ALREADY_INITIALIZED = re.compile(
    r"already\s+initial|initialize the default process group twice",
    re.IGNORECASE)

_STATE: Dict[str, object] = {"done": False, "store": None, "device": None}


def reset_distributed_state() -> None:
    """Test seam: forget the module-level initialized latch (a live
    process group, if any, is NOT torn down)."""
    _STATE.update(done=False, store=None, device=None)


def _torch_initialize(coordinator_address: str, num_processes: int,
                      process_id: int, device=None,
                      initialization_timeout: int = 120) -> None:
    """The runtime join: a TCPStore at the coordinator address (hosted by
    process 0) and a process group over it — nccl for `cuda` (the
    default; raises without a card), gloo for ``device="cpu"``."""
    import torch.distributed as dist

    from .mesh import _backend_for
    from ..device import resolve_device

    if dist.is_initialized():
        raise RuntimeError("Distributed system is already initialized")
    dev = resolve_device(device)
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=int(initialization_timeout))
    store = dist.TCPStore(host, int(port), int(num_processes),
                          is_master=int(process_id) == 0, timeout=timeout)
    dist.init_process_group(_backend_for(dev),
                            store=dist.PrefixStore("epoch1", store),
                            rank=int(process_id),
                            world_size=int(num_processes), timeout=timeout)
    _STATE["store"], _STATE["device"] = store, dev


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    max_attempts: int = 3,
    backoff_s: float = 0.5,
    timeout_s: float = 120.0,
    seed: int = 0,
    device=None,
    _initialize: Optional[Callable] = None,
) -> None:
    """Join the multi-process job.  No-ops for single-process jobs (no
    coordinator address) and when a process group is already up.  Env
    fallbacks: COORDINATOR_ADDRESS (``host:port``, loopback for the
    ranks of one machine) / NUM_PROCESSES / PROCESS_ID.

    Each attempt crosses the ``dist.rendezvous`` fault point; transient
    failures retry up to `max_attempts` times with full-jitter backoff
    (``uniform(0, backoff_s * 2**attempt)``) through the injectable
    `utils.faults` clock, all under one hard `timeout_s` deadline, whose
    remainder is the runtime's own ``initialization_timeout``.  Counters:
    ``dist.rendezvous.attempt`` / ``.retry`` / ``.failed`` and the
    ``dist.rendezvous.latency`` histogram on success.

    `_initialize` is the test seam replacing the runtime join."""
    import torch.distributed as dist

    if _STATE["done"]:
        return
    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        _STATE["done"] = True
        return
    if _initialize is None and dist.is_initialized():
        _STATE["done"] = True
        return
    init = _initialize if _initialize is not None else _torch_initialize
    kwargs = dict(
        coordinator_address=coordinator_address,
        num_processes=int(num_processes
                          or os.environ.get("NUM_PROCESSES", 1)),
        process_id=int(process_id if process_id is not None
                       else os.environ.get("PROCESS_ID", 0)),
    )
    if _initialize is None:
        kwargs["device"] = device
    rng = random.Random(f"{seed}:dist.rendezvous")
    deadline = monotonic() + float(timeout_s)
    last: Optional[BaseException] = None
    for attempt in range(max(1, int(max_attempts))):
        core_telemetry.incr("dist.rendezvous.attempt")
        t0 = monotonic()
        try:
            fault_point("dist.rendezvous")
            if _initialize is None:
                remaining = max(1.0, deadline - monotonic())
                init(initialization_timeout=int(remaining), **kwargs)
            else:
                init(**kwargs)
            core_telemetry.histogram("dist.rendezvous.latency").observe(
                monotonic() - t0)
            _STATE["done"] = True
            return
        except (RuntimeError, ValueError) as e:
            if _ALREADY_INITIALIZED.search(str(e)):
                # the runtime is up already: joined, not failed
                _STATE["done"] = True
                return
            last = e
        except (InjectedFault, OSError) as e:
            last = e
        if attempt + 1 >= max(1, int(max_attempts)):
            break
        delay = rng.uniform(0.0, float(backoff_s) * (2.0 ** attempt))
        if monotonic() + delay >= deadline:
            break
        core_telemetry.incr("dist.rendezvous.retry")
        sleep(delay)
    core_telemetry.incr("dist.rendezvous.failed")
    raise RendezvousError(
        f"rendezvous with {coordinator_address} failed after "
        f"{max_attempts} attempts / {timeout_s:.0f}s deadline: "
        f"{last!r}") from last


# ---------------------------------------------------------------------------
# Hang-budget collectives
# ---------------------------------------------------------------------------

def run_with_deadline(fn: Callable, budget_s: Optional[float],
                      name: str = "collective"):
    """Run `fn()` under a wall-clock hang budget.  `budget_s=None` runs
    inline.  On overrun, counts ``dist.collective.overrun`` and raises
    :class:`CollectiveTimeout`; the worker thread is abandoned (daemon) —
    a wedged collective cannot be cancelled, only *detected*."""
    if budget_s is None:
        return fn()
    box: Dict[str, object] = {}
    done = threading.Event()

    def _run():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=_run, daemon=True,
                         name=f"dist-deadline-{name}")
    t.start()
    if not done.wait(timeout=float(budget_s)):
        core_telemetry.incr("dist.collective.overrun")
        # the spent budget is wall-clock the step can never get back
        core_telemetry.LEDGER.note_lost("collective", float(budget_s))
        raise CollectiveTimeout(
            f"{name} exceeded its {float(budget_s):g}s hang budget")
    if "error" in box:
        raise box["error"]  # type: ignore[misc]
    return box.get("result")


def barrier(name: str = "barrier",
            timeout_s: Optional[float] = 60.0, group=None) -> None:
    """Gang-sync the ranks of `group` (default: the world): a one-element
    all-reduce on the group's device, which only completes when every
    rank participates — bounded by `timeout_s` (counts
    ``dist.barrier.timeout`` and raises :class:`CollectiveTimeout`
    instead of blocking forever on a dead peer).  A single-process job
    has nothing to wait for."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        return

    def _sync():
        backend = str(dist.get_backend(group))
        dev = (torch.device("cuda", torch.cuda.current_device())
               if "nccl" in backend else torch.device("cpu"))
        x = torch.ones(1, device=dev)
        dist.all_reduce(x, group=group)
        float(x[0])  # block until the device finished it

    try:
        run_with_deadline(_sync, timeout_s, name=f"barrier.{name}")
    except CollectiveTimeout:
        core_telemetry.incr("dist.barrier.timeout")
        raise


def is_coordinator() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# Membership: epoch-numbered views of the job
# ---------------------------------------------------------------------------

class HostInfo:
    """One host's identity in a membership view: id, process index, and
    its device count (the data-axis capacity it brings)."""

    __slots__ = ("host_id", "process_index", "num_devices", "address")

    def __init__(self, host_id: str, process_index: int,
                 num_devices: int, address: str = ""):
        self.host_id = str(host_id)
        self.process_index = int(process_index)
        self.num_devices = int(num_devices)
        self.address = str(address)

    def to_dict(self) -> dict:
        return {"host_id": self.host_id,
                "process_index": self.process_index,
                "num_devices": self.num_devices,
                "address": self.address}

    @classmethod
    def from_dict(cls, doc: dict) -> "HostInfo":
        return cls(doc["host_id"], doc["process_index"],
                   doc["num_devices"], doc.get("address", ""))

    def __eq__(self, other) -> bool:
        return (isinstance(other, HostInfo)
                and self.to_dict() == other.to_dict())

    def __repr__(self) -> str:
        return (f"HostInfo({self.host_id!r}, rank={self.process_index}, "
                f"devices={self.num_devices})")


def local_host_info(host_id: Optional[str] = None) -> HostInfo:
    """This process's HostInfo (id defaults to ``host-<rank>``): one
    device a rank."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else 0
    return HostInfo(host_id if host_id is not None else f"host-{rank}",
                    rank, 1, address=socket.gethostname())


class MembershipView:
    """One epoch of membership.  Epochs only advance: every shrink (or
    join) is a NEW view, so survivors can reject decisions made against
    a stale roster (:meth:`require_epoch`)."""

    def __init__(self, epoch: int, hosts: Sequence[HostInfo]):
        if int(epoch) < 1:
            raise ValueError(f"membership epochs start at 1, got {epoch}")
        self.epoch = int(epoch)
        self.hosts: List[HostInfo] = sorted(
            hosts, key=lambda h: (h.process_index, h.host_id))
        if len({h.host_id for h in self.hosts}) != len(self.hosts):
            raise ValueError("duplicate host ids in membership view")

    @property
    def host_ids(self) -> List[str]:
        return [h.host_id for h in self.hosts]

    @property
    def total_devices(self) -> int:
        return sum(h.num_devices for h in self.hosts)

    def data_axis(self, model: int = 1, pipe: int = 1) -> int:
        """The data-parallel degree a `MeshPlan(data=-1, model, pipe)`
        over this view's devices would absorb."""
        n = self.total_devices
        if n % (model * pipe) != 0:
            raise ValueError(
                f"{n} devices not divisible by model*pipe={model * pipe}")
        return n // (model * pipe)

    def without(self, *lost_ids: str) -> "MembershipView":
        """The next epoch minus `lost_ids` (the shrink-and-resume view)."""
        gone = set(lost_ids)
        missing = gone - set(self.host_ids)
        if missing:
            raise KeyError(f"hosts not in epoch {self.epoch}: "
                           f"{sorted(missing)}")
        survivors = [h for h in self.hosts if h.host_id not in gone]
        if not survivors:
            raise ValueError("cannot shrink to an empty membership view")
        return MembershipView(self.epoch + 1, survivors)

    def require_epoch(self, expected: int) -> None:
        """Raise :class:`StaleMembershipError` unless this view IS epoch
        `expected`."""
        if self.epoch != int(expected):
            core_telemetry.incr("dist.membership.stale")
            raise StaleMembershipError(
                f"membership epoch {self.epoch} != required {expected}")

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "hosts": [h.to_dict() for h in self.hosts]}

    @classmethod
    def from_dict(cls, doc: dict) -> "MembershipView":
        return cls(doc["epoch"],
                   [HostInfo.from_dict(h) for h in doc["hosts"]])

    def __repr__(self) -> str:
        return (f"MembershipView(epoch={self.epoch}, "
                f"hosts={self.host_ids}, devices={self.total_devices})")


def _atomic_write_json(path: str, doc: dict) -> None:
    # tmp + fsync + rename: a crash mid-write leaves the previous file,
    # never a torn one; the tmp name is per writer (thread and process)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class MembershipStore:
    """Coordinator-persisted membership + a file-based rendezvous and
    heartbeat plane.

    Layout under `root`::

        hosts/<host_id>.json   registrations (rendezvous intake)
        beats/<host_id>.json   monotone heartbeat sequence numbers
        membership.json        the current MembershipView (atomic)

    Beat *freshness* is judged by sequence advance observed through the
    monitor's own injectable clock — never by comparing wall clocks
    across processes."""

    def __init__(self, root):
        self.root = os.fspath(root)
        self._hosts_dir = os.path.join(self.root, "hosts")
        self._beats_dir = os.path.join(self.root, "beats")
        os.makedirs(self._hosts_dir, exist_ok=True)
        os.makedirs(self._beats_dir, exist_ok=True)
        self._path = os.path.join(self.root, "membership.json")
        self._lock = make_lock("parallel.dist.membership")
        self._beat_seq: Dict[str, int] = {}  #: guarded-by self._lock

    # ---- registration / view -------------------------------------------

    def register(self, info: HostInfo) -> None:
        _atomic_write_json(
            os.path.join(self._hosts_dir, f"{info.host_id}.json"),
            info.to_dict())

    def registered(self) -> List[HostInfo]:
        out = []
        for fn in sorted(os.listdir(self._hosts_dir)):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._hosts_dir, fn)) as f:
                    out.append(HostInfo.from_dict(json.load(f)))
            except (OSError, ValueError, KeyError):
                continue  # torn mid-write: the next poll sees it whole
        return out

    def publish(self, view: MembershipView) -> MembershipView:
        """Coordinator-only: persist `view`.  The epoch must strictly
        advance past the stored one (stale publishes raise)."""
        current = self.load()
        if current is not None and view.epoch <= current.epoch:
            core_telemetry.incr("dist.membership.stale")
            raise StaleMembershipError(
                f"cannot publish epoch {view.epoch} over "
                f"epoch {current.epoch}")
        _atomic_write_json(self._path, view.to_dict())
        core_telemetry.incr("dist.membership.update")
        core_telemetry.gauge("dist.membership.epoch").set(view.epoch)
        core_telemetry.gauge("dist.membership.hosts").set(len(view.hosts))
        return view

    def load(self) -> Optional[MembershipView]:
        try:
            with open(self._path) as f:
                return MembershipView.from_dict(json.load(f))
        except (OSError, ValueError, KeyError):
            return None

    # ---- rendezvous -----------------------------------------------------

    def rendezvous(self, info: HostInfo, expected: int,
                   coordinator: bool = False,
                   timeout_s: float = 60.0,
                   poll_s: float = 0.05,
                   seed: int = 0) -> MembershipView:
        """File-plane rendezvous: register, then either collect `expected`
        registrations and publish epoch 1 (coordinator) or wait for the
        published view (followers).  Registration attempts cross the
        ``dist.rendezvous`` fault point with full-jitter retries under a
        hard deadline, same contract as `initialize_distributed`."""
        rng = random.Random(f"{seed}:{info.host_id}:dist.rendezvous")
        deadline = monotonic() + float(timeout_s)
        attempt = 0
        while True:
            core_telemetry.incr("dist.rendezvous.attempt")
            try:
                fault_point("dist.rendezvous")
                self.register(info)
                break
            except (InjectedFault, OSError) as e:
                if monotonic() >= deadline:
                    core_telemetry.incr("dist.rendezvous.failed")
                    raise RendezvousError(
                        f"{info.host_id} could not register within "
                        f"{timeout_s:.0f}s: {e!r}") from e
                core_telemetry.incr("dist.rendezvous.retry")
                sleep(min(rng.uniform(0.0, 0.05 * (2.0 ** attempt)),
                          max(0.0, deadline - monotonic())))
                attempt += 1
        t0 = monotonic()
        while monotonic() < deadline:
            if coordinator:
                roster = self.registered()
                if len(roster) >= int(expected):
                    view = self.load()
                    if view is None:
                        view = self.publish(MembershipView(1, roster))
                    dt = monotonic() - t0
                    core_telemetry.histogram(
                        "dist.rendezvous.latency").observe(dt)
                    core_telemetry.LEDGER.note_lost("rendezvous", dt)
                    return view
            else:
                view = self.load()
                if view is not None:
                    dt = monotonic() - t0
                    core_telemetry.histogram(
                        "dist.rendezvous.latency").observe(dt)
                    core_telemetry.LEDGER.note_lost("rendezvous", dt)
                    return view
            sleep(poll_s)
        core_telemetry.incr("dist.rendezvous.failed")
        raise RendezvousError(
            f"{info.host_id} rendezvous timed out after {timeout_s:.0f}s "
            f"({len(self.registered())}/{expected} hosts registered)")

    # ---- heartbeats -----------------------------------------------------

    def heartbeat(self, host_id: str) -> None:
        """Bump this host's monotone beat sequence on the shared plane."""
        with self._lock:
            seq = self._beat_seq.get(host_id, 0) + 1
            self._beat_seq[host_id] = seq
        _atomic_write_json(
            os.path.join(self._beats_dir, f"{host_id}.json"),
            {"host_id": host_id, "seq": seq})

    def read_beats(self) -> Dict[str, int]:
        """host_id -> latest beat sequence (the HeartbeatMonitor `source`)."""
        out: Dict[str, int] = {}
        for fn in os.listdir(self._beats_dir):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._beats_dir, fn)) as f:
                    doc = json.load(f)
                out[str(doc["host_id"])] = int(doc["seq"])
            except (OSError, ValueError, KeyError):
                continue
        return out


# ---------------------------------------------------------------------------
# Host-death detection: the heartbeat/lease monitor
# ---------------------------------------------------------------------------

class HeartbeatMonitor:
    """Lease-based liveness: a host whose beats stop for longer than
    `lease_s` is declared lost EXACTLY once (``dist.host.lost`` counter +
    record + `on_lost` callback).

    Beats arrive either in-process (:meth:`beat`, crossing the
    ``dist.heartbeat`` fault point — an injected fault models a dropped
    heartbeat message, counted ``dist.heartbeat.missed``) or from a
    shared plane via :meth:`ingest` (sequence-advance semantics: lease
    age is measured on THIS monitor's injectable clock).  `start()` runs
    the poll loop on a ``dist-heartbeat-monitor`` thread; tests drive
    :meth:`check_now` directly under a ``VirtualClock``."""

    def __init__(self, hosts: Sequence[str],
                 lease_s: float = 5.0,
                 poll_s: float = 0.25,
                 clock: Optional[Callable[[], float]] = None,
                 on_lost: Optional[Callable[[str, dict], None]] = None,
                 source: Optional[Callable[[], Dict[str, int]]] = None,
                 self_id: Optional[str] = None):
        self.lease_s = float(lease_s)
        self.poll_s = float(poll_s)
        self._clock = clock if clock is not None else monotonic
        self.on_lost = on_lost
        self._source = source
        self.self_id = self_id
        self._lock = make_lock("parallel.dist.heartbeat")
        now = self._clock()
        # every tracked host starts with a full lease at construction
        self._last: Dict[str, float] = {str(h): now for h in hosts}  #: guarded-by self._lock
        self._seqs: Dict[str, int] = {}  #: guarded-by self._lock
        self.lost: Dict[str, dict] = {}  #: guarded-by self._lock
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---- beats ----------------------------------------------------------

    def beat(self, host_id: str) -> bool:
        """Record one in-process heartbeat.  Returns False when the beat
        was dropped (injected ``dist.heartbeat`` fault)."""
        try:
            fault_point("dist.heartbeat")
        except InjectedFault:
            core_telemetry.incr("dist.heartbeat.missed")
            return False
        with self._lock:
            self._last[str(host_id)] = self._clock()
        return True

    def ingest(self, seqs: Dict[str, int]) -> None:
        """Fold shared-plane beat sequences in: a host whose sequence
        ADVANCED since the last ingest beat "now" on this clock."""
        now = self._clock()
        with self._lock:
            for host, seq in seqs.items():
                host = str(host)
                if host not in self._last:
                    continue  # not in the tracked roster
                if self._seqs.get(host) != int(seq):
                    self._seqs[host] = int(seq)
                    self._last[host] = now

    # ---- detection ------------------------------------------------------

    def check_now(self) -> List[str]:
        """Evaluate every lease; returns the hosts NEWLY declared lost
        (each host fires at most once, ever — the `lost` latch)."""
        now = self._clock()
        newly: List[str] = []
        with self._lock:
            for host, last in self._last.items():
                if host in self.lost or host == self.self_id:
                    continue
                age = now - last
                if age > self.lease_s:
                    self.lost[host] = {
                        "host_id": host, "kind": "lease_expired",
                        "last_beat_age_s": round(age, 3),
                        "lease_s": self.lease_s,
                    }
                    newly.append(host)
        for host in newly:
            # outside the lock: counters/callback must not serialize beats
            self._announce(host)
        return newly

    def declare_lost(self, host_id: str,
                     record: Optional[dict] = None) -> bool:
        """Declare `host_id` lost out-of-band (an injected
        ``training.host_lost`` fault, an operator decision).  Same
        exactly-once latch and announcement as a lease expiry."""
        host = str(host_id)
        with self._lock:
            if host in self.lost:
                return False
            rec = {"host_id": host, "kind": "declared"}
            rec.update(record or {})
            self.lost[host] = rec
        self._announce(host)
        return True

    def _announce(self, host: str) -> None:
        core_telemetry.incr("dist.host.lost")
        core_telemetry.incr(f"dist.host.lost.{host}")
        with self._lock:
            rec = dict(self.lost[host])
        with core_telemetry.span("dist.host.lost") as sp:
            sp.attrs.update(rec)
        if self.on_lost is not None:
            self.on_lost(host, rec)

    def alive(self) -> List[str]:
        with self._lock:
            return [h for h in self._last if h not in self.lost]

    # ---- lifecycle ------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "HeartbeatMonitor":
        if not self.running:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._run, name="dist-heartbeat-monitor",
                daemon=False)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_evt.wait(timeout=self.poll_s):
            if self._source is not None:
                try:
                    self.ingest(self._source())
                except Exception:  # noqa: BLE001 — a torn read is a missed poll
                    pass
            self.check_now()

    def stop(self) -> None:
        self._stop_evt.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self) -> "HeartbeatMonitor":
        return self.start()

    def __exit__(self, *_exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# Elasticity: the per-step harness the training loop polls
# ---------------------------------------------------------------------------

class ElasticContext:
    """Glue between the membership plane and `fit_epochs_resumable`'s
    elastic mode.  Once per step the loop calls :meth:`poll`:

    1. beat this host's lease (store and/or in-process monitor);
    2. cross the ``training.host_lost`` fault point — an injected fault
       simulates the death of the first live peer that is not the
       coordinator (the same victim on every rank), driving the same
       ladder as a real lease expiry;
    3. coordinator: ingest shared-plane beats + evaluate leases;
       follower: adopt a newer epoch the coordinator published — one
       that leaves this host out raises `StaleMembershipError` (the job
       went on without it: a fenced process stops).

    A non-empty return is the list of peers lost since the last poll;
    the loop then runs the quarantine -> checkpoint-floor rollback ->
    :meth:`commit_loss` (epoch advance) -> :meth:`rebuild` (mesh over the
    survivors) ladder.  A `rebuild` callback of an SPMD job starts with
    :meth:`regroup`, which re-forms the process group over the survivors
    before a `MeshPlan` is built on it."""

    def __init__(self, host: HostInfo, view: MembershipView,
                 store: Optional[MembershipStore] = None,
                 monitor: Optional[HeartbeatMonitor] = None,
                 coordinator: Optional[bool] = None,
                 rebuild: Optional[Callable[[MembershipView],
                                            Optional[tuple]]] = None,
                 hang_budget_s: Optional[float] = None):
        self.host = host
        self.view = view
        self.store = store
        self.monitor = monitor
        self.coordinator = (coordinator if coordinator is not None
                            else host.process_index == 0)
        self._rebuild = rebuild
        self.hang_budget_s = hang_budget_s
        self._lock = make_lock("parallel.dist.elastic")
        self._pending: List[str] = []  #: guarded-by self._lock
        if monitor is not None and monitor.on_lost is None:
            monitor.on_lost = self._notice
        core_telemetry.gauge("dist.membership.epoch").set(view.epoch)
        core_telemetry.gauge("dist.membership.hosts").set(len(view.hosts))

    def _notice(self, host_id: str, record: dict) -> None:
        with self._lock:
            self._pending.append(str(host_id))

    def _next_live_peer(self) -> Optional[str]:
        lost = set(self.monitor.lost) if self.monitor is not None else set()
        with self._lock:
            lost |= set(self._pending)
        coordinator = self.view.host_ids[0]
        for h in self.view.host_ids:
            if h not in (self.host.host_id, coordinator) and h not in lost:
                return h
        return None

    def poll(self) -> Optional[List[str]]:
        """One elastic tick; returns newly lost peers (None when quiet)."""
        roster = set(self.view.host_ids)  # pre-adoption: the epoch we ran
        if self.store is not None:
            self.store.heartbeat(self.host.host_id)
        if self.monitor is not None:
            self.monitor.beat(self.host.host_id)
        try:
            fault_point("training.host_lost")
        except InjectedFault:
            victim = self._next_live_peer()
            if victim is not None:
                if self.monitor is not None:
                    self.monitor.declare_lost(
                        victim, {"kind": "injected"})
                else:
                    self._notice(victim, {"kind": "injected"})
        if self.monitor is not None and self.coordinator:
            if self.store is not None:
                self.monitor.ingest(self.store.read_beats())
            self.monitor.check_now()
        elif self.store is not None and not self.coordinator:
            latest = self.store.load()
            if latest is not None and latest.epoch > self.view.epoch:
                if self.host.host_id not in latest.host_ids:
                    # the job went on without this host: a fenced
                    # process must stop, not join the survivors' group
                    core_telemetry.incr("dist.membership.stale")
                    raise StaleMembershipError(
                        f"{self.host.host_id} is not in membership epoch "
                        f"{latest.epoch}: the job continued without it")
                gone = set(self.view.host_ids) - set(latest.host_ids)
                with self._lock:
                    self._pending.extend(sorted(gone))
                self.view = latest
                core_telemetry.gauge("dist.membership.epoch").set(
                    latest.epoch)
                core_telemetry.gauge("dist.membership.hosts").set(
                    len(latest.hosts))
        with self._lock:
            pending, self._pending = self._pending, []
        # de-dup while keeping order; drop hosts that were already gone
        # from the roster BEFORE this poll (a repeated announcement)
        seen: List[str] = []
        for h in pending:
            if h not in seen and h in roster:
                seen.append(h)
        return seen or None

    def commit_loss(self, lost: Sequence[str]) -> MembershipView:
        """Advance the membership epoch past `lost`.  The coordinator
        publishes the shrunken view (stale publishes raise); followers
        that already adopted the published epoch keep it."""
        gone = [h for h in lost if h in self.view.host_ids]
        if not gone:
            return self.view
        new_view = self.view.without(*gone)
        if self.store is not None and self.coordinator:
            self.store.publish(new_view)
        else:
            core_telemetry.gauge("dist.membership.epoch").set(
                new_view.epoch)
            core_telemetry.gauge("dist.membership.hosts").set(
                len(new_view.hosts))
        self.view = new_view
        return new_view

    def rebuild(self, view: MembershipView) -> Optional[tuple]:
        """The survivor-mesh hook: `(mesh, step_fn)` from the caller's
        rebuild callback, or None when the local layout is unchanged."""
        if self._rebuild is None:
            return None
        return self._rebuild(view)

    def regroup(self, view: MembershipView, timeout_s: float = 60.0) -> int:
        """Re-form the process group over `view`'s hosts: the old group is
        destroyed and a new one starts over the coordinator's store (a
        `PrefixStore` named for the epoch), world size the survivor
        count, this host's rank its place in the view.  Returns the new
        rank.  Every survivor calls it; the lost ranks never join."""
        import torch.distributed as dist

        store, dev = _STATE["store"], _STATE["device"]
        if store is None:
            raise RuntimeError("regroup needs the store "
                               "initialize_distributed started")
        rank = view.host_ids.index(self.host.host_id)
        backend = str(dist.get_backend())
        dist.destroy_process_group()
        timeout = datetime.timedelta(seconds=float(timeout_s))
        dist.init_process_group(
            backend, store=dist.PrefixStore(f"epoch{view.epoch}", store),
            rank=rank, world_size=len(view.hosts), timeout=timeout)
        return rank


# ---------------------------------------------------------------------------
# Per-host telemetry endpoint (the federation wire format)
# ---------------------------------------------------------------------------

class HostTelemetryServer:
    """Minimal per-host observability endpoint: ``/metrics.json`` serves
    this process's ``export_snapshot`` — the format the gateway's fleet
    telemetry scrapes from replicas — and ``/health`` serves liveness,
    so a job's hosts federate into one view through ``merge_snapshots``
    without running a full WorkerServer."""

    def __init__(self, host_id: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.host_id = str(host_id)
        self.host = host
        self.port = int(port)
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        host_id = self.host_id

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/")
                if path == "/metrics.json":
                    payload = json.dumps(
                        core_telemetry.export_snapshot(
                            include_spans=False),
                        default=repr).encode("utf-8")
                elif path == "/health":
                    payload = json.dumps(
                        {"status": "ok",
                         "host_id": host_id}).encode("utf-8")
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *a):  # quiet
                pass

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=False,
            name=f"dist-host-telemetry-{self.host_id}")
        self._thread.start()
        return self.host, self.port

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def __enter__(self) -> "HostTelemetryServer":
        self.start()
        return self

    def __exit__(self, *_exc) -> None:
        self.stop()
