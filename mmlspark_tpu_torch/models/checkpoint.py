"""Training checkpoint / resume for the port's `TrainState`, with
integrity verification.

Counterpart of the JAX package's `models/checkpoint.py` on one card,
with its semantics, counters and fault points, and without orbax: a
checkpoint is a directory `<dir>/<step>/` holding one `.npy` file per
leaf — the leaf's host bytes; a bf16 leaf as its 16-bit pattern, with
the dtype recorded — beside a **manifest** (`manifest.mmlspark.json`,
format 1) holding a crc32, dtype and shape per leaf.  The leaves of a
`TrainState` are:

* ``module/<name>``: the f32 master module's `state_dict`, parameters
  and buffers (BatchNorm running statistics, ``num_batches_tracked``);
* ``optimizer/state/<i>/<key>``: the optimizer's per-parameter state
  (SGD's momentum, Adam's ``exp_avg``, ``exp_avg_sq`` and ``step``), and
  ``optimizer/param_groups``: its parameter groups as JSON;
* ``step``: the optimizer step count.

What the manifest buys, as in the JAX package:

* every ``save()`` writes the leaves and the manifest (tmp file, fsync,
  rename) into a temporary directory that is renamed to `<step>` only
  once all of it is on disk, so a crash mid-write leaves no step or a
  whole one.  Every save is synchronous: the port has no async writer.
* ``restore()`` re-hashes every leaf against the manifest
  (``checkpoint.verify.latency`` histogram); a mismatch, a missing or
  unreadable leaf or a torn manifest raises `CheckpointCorruptError`
  and counts ``checkpoint.corrupt``.
* ``restore_verified()`` walks the steps newest first and returns the
  first that restores and verifies, counting ``checkpoint.fallback`` for
  each one walked past; with ``quarantine=True`` each corrupt step is
  moved aside into `<dir>/quarantined/` (``checkpoint.quarantine``) and
  ``on_corrupt(step, path)`` tells the TrainingGuard.
* the fault points ``checkpoint.write`` / ``checkpoint.read`` let chaos
  tests inject write and read errors (utils/faults.py).

A restore into a template state overwrites the live state in place —
the master's parameters and buffers (`load_state_dict`, which copies into
the existing tensors, so the bf16 working copy keeps sharing the
buffers), the optimizer's state and groups, the step count — and then
refreshes the bf16 working copy's parameters from the masters: after a
poisoned step every one of them holds NaN.  Without a template it
returns the verified leaves as a dict.

**Format 2** is the 3D trainer's (`models.trainer3d.TrainState3D`,
one SPMD process a rank): each leaf is saved WHOLE — the ranks gather it
(a DTensor `full_tensor()`) and rank 0 writes it — and the manifest
entry of a leaf its spec splits also carries the PartitionSpec and one
crc32 per shard, keyed by the shard's index and slice bounds in the
global array (replicated copies dedupe by their bounds; a split over an
axis of one rank is one shard).  Verification re-slices the
restored global array by those bounds, so a flipped byte is pinned to
the exact (leaf, spec, shard) — the error names it — and one bad shard
fails the whole step.  The restore re-slices: every rank reads the
global leaves and keeps its own chunk for the template's CURRENT plan,
so a checkpoint saved on one mesh resumes on another (the elastic
shrink).  The directory is shared by the job's ranks: rank 0 is the
writer (saves, deletes, retention, quarantine moves); a sharded save
ends with a barrier, so every rank reads what rank 0 wrote.  A format-2
step restores only into a `TrainState3D` and a format-1 step only into a
`TrainState` (`CheckpointFormatError` otherwise).

A step directory that orbax wrote (the JAX package's checkpoints) is
refused with `CheckpointFormatError` — weights cross from the JAX
package through `models.bundle.from_flax_variables`.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import telemetry as core_telemetry
from ..utils.faults import fault_point
from .training import TrainState
from .trainer3d import TrainState3D

__all__ = ["CheckpointManager", "CheckpointCorruptError",
           "CheckpointFormatError", "MANIFEST_NAME", "save_checkpoint",
           "restore_checkpoint", "latest_step"]

MANIFEST_NAME = "manifest.mmlspark.json"
_GROUPS = "optimizer/param_groups"
_GROUPS_FILE = "param_groups.json"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint's bytes do not match its manifest (or cannot be read):
    restoring it would silently poison the run."""


class CheckpointFormatError(ValueError):
    """A step directory this package does not read: one that orbax wrote
    (the JAX package's CheckpointManager)."""


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a host array (bf16 as its int16 pattern)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _digest(arr: np.ndarray) -> Dict[str, Any]:
    return {"crc32": zlib.crc32(arr.tobytes()), "shape": list(arr.shape)}


def _leaves(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's tensor leaves by key (see the module docstring)."""
    out = {f"module/{k}": v for k, v in state.module.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                out[f"optimizer/state/{i}/{k}"] = v
    out["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    return out


def _groups_doc(state: TrainState) -> bytes:
    """The optimizer's parameter groups and any per-parameter state that
    is not a tensor, as JSON bytes."""
    sd = state.optimizer.state_dict()
    scalars = {str(i): {k: v for k, v in st.items()
                        if not isinstance(v, torch.Tensor)}
               for i, st in sd["state"].items()}
    return json.dumps({"param_groups": sd["param_groups"],
                       "state_scalars": scalars}, sort_keys=True).encode()


def _multi_rank() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def _is_rank0() -> bool:
    import torch.distributed as dist

    return not _multi_rank() or dist.get_rank() == 0


def _shard_bounds(state: TrainState3D, path: str) -> List[List[int]]:
    """This rank's chunk of leaf `path` as [[start, stop], ...] bounds in
    the global array."""
    from ..parallel.mesh import addressable_shard_layout
    from ..parallel.mesh import NamedSharding

    shape = state.shapes[path]
    (_dev, index), = addressable_shard_layout(
        NamedSharding(state.plan.mesh, state.specs[path]), shape)
    return [[0 if sl.start is None else int(sl.start),
             int(dim) if sl.stop is None else int(sl.stop)]
            for sl, dim in zip(index, shape)]


def _sharded_leaves(state: TrainState3D):
    """key -> (this rank's chunk, leaf path whose spec it follows) for
    every tensor leaf of a 3D state: the masters and the optimizer's
    per-parameter tensors shaped like their parameter; other optimizer
    tensors (Adam's step count) follow no spec (path None)."""
    out = {}
    paths = [p for _n, p in state.leaf_paths()]
    for (name, path), t in zip(state.leaf_paths(),
                               state.module.parameters()):
        out[f"module/{name}"] = (t.detach(), path)
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            if isinstance(v, torch.Tensor):
                follows = paths[int(i)] if v.dim() > 0 else None
                out[f"optimizer/state/{i}/{k}"] = (v, follows)
    return out


def _gather_leaf(state: TrainState3D, local: torch.Tensor,
                 path: Optional[str]) -> torch.Tensor:
    """The full global tensor of a chunk (a collective over the mesh)."""
    if path is None:
        return local.detach().cpu()
    return state.dtensor(local, path).full_tensor().cpu()


def _local_of(state: TrainState3D, full: torch.Tensor,
              path: Optional[str]) -> torch.Tensor:
    """This rank's chunk of a restored global tensor on the state's
    current plan."""
    if path is None:
        return full
    from ..parallel.sharding_rules import local_chunk

    return local_chunk(full, state.plan.mesh, state.specs[path]).contiguous()


class CheckpointManager:
    """Step directories under `directory` with retention (`max_to_keep`
    newest steps) and per-leaf checksum manifests.  In a multi-process
    job the directory is shared and rank 0 writes (`writer`)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    @property
    def writer(self) -> bool:
        """Whether this process writes: rank 0 of a multi-process job, or
        the only process."""
        return _is_rank0()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, state: TrainState, step: Optional[int] = None) -> int:
        """Write `state` as step `step` (default: its step count), wait
        for it to be on disk, then drop the oldest steps past
        `max_to_keep`.  Returns the step."""
        fault_point("checkpoint.write")
        # the manager's numbering (an epoch count, the loop's schedule
        # position) is independent of the state's own step count, which
        # the round trip keeps
        mgr_step = int(state.step if step is None else step)
        if isinstance(state, TrainState3D):
            return self._save_sharded(state, mgr_step)
        self._write(state, mgr_step, _leaves(state), {}, 1)
        return mgr_step

    def _save_sharded(self, state: TrainState3D, mgr_step: int) -> int:
        """Format 2: every rank takes part in gathering the leaves and
        their shard checksums; rank 0 writes; all meet at a barrier."""
        import torch.distributed as dist

        leaves = _sharded_leaves(state)
        mine = {}
        for key, (local, path) in leaves.items():
            if path is not None and any(tuple(state.specs[path])):
                mine[key] = (_shard_bounds(state, path),
                             zlib.crc32(_host(local).tobytes()))
        tables = [mine]
        if _multi_rank():
            tables = [None] * dist.get_world_size()
            dist.all_gather_object(tables, mine)
        full = {key: _gather_leaf(state, local, path)
                for key, (local, path) in leaves.items()}
        full["step"] = torch.tensor(int(state.step), dtype=torch.int64)
        extra: Dict[str, Dict[str, Any]] = {}
        for key, (_local, path) in leaves.items():
            seen = {}
            for table in tables:
                if key in table:
                    bounds, crc = table[key]
                    seen.setdefault(tuple(map(tuple, bounds)), crc)
            if seen:  # a leaf its spec splits, however many ranks
                extra[key] = {
                    "spec": str(state.specs[path]),
                    "shards": [{"i": i, "index": [list(b) for b in bounds],
                                "crc32": crc}
                               for i, (bounds, crc) in
                               enumerate(sorted(seen.items()))]}
        if self.writer:
            self._write(state, mgr_step, full, extra, 2)
        if _multi_rank():
            dist.barrier()
        return mgr_step

    def _write(self, state, mgr_step: int, leaves: Dict[str, torch.Tensor],
               extra: Dict[str, Dict[str, Any]], fmt: int) -> None:
        """Write `leaves` and the manifest (`extra` merged into their
        entries) as step `mgr_step`, atomically; then retention."""
        final = self._step_dir(mgr_step)
        if os.path.exists(final):
            raise ValueError(f"checkpoint step {mgr_step} already exists in "
                             f"{self.directory}")
        tmp = os.path.join(self.directory,
                           f".tmp-{mgr_step}-{os.getpid()}-{time.time_ns()}")
        os.makedirs(tmp)
        try:
            entries: Dict[str, Dict[str, Any]] = {}
            for n, (key, t) in enumerate(leaves.items()):
                arr = _host(t)
                name = f"{n:05d}.npy"
                _write_file(os.path.join(tmp, name),
                            lambda f, a=arr: np.save(f, a))
                entries[key] = dict(_digest(arr), file=name,
                                    dtype=str(t.dtype).replace("torch.", ""),
                                    **extra.get(key, {}))
            groups = _groups_doc(state)
            _write_file(os.path.join(tmp, _GROUPS_FILE),
                        lambda f: f.write(groups))
            entries[_GROUPS] = {"crc32": zlib.crc32(groups), "shape": [],
                                "file": _GROUPS_FILE, "dtype": "json"}
            doc = json.dumps({"format": fmt, "step": mgr_step,
                              "state_step": int(state.step),
                              "leaves": entries}).encode()
            _write_file(os.path.join(tmp, MANIFEST_NAME + ".tmp"),
                        lambda f: f.write(doc))
            os.replace(os.path.join(tmp, MANIFEST_NAME + ".tmp"),
                       os.path.join(tmp, MANIFEST_NAME))
            _fsync_dir(tmp)
            os.replace(tmp, final)
            _fsync_dir(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep or None]:
            if old != mgr_step:
                self.delete(old)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and
                      os.path.isdir(os.path.join(self.directory, n)))

    def delete(self, step: int) -> None:
        """Drop one step (leaves + manifest) — used when a rollback
        replay re-saves a schedule position it already passed.  Only the
        writer deletes."""
        if self.writer:
            shutil.rmtree(self._step_dir(step))

    def quarantine_step(self, step: int) -> str:
        """Move a corrupt step's directory aside into
        ``<dir>/quarantined/<step>`` instead of deleting it: the restore
        walk stops seeing it, but the bytes survive for post-mortem.
        Returns the quarantine path; counts ``checkpoint.quarantine``."""
        step = int(step)
        qdir = os.path.join(self.directory, "quarantined")
        os.makedirs(qdir, exist_ok=True)
        dst = os.path.join(qdir, str(step))
        if os.path.exists(dst):
            # a second corruption of the same schedule position (rollback
            # replay re-saved it) must not clobber the first exhibit
            n = 1
            while os.path.exists(f"{dst}.{n}"):
                n += 1
            dst = f"{dst}.{n}"
        if self.writer:
            # the other ranks of a job report the same destination
            os.replace(self._step_dir(step), dst)
            core_telemetry.incr("checkpoint.quarantine")
        return dst

    # ------------------------------------------------------ integrity

    def _read_manifest(self, step: int) -> Dict:
        """The step's manifest.  Raises CheckpointFormatError for a step
        orbax wrote or of an unknown format, and CheckpointCorruptError
        for a missing or torn manifest."""
        step_dir = self._step_dir(step)
        path = os.path.join(step_dir, MANIFEST_NAME)
        doc = None
        if os.path.exists(path):
            try:
                with open(path) as f:
                    doc = json.load(f)
                if not isinstance(doc, dict) or "leaves" not in doc:
                    raise ValueError("manifest missing 'leaves'")
            except (OSError, ValueError) as e:
                core_telemetry.incr("checkpoint.corrupt")
                raise CheckpointCorruptError(
                    f"torn manifest for step {step} in {self.directory}: "
                    f"{e}") from e
        orbax = (os.path.isdir(os.path.join(step_dir, "default")) or
                 os.path.exists(os.path.join(step_dir,
                                             "_CHECKPOINT_METADATA")))
        if orbax and (doc is None or any(
                "file" not in e for e in doc["leaves"].values())):
            raise CheckpointFormatError(
                f"checkpoint step {step} in {self.directory} was written by "
                "orbax (the JAX package's CheckpointManager); "
                "mmlspark_tpu_torch reads only its own checkpoints — bring "
                "JAX weights over with models.bundle.from_flax_variables")
        if doc is None:
            core_telemetry.incr("checkpoint.corrupt")
            raise CheckpointCorruptError(
                f"checkpoint step {step} in {self.directory} has no "
                "manifest")
        if doc.get("format") not in (1, 2):
            raise CheckpointFormatError(
                f"checkpoint step {step} in {self.directory} is format "
                f"{doc.get('format')!r}; this package reads formats 1 and 2")
        return doc

    def _load_leaves(self, step: int, doc: Dict) -> Dict[str, Any]:
        """Every leaf of the step, verified against its manifest `doc` —
        whole leaves and, in format 2, each shard re-sliced from the
        global leaf by its bounds (raises CheckpointCorruptError on any
        mismatch or unreadable leaf, naming every corrupt shard)."""
        step_dir = self._step_dir(step)
        leaves: Dict[str, Any] = {}
        bad: List[str] = []
        bad_shards: List[str] = []
        t_verify = 0.0
        for key, entry in doc["leaves"].items():
            path = os.path.join(step_dir, entry["file"])
            try:
                if entry["dtype"] == "json":
                    with open(path, "rb") as f:
                        raw = f.read()
                    t0 = time.perf_counter()
                    ok = zlib.crc32(raw) == entry["crc32"]
                    t_verify += time.perf_counter() - t0
                    leaves[key] = json.loads(raw) if ok else None
                else:
                    arr = np.load(path, allow_pickle=False)
                    t0 = time.perf_counter()
                    ok = _digest(arr) == {"crc32": entry["crc32"],
                                          "shape": entry["shape"]}
                    for sh in entry.get("shards", ()):
                        sl = tuple(slice(a, b) for a, b in sh["index"])
                        crc = zlib.crc32(np.ascontiguousarray(
                            arr[sl]).tobytes())
                        if crc != sh["crc32"]:
                            bad_shards.append(
                                f"{key} spec={entry.get('spec')} "
                                f"shard={sh['i']} bounds={sh['index']}")
                    t_verify += time.perf_counter() - t0
                    leaves[key] = arr
            except (OSError, ValueError, EOFError) as e:
                bad.append(f"{key} unreadable ({e})")
                continue
            if not ok:
                bad.append(f"{key} checksum mismatch")
        core_telemetry.histogram("checkpoint.verify.latency").observe(
            t_verify)
        if bad or bad_shards:
            core_telemetry.incr("checkpoint.corrupt")
            detail = ("; corrupt shards: " + ", ".join(bad_shards)
                      if bad_shards else "")
            raise CheckpointCorruptError(
                f"checkpoint step {step} in {self.directory} failed "
                f"verification: {len(bad)} leaves bad: "
                + "; ".join(bad[:5])
                + f"; {len(bad_shards)} shard mismatches{detail}")
        out: Dict[str, Any] = {"module": {}, "optimizer_state": {},
                               "step": None, "groups": leaves.pop(_GROUPS)}
        for key, arr in leaves.items():
            entry = doc["leaves"][key]
            t = torch.from_numpy(arr)  # np.load gives C order, any rank
            if entry["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            if key == "step":
                out["step"] = int(t)
            elif key.startswith("module/"):
                out["module"][key[len("module/"):]] = t
            else:
                _, _, idx, name = key.split("/", 3)
                out["optimizer_state"].setdefault(int(idx), {})[name] = t
        return out

    # -------------------------------------------------------- restore

    def restore(self, step: Optional[int] = None,
                template: Optional[TrainState] = None):
        """Step `step` (default: the latest), verified.  With `template`,
        loaded into that live state in place and returned (see the
        module docstring); without, the leaves as ``{"module": state
        dict, "optimizer": optimizer state dict, "step": int}``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        else:
            step = int(step)
            if step not in self.all_steps():
                raise FileNotFoundError(
                    f"no checkpoint for step {step} in {self.directory}")
        fault_point("checkpoint.read")
        doc = self._read_manifest(step)
        sharded = isinstance(template, TrainState3D)
        if template is not None and (doc["format"] == 2) != sharded:
            raise CheckpointFormatError(
                f"checkpoint step {step} in {self.directory} is format "
                f"{doc['format']}: format 2 (per-shard) restores into a "
                "TrainState3D, format 1 into a TrainState")
        leaves = self._load_leaves(step, doc)
        groups = leaves["groups"]
        opt_state = leaves["optimizer_state"]
        for i, extra in groups["state_scalars"].items():
            opt_state.setdefault(int(i), {}).update(extra)
        optimizer = {"state": opt_state,
                     "param_groups": groups["param_groups"]}
        if template is None:
            return {"module": leaves["module"], "optimizer": optimizer,
                    "step": leaves["step"]}
        if sharded:
            _load_into_sharded(template, leaves["module"], optimizer,
                               leaves["step"])
        else:
            _load_into(template, leaves["module"], optimizer, leaves["step"])
        return template

    def restore_verified(self, template: Optional[TrainState] = None,
                         on_corrupt=None, quarantine: bool = False):
        """Self-healing restore: walk checkpoints newest-first and return
        ``(state, step)`` for the first that restores AND verifies.
        Every corrupt/unreadable step walked past counts
        ``checkpoint.fallback``; raises FileNotFoundError when no
        checkpoint survives (caller decides: fresh start or abort).

        ``quarantine=True`` moves each corrupt step aside via
        :meth:`quarantine_step`; ``on_corrupt(step, path)`` fires per
        corrupt step with its (possibly quarantined) directory path.  A
        step in a format this package does not read raises instead: it
        is not corrupt.  The steps walked past are moved aside (and
        reported) once the walk is over — for a 3D state after a barrier
        of the job's ranks, so every rank walks the same steps.  Catches
        Exception only — an InjectedCrash (BaseException) still kills the
        process, as a real SIGKILL would."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")

        def _condemn(step):
            path = self._step_dir(step)
            if quarantine:
                try:
                    path = self.quarantine_step(step)
                except OSError:
                    pass  # already moved / vanished: the walk continues
            if on_corrupt is not None:
                on_corrupt(step, path)

        found, condemned = None, []
        for step in reversed(steps):
            try:
                found = self.restore(step=step, template=template), step
                break
            except CheckpointFormatError:
                raise
            except CheckpointCorruptError:
                # _read_manifest/_load_leaves already counted it corrupt
                core_telemetry.incr("checkpoint.fallback")
                condemned.append(step)
            except Exception:
                # read errors, a state of another structure, injected
                # checkpoint.read faults: this step is not trustworthy
                # either — keep walking back
                core_telemetry.incr("checkpoint.corrupt")
                core_telemetry.incr("checkpoint.fallback")
                condemned.append(step)
        if isinstance(template, TrainState3D) and _multi_rank():
            import torch.distributed as dist

            # every rank has read the steps it condemns before rank 0
            # moves any of them aside: all walk the same bytes
            dist.barrier()
        for step in condemned:
            _condemn(step)
        if found is None:
            raise FileNotFoundError(
                f"no checkpoint in {self.directory} passed verification "
                f"(tried {len(steps)} steps)")
        return found

    def close(self) -> None:
        """Nothing to wait for: every save is synchronous."""


def _load_into(state: TrainState, module_sd: Dict[str, torch.Tensor],
               optimizer: Dict, step: int) -> None:
    """Overwrite a live state with restored leaves (see the module
    docstring)."""
    state.module.load_state_dict(module_sd, strict=True)
    # param_groups come back from JSON (Adam's betas as a list, which
    # torch.optim reads as it reads the tuple)
    state.optimizer.load_state_dict(optimizer)
    state.optimizer.zero_grad(set_to_none=True)
    state.step = int(step)
    if state.work is not state.module:
        state.work.zero_grad(set_to_none=True)
        with torch.no_grad():
            torch._foreach_copy_(list(state.work.parameters()),
                                 list(state.module.parameters()))


def _load_into_sharded(state: TrainState3D, module_sd, optimizer: Dict,
                       step: int) -> None:
    """A 3D state from restored GLOBAL leaves: each rank copies in its own
    chunk for the state's current plan (the masters, the optimizer's
    per-parameter tensors), then refreshes the working copy."""
    paths = [p for _n, p in state.leaf_paths()]
    names = [n for n, _p in state.leaf_paths()]
    local_sd = {n: _local_of(state, module_sd[n], p)
                for n, p in zip(names, paths)}
    for i, st in optimizer["state"].items():
        for k, v in list(st.items()):
            if isinstance(v, torch.Tensor) and v.dim() > 0:
                st[k] = _local_of(state, v, paths[int(i)])
    _load_into(state, local_sd, optimizer, step)


def save_checkpoint(directory: str, state: TrainState,
                    step: Optional[int] = None,
                    max_to_keep: int = 3) -> int:
    return CheckpointManager(directory, max_to_keep=max_to_keep).save(
        state, step)


def restore_checkpoint(directory: str,
                       template: Optional[TrainState] = None,
                       step: Optional[int] = None,
                       max_to_keep: int = 3):
    return CheckpointManager(directory, max_to_keep=max_to_keep).restore(
        step, template)


def latest_step(directory: str, max_to_keep: int = 3) -> Optional[int]:
    return CheckpointManager(directory, max_to_keep=max_to_keep).latest_step()
