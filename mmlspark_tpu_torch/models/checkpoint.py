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

Not here: format 2 (a crc32 per shard of a sharded leaf) waits for the
port's sharded trainer (ROADMAP A19) and raises `NotImplementedError`;
a step directory that orbax wrote (the JAX package's checkpoints) is
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


class CheckpointManager:
    """Step directories under `directory` with retention (`max_to_keep`
    newest steps) and per-leaf checksum manifests."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

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
        final = self._step_dir(mgr_step)
        if os.path.exists(final):
            raise ValueError(f"checkpoint step {mgr_step} already exists in "
                             f"{self.directory}")
        tmp = os.path.join(self.directory,
                           f".tmp-{mgr_step}-{os.getpid()}-{time.time_ns()}")
        os.makedirs(tmp)
        try:
            entries: Dict[str, Dict[str, Any]] = {}
            for n, (key, t) in enumerate(_leaves(state).items()):
                arr = _host(t)
                name = f"{n:05d}.npy"
                _write_file(os.path.join(tmp, name),
                            lambda f, a=arr: np.save(f, a))
                entries[key] = dict(_digest(arr), file=name,
                                    dtype=str(t.dtype).replace("torch.", ""))
            groups = _groups_doc(state)
            _write_file(os.path.join(tmp, _GROUPS_FILE),
                        lambda f: f.write(groups))
            entries[_GROUPS] = {"crc32": zlib.crc32(groups), "shape": [],
                                "file": _GROUPS_FILE, "dtype": "json"}
            doc = json.dumps({"format": 1, "step": mgr_step,
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
        return mgr_step

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and
                      os.path.isdir(os.path.join(self.directory, n)))

    def delete(self, step: int) -> None:
        """Drop one step (leaves + manifest) — used when a rollback
        replay re-saves a schedule position it already passed."""
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
        os.replace(self._step_dir(step), dst)
        core_telemetry.incr("checkpoint.quarantine")
        return dst

    # ------------------------------------------------------ integrity

    def _read_manifest(self, step: int) -> Dict:
        """The step's manifest.  Raises CheckpointFormatError for a step
        orbax wrote, NotImplementedError for format 2, and
        CheckpointCorruptError for a missing or torn manifest."""
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
        if doc.get("format") != 1:
            raise NotImplementedError(
                f"checkpoint step {step} in {self.directory} is format "
                f"{doc.get('format')!r} (per-shard): the port's sharded "
                "trainer is not ported yet (ROADMAP A19)")
        return doc

    def _load_leaves(self, step: int) -> Dict[str, Any]:
        """Every leaf of the step, verified against its manifest (raises
        CheckpointCorruptError on any mismatch or unreadable leaf)."""
        doc = self._read_manifest(step)
        step_dir = self._step_dir(step)
        leaves: Dict[str, Any] = {}
        bad: List[str] = []
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
                    t_verify += time.perf_counter() - t0
                    leaves[key] = arr
            except (OSError, ValueError, EOFError) as e:
                bad.append(f"{key} unreadable ({e})")
                continue
            if not ok:
                bad.append(f"{key} checksum mismatch")
        core_telemetry.histogram("checkpoint.verify.latency").observe(
            t_verify)
        if bad:
            core_telemetry.incr("checkpoint.corrupt")
            raise CheckpointCorruptError(
                f"checkpoint step {step} in {self.directory} failed "
                f"verification: {len(bad)} leaves bad: "
                + "; ".join(bad[:5]))
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
        leaves = self._load_leaves(step)
        groups = leaves["groups"]
        opt_state = leaves["optimizer_state"]
        for i, extra in groups["state_scalars"].items():
            opt_state.setdefault(int(i), {}).update(extra)
        optimizer = {"state": opt_state,
                     "param_groups": groups["param_groups"]}
        if template is None:
            return {"module": leaves["module"], "optimizer": optimizer,
                    "step": leaves["step"]}
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
        is not corrupt.  Catches Exception only — an InjectedCrash
        (BaseException) still kills the process, as a real SIGKILL
        would."""
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

        for step in reversed(steps):
            try:
                return self.restore(step=step, template=template), step
            except (CheckpointFormatError, NotImplementedError):
                raise
            except CheckpointCorruptError:
                # _read_manifest/_load_leaves already counted it corrupt
                core_telemetry.incr("checkpoint.fallback")
                _condemn(step)
            except Exception:
                # read errors, a state of another structure, injected
                # checkpoint.read faults: this step is not trustworthy
                # either — keep walking back
                core_telemetry.incr("checkpoint.corrupt")
                core_telemetry.incr("checkpoint.fallback")
                _condemn(step)
        raise FileNotFoundError(
            f"no checkpoint in {self.directory} passed verification "
            f"(tried {len(steps)} steps)")

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
