"""The port's verified checkpoints (mmlspark_tpu_torch.models.checkpoint):
the checkpoint scenarios of tests/test_train_guard.py run against the
port — a uniform missing-step error, retention through the module
helpers, the format-1 manifest and its verification, a truncated leaf
and a flipped or torn manifest walked past — plus what the port's
in-place state needs: a restore into a live state that a poisoned step
filled with NaN leaves the masters, the optimizer's state, the BatchNorm
buffers and the bf16 working copy equal to the saved ones, bit for bit.
A step that orbax wrote (the JAX package's CheckpointManager) is refused
with a clear error, and a format-2 manifest restores only into the 3D
trainer's state.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.models import training as PT
from mmlspark_tpu_torch.models.checkpoint import (
    MANIFEST_NAME, CheckpointCorruptError, CheckpointFormatError,
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint)
from mmlspark_tpu_torch.utils.faults import FAULTS, FaultPlan

torch.set_num_threads(2)


def _counter(name):
    return telemetry.counters().get(name, 0)


class Tiny(nn.Module):
    """Dense -> BatchNorm -> Dense, with a bf16 buffer beside the f32
    ones (a checkpoint stores bf16 as its 16-bit pattern; `_fresh` puts
    it back to bf16 after `TrainState.create` casts the module to f32); it
    computes in its parameters' dtype, the BatchNorm in f32 over f32
    statistics."""

    def __init__(self):
        super().__init__()
        self.a = nn.Linear(16, 16)
        self.bn = nn.BatchNorm1d(16)
        self.b = nn.Linear(16, 4)
        self.register_buffer("scale", torch.full((4,), 1.5,
                                                 dtype=torch.bfloat16))

    def forward(self, x):
        h = self.a(x.reshape(x.shape[0], -1).to(self.a.weight.dtype))
        bn = self.bn
        if self.training:
            bn.num_batches_tracked.add_(1)
        h = F.batch_norm(h.float(), bn.running_mean, bn.running_var,
                         bn.weight.float(), bn.bias.float(), self.training,
                         bn.momentum, bn.eps)
        out = self.b(torch.relu(h).to(self.b.weight.dtype))
        return out.float() * self.scale.float(), {}


def _fresh(opt="sgd", dtype="float32"):
    torch.manual_seed(0)
    factory = PT.sgd(0.1, 0.9) if opt == "sgd" else PT.adam(1e-2)
    state = PT.TrainState.create(Tiny(), factory, compute_dtype=dtype,
                                 device="cpu")
    state.module.scale = state.work.scale = state.module.scale.to(
        torch.bfloat16)
    return state


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(8, 4, 4, 1)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 4, 8)))


def _trained(opt="sgd", dtype="float32", steps=3):
    state = _fresh(opt, dtype)
    step = PT.make_train_step(4)
    for i in range(steps):
        state, _ = step(state, *_batch(i))
    return state


def _snapshot(state):
    """Every number of the state: masters + buffers, the optimizer's state
    tensors, the working copy's parameters, the step."""
    out = {f"module/{k}": v.clone() for k, v in
           state.module.state_dict().items()}
    for i, st in state.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            out[f"opt/{i}/{k}"] = v.clone()
    for i, p in enumerate(state.work.parameters()):
        out[f"work/{i}"] = p.detach().clone()
    out["step"] = torch.tensor(state.step)
    return out


def _assert_bitwise_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].view(torch.uint8) if a[k].dim() else a[k],
                           b[k].view(torch.uint8) if b[k].dim() else b[k]), k


def test_explicit_missing_step_raises_uniform_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(_fresh(), step=1)
    with pytest.raises(FileNotFoundError, match="step 99"):
        mgr.restore(step=99)
    with pytest.raises(FileNotFoundError, match="step 99"):
        restore_checkpoint(str(tmp_path), step=99)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"))
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(_fresh(), step=1)


def test_module_helpers_thread_max_to_keep(tmp_path):
    state = _fresh()
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path), state, step=s, max_to_keep=2)
    assert latest_step(str(tmp_path), max_to_keep=2) == 3
    kept = sorted(int(p.name) for p in tmp_path.iterdir()
                  if p.name.isdigit())
    assert kept == [2, 3]  # retention honored by the throwaway managers
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


def test_save_writes_manifest_and_restore_verifies(tmp_path):
    state = _trained("adam", "bfloat16")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=5)
    doc = json.loads((tmp_path / "5" / MANIFEST_NAME).read_text())
    assert doc["format"] == 1 and doc["step"] == 5
    assert doc["state_step"] == 3
    leaves = doc["leaves"]
    assert leaves["module/scale"]["dtype"] == "bfloat16"
    assert leaves["optimizer/state/0/exp_avg_sq"]["dtype"] == "float32"
    assert leaves["module/bn.num_batches_tracked"]["dtype"] == "int64"
    assert leaves["optimizer/param_groups"]["dtype"] == "json"
    for entry in leaves.values():
        assert (tmp_path / "5" / entry["file"]).exists()
    before = telemetry.histogram(
        "checkpoint.verify.latency").snapshot()["count"]
    out = mgr.restore(step=5, template=_fresh("adam", "bfloat16"))
    assert out.step == 3
    assert telemetry.histogram(
        "checkpoint.verify.latency").snapshot()["count"] == before + 1
    _assert_bitwise_equal(_snapshot(out), _snapshot(state))
    raw = mgr.restore(step=5)  # no template: the verified leaves
    assert raw["step"] == 3 and raw["module"]["scale"].dtype == torch.bfloat16
    assert set(raw["optimizer"]) == {"state", "param_groups"}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_into_a_nan_poisoned_live_state(tmp_path, opt, dtype):
    """The port's step runs in place: after a poisoned step the masters,
    the optimizer's moments (and Adam's step count), the running
    statistics and the bf16 working copy all hold NaN or moved on.  A
    restore into that live state brings back every saved number, and the
    next step equals the step from the saved state."""
    state = _trained(opt, dtype)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=3)
    saved = _snapshot(state)
    step = PT.make_train_step(4)
    x, y = _batch(10)
    state, m = step(state, torch.full_like(x, float("nan")), y)
    assert not np.isfinite(float(m["loss"]))
    poisoned = _snapshot(state)
    assert torch.isnan(poisoned["module/a.weight"]).all()
    assert torch.isnan(poisoned["module/bn.running_mean"]).all()
    assert torch.isnan(poisoned["work/0"].float()).all()
    key = "opt/0/momentum_buffer" if opt == "sgd" else "opt/0/exp_avg"
    assert torch.isnan(poisoned[key]).all()
    live = (state.module, state.optimizer, state.work)
    out = mgr.restore(step=3, template=state)
    assert (out.module, out.optimizer, out.work) == live  # in place
    _assert_bitwise_equal(_snapshot(out), saved)
    # the buffers stay shared with the working copy
    assert state.work.bn.running_var is state.module.bn.running_var
    # and the trajectory continues as from the saved state
    ref = _trained(opt, dtype)
    _, m_ref = step(ref, x, y)
    _, m_got = step(out, x, y)
    assert float(m_got["loss"]) == float(m_ref["loss"])
    _assert_bitwise_equal(_snapshot(out), _snapshot(ref))


@pytest.mark.chaos
def test_truncated_leaf_falls_back_to_older_verified_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _trained()
    mgr.save(s, step=1)
    mgr.save(s, step=2)
    doc = json.loads((tmp_path / "2" / MANIFEST_NAME).read_text())
    victim = tmp_path / "2" / doc["leaves"]["module/a.weight"]["file"]
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    c0 = telemetry.export_snapshot()["counters"]
    state, step = mgr.restore_verified(template=_fresh())
    c1 = telemetry.export_snapshot()["counters"]
    assert step == 1 and state.step == s.step
    _assert_bitwise_equal(_snapshot(state), _snapshot(s))
    assert c1.get("checkpoint.corrupt", 0) > c0.get("checkpoint.corrupt", 0)
    assert c1.get("checkpoint.fallback", 0) > c0.get("checkpoint.fallback",
                                                     0)
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        mgr.restore(step=2, template=_fresh())


@pytest.mark.chaos
def test_flipped_manifest_byte_detected_and_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _trained()
    mgr.save(s, step=1)
    mgr.save(s, step=2)
    manifest = tmp_path / "2" / MANIFEST_NAME
    doc = json.loads(manifest.read_text())
    key = sorted(doc["leaves"])[0]
    doc["leaves"][key]["crc32"] ^= 1
    manifest.write_text(json.dumps(doc))
    with pytest.raises(CheckpointCorruptError, match="mismatch"):
        mgr.restore(step=2, template=_fresh())
    _, step = mgr.restore_verified(template=_fresh())
    assert step == 1
    # a torn (unparseable) manifest is treated as corrupt too, and so is
    # a step directory without one
    manifest.write_text("{torn")
    with pytest.raises(CheckpointCorruptError, match="torn"):
        mgr.restore(step=2, template=_fresh())
    manifest.unlink()
    with pytest.raises(CheckpointCorruptError, match="no manifest"):
        mgr.restore(step=2, template=_fresh())
    assert telemetry.export_snapshot()["counters"].get(
        "checkpoint.corrupt", 0) >= 3


@pytest.mark.chaos
def test_corrupt_steps_are_quarantined_on_the_walk(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _trained()
    for step in (1, 2, 3):
        mgr.save(s, step=step)
    for step in (2, 3):
        victim = tmp_path / str(step) / "param_groups.json"
        victim.write_bytes(victim.read_bytes() + b" ")
    seen = []
    q0 = _counter("checkpoint.quarantine")
    _, step = mgr.restore_verified(
        template=_fresh(), quarantine=True,
        on_corrupt=lambda st, path: seen.append((st, path)))
    assert step == 1 and mgr.all_steps() == [1]
    assert [st for st, _ in seen] == [3, 2]
    assert all(os.path.isdir(p) and "quarantined" in p for _, p in seen)
    assert _counter("checkpoint.quarantine") == q0 + 2


@pytest.mark.chaos
def test_read_fault_walks_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    s = _trained()
    mgr.save(s, step=1)
    mgr.save(s, step=2)
    with FAULTS.arm(FaultPlan(seed=2).on("checkpoint.read", nth=[0])):
        _, step = mgr.restore_verified(template=_fresh())
        assert FAULTS.fires["checkpoint.read"] == 1
    assert step == 1


def test_a_checkpoint_of_another_model_is_not_loaded(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_trained(), step=1)
    other = PT.TrainState.create(nn.Sequential(nn.Linear(3, 2)), PT.sgd(0.1),
                                 device="cpu")
    with pytest.raises(RuntimeError):
        mgr.restore(step=1, template=other)


def test_orbax_directory_of_the_jax_package_is_refused(tmp_path):
    """A step the JAX package's CheckpointManager (orbax) wrote is not a
    corrupt checkpoint of the port: the port refuses it by name and
    leaves it where it is."""
    import jax.numpy as jnp
    import optax
    import flax.linen as fnn

    from mmlspark_tpu.models.checkpoint import CheckpointManager as JCM
    from mmlspark_tpu.models.training import init_train_state

    class M(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            return fnn.Dense(4)(x.reshape((x.shape[0], -1))), {}

    jstate = init_train_state(M(), optax.sgd(0.1), (4, 4, 1), seed=0)
    jm = JCM(str(tmp_path))
    try:
        jm.save(jstate, step=4)
    finally:
        jm.close()
    assert jnp is not None
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [4]
    msg = "written by orbax.*from_flax_variables"
    with pytest.raises(CheckpointFormatError, match=msg):
        mgr.restore(step=4, template=_fresh())
    with pytest.raises(CheckpointFormatError, match=msg):
        mgr.restore_verified(template=_fresh(), quarantine=True)
    assert mgr.all_steps() == [4]  # not quarantined


def test_format_2_manifest_waits_for_a19(tmp_path):
    """Format 2 (per-shard, the 3D trainer's) restores only into a
    TrainState3D: into a plain TrainState it is refused as a format
    error — not walked past as corrupt (tests/test_torch_trainer3d.py
    covers the format-2 round trip)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_fresh(), step=1)
    manifest = tmp_path / "1" / MANIFEST_NAME
    doc = json.loads(manifest.read_text())
    doc["format"] = 2
    manifest.write_text(json.dumps(doc))
    with pytest.raises(CheckpointFormatError, match="format 2"):
        mgr.restore(step=1, template=_fresh())
    with pytest.raises(CheckpointFormatError, match="format 2"):
        mgr.restore_verified(template=_fresh())
    assert mgr.all_steps() == [1]  # not quarantined
