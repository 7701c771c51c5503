"""Resumable, guarded, checkpointed training in the port
(mmlspark_tpu_torch.models.training.fit_epochs_resumable and
DeepVisionClassifier's checkpoint_dir, ragged rows and encoded bytes),
held against the JAX package's.

* The guarded-loop scenarios of tests/test_train_guard.py and the
  kill-and-resume test of tests/test_chaos.py:352-400, run against the
  port on a small dense model (CPU, f32 or bf16 compute): a resumed run
  equals the uninterrupted one bit for bit; a NaN batch is quarantined,
  rolled back past and skipped; a spent rollback budget aborts; a guard
  on a healthy run changes nothing; a corrupted newest checkpoint is
  walked past.
* `fit_epochs_resumable` against the JAX one on a ResNet-18 (32x32, batch
  8, 3 steps, SGD 0.1 / 0.9, checkpoints every 2 steps) on bridged
  weights and the same numpy data: per-step losses within rtol 1e-4 /
  atol 1e-5 (tests/test_torch_training.py's LOSS_TOL; f32 on both sides,
  summed in another order).
* `DeepVisionClassifier` against the JAX estimator on ragged rows (PIL
  resizes them on both sides) and on encoded bytes (the JPEG fixtures,
  decoded by libjpeg on both sides, then resized): loss_history within
  rtol 5e-2 and probabilities within 1e-1 with 90% of the predictions
  agreeing — test_deep_vision_fit_matches_jax_estimator's limits, for
  bf16 compute in two frameworks.  A fit of 1 epoch resumed to 2 on the
  same checkpoint_dir equals the 2-epoch fit bit for bit.
"""
import functools
import glob
import json
import os

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn

import jax
import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.models import deep_vision as JDV
from mmlspark_tpu.models import resnet as JR
from mmlspark_tpu.models import training as JT
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.core import telemetry
from mmlspark_tpu_torch.models import deep_vision as DV
from mmlspark_tpu_torch.models import training as PT
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.checkpoint import MANIFEST_NAME
from mmlspark_tpu_torch.models.guard import TrainingAborted, TrainingGuard
from mmlspark_tpu_torch.utils.faults import FAULTS, FaultPlan, InjectedCrash

from torch_port_util import random_flax_variables, to_dicts

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
DV_HISTORY_RTOL = 5e-2
DV_PROBS_ATOL = 1e-1
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "jpeg_fixtures")


def _counter(name):
    return telemetry.counters().get(name, 0)


class Dense(nn.Module):
    """Flatten -> Dense(16) -> ReLU -> Dense(4): the JAX tests' tiny
    model, computing in its parameters' dtype."""

    def __init__(self):
        super().__init__()
        self.a = nn.Linear(16, 16)
        self.b = nn.Linear(16, 4)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(self.a.weight.dtype)
        return self.b(F.relu(self.a(x))).float(), {}


def _data():
    gen = np.random.default_rng(0)
    return (gen.normal(size=(64, 4, 4, 1)).astype(np.float32),
            gen.integers(0, 4, size=64))


def _fresh(opt="sgd", dtype="float32"):
    torch.manual_seed(0)
    factory = PT.sgd(0.1) if opt == "sgd" else PT.adam(1e-2)
    return PT.TrainState.create(Dense(), factory, compute_dtype=dtype,
                                device="cpu")


def _params(state):
    return {k: v.clone() for k, v in state.module.state_dict().items()}


def _equal(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


KW = dict(batch_size=16, checkpoint_every=4, seed=7)


@pytest.mark.chaos
@pytest.mark.parametrize("opt,dtype", [("sgd", "float32"),
                                       ("adam", "bfloat16")])
def test_training_kill_and_resume_is_bit_exact(tmp_path, opt, dtype):
    imgs, lbls = _data()
    step = PT.make_train_step(4)
    ref, _ = PT.fit_epochs_resumable(step, _fresh(opt, dtype), imgs, lbls,
                                     checkpoint_dir=str(tmp_path / "ref"),
                                     epochs=3, **KW)
    # killed at global step 6 (an un-checkpointed step mid-epoch 1)...
    crash = FaultPlan(seed=1).on("training.step", nth=[6],
                                 error=InjectedCrash)
    with pytest.raises(InjectedCrash):
        with FAULTS.arm(crash):
            PT.fit_epochs_resumable(step, _fresh(opt, dtype), imgs, lbls,
                                    checkpoint_dir=str(tmp_path / "kill"),
                                    epochs=3, **KW)
    assert sorted(os.listdir(tmp_path / "kill")) == ["4"]
    # ...and resumed from the auto-checkpoint: bit-for-bit identical
    res0 = _counter("training.resume")
    res, _ = PT.fit_epochs_resumable(step, _fresh(opt, dtype), imgs, lbls,
                                     checkpoint_dir=str(tmp_path / "kill"),
                                     epochs=3, **KW)
    assert _counter("training.resume") == res0 + 1
    assert ref.step == res.step == 12
    assert _equal(_params(ref), _params(res))
    for a, b in zip(ref.work.parameters(), res.work.parameters()):
        assert torch.equal(a, b)
    sa, sb = ref.optimizer.state_dict(), res.optimizer.state_dict()
    assert all(torch.equal(sa["state"][i][k], sb["state"][i][k])
               for i in sa["state"] for k in sa["state"][i])


@pytest.mark.chaos
def test_checkpoint_write_fault_is_best_effort(tmp_path):
    imgs, lbls = _data()
    before = _counter("checkpoint.write_failed")
    plan = FaultPlan(seed=3).on("checkpoint.write", nth=[1])
    with FAULTS.arm(plan):
        with pytest.warns(RuntimeWarning, match="checkpoint write failed"):
            state, _ = PT.fit_epochs_resumable(
                PT.make_train_step(4), _fresh(), imgs, lbls,
                checkpoint_dir=str(tmp_path), epochs=2, **KW)
        assert FAULTS.fires["checkpoint.write"] == 1
    assert state.step == 8
    assert _counter("checkpoint.write_failed") == before + 1
    assert sorted(os.listdir(tmp_path)) == ["4"]


@pytest.mark.chaos
def test_guarded_loop_quarantines_nan_batch_and_recovers(tmp_path):
    imgs, lbls = _data()
    guard = TrainingGuard(hang_timeout_s=60.0)
    before = {k: _counter(k) for k in
              ("training.rollback", "training.quarantine",
               "training.quarantine.skip")}
    lrs = []

    def factory(lr_scale):
        lrs.append(lr_scale)
        return PT.make_train_step(4, lr_scale=lr_scale)

    plan = FaultPlan(seed=5).on("training.loss_nan", nth=[5])
    with FAULTS.arm(plan):
        state, metrics = PT.fit_epochs_resumable(
            None, _fresh(), imgs, lbls, checkpoint_dir=str(tmp_path),
            epochs=3, guard=guard, step_factory=factory, **KW)
        assert FAULTS.fires["training.loss_nan"] == 1
    assert np.isfinite(metrics["loss"])
    assert guard.quarantined == {5}          # crossing 5 == batch g=5
    assert guard.rollbacks == 1 and lrs == [1.0, 0.5]
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(0.05)
    # schedule ran to the end minus the one quarantined batch
    assert state.step == 12 - 1
    assert all(torch.isfinite(v).all() for v in _params(state).values())
    assert _counter("training.rollback") == before["training.rollback"] + 1
    assert _counter("training.quarantine") == (
        before["training.quarantine"] + 1)
    assert _counter("training.quarantine.skip") == (
        before["training.quarantine.skip"] + 1)
    q = json.loads((tmp_path / "quarantine.json").read_text())
    assert q["quarantined"] == [5]
    assert not guard.running                 # loop joined its watchdog


@pytest.mark.chaos
def test_guard_abort_raises_training_aborted(tmp_path):
    imgs, lbls = _data()
    guard = TrainingGuard(max_rollbacks=1, hang_timeout_s=60.0)
    plan = FaultPlan(seed=5).on("training.loss_nan", probability=1.0)
    with FAULTS.arm(plan):
        with pytest.raises(TrainingAborted, match="rollback budget"):
            PT.fit_epochs_resumable(
                PT.make_train_step(4), _fresh(), imgs, lbls,
                checkpoint_dir=str(tmp_path), epochs=3, guard=guard, **KW)
    assert not guard.running


@pytest.mark.chaos
def test_guard_is_bitwise_passive_on_healthy_runs(tmp_path):
    """The guard observes; it must never perturb the trajectory: a
    guarded run is bit-identical to an unguarded one."""
    imgs, lbls = _data()
    step = PT.make_train_step(4)
    plain, _ = PT.fit_epochs_resumable(
        step, _fresh(), imgs, lbls, checkpoint_dir=str(tmp_path / "plain"),
        epochs=2, **KW)
    guard = TrainingGuard(hang_timeout_s=60.0)
    guarded, _ = PT.fit_epochs_resumable(
        step, _fresh(), imgs, lbls, checkpoint_dir=str(tmp_path / "guarded"),
        epochs=2, guard=guard, **KW)
    assert not guard.anomalies
    assert _equal(_params(plain), _params(guarded))


@pytest.mark.chaos
def test_resume_walks_past_corrupted_checkpoint(tmp_path):
    """Corrupt the newest checkpoint's manifest between kill and resume:
    the loop self-heals from the older verified step, no intervention."""
    imgs, lbls = _data()
    step = PT.make_train_step(4)
    kw = dict(KW, epochs=3, checkpoint_dir=str(tmp_path))
    crash = FaultPlan(seed=1).on("training.step", nth=[9],
                                 error=InjectedCrash)
    with pytest.raises(InjectedCrash):
        with FAULTS.arm(crash):
            PT.fit_epochs_resumable(step, _fresh(), imgs, lbls, **kw)
    steps = sorted(int(p.name) for p in tmp_path.iterdir()
                   if p.name.isdigit())
    assert steps == [4, 8]
    doc_path = tmp_path / "8" / MANIFEST_NAME
    doc = json.loads(doc_path.read_text())
    key = sorted(doc["leaves"])[0]
    doc["leaves"][key]["crc32"] ^= 1
    doc_path.write_text(json.dumps(doc))
    fb0 = _counter("checkpoint.fallback")
    state, metrics = PT.fit_epochs_resumable(step, _fresh(), imgs, lbls,
                                             **kw)
    assert state.step == 12 and np.isfinite(metrics["loss"])
    assert _counter("checkpoint.fallback") == fb0 + 1
    ref, _ = PT.fit_epochs_resumable(step, _fresh(), imgs, lbls,
                                     **dict(kw, checkpoint_dir=str(
                                         tmp_path / "ref")))
    assert _equal(_params(ref), _params(state))


def test_elastic_resume_waits_for_a19(tmp_path):
    """`elastic=` is ported: a single-process job with a quiet
    ElasticContext (one host, its lease beaten every step, each step
    under a hang budget) trains exactly as the loop without it, and
    leaves the membership at epoch 1.  The multi-process shrink runs in
    tests/test_torch_distributed.py."""
    from mmlspark_tpu_torch.parallel import distributed as dist

    imgs, lbls = _data()
    plain, _ = PT.fit_epochs_resumable(
        PT.make_train_step(4), _fresh(), imgs, lbls,
        checkpoint_dir=str(tmp_path / "plain"), epochs=1, **KW)
    host = dist.HostInfo("h0", 0, 1)
    ctx = dist.ElasticContext(
        host, dist.MembershipView(1, [host]),
        monitor=dist.HeartbeatMonitor(["h0"], lease_s=1e9, self_id="h0"),
        coordinator=True, hang_budget_s=60.0)
    state, metrics = PT.fit_epochs_resumable(
        PT.make_train_step(4), _fresh(), imgs, lbls,
        checkpoint_dir=str(tmp_path / "elastic"), epochs=1, elastic=ctx,
        **KW)
    assert _equal(_params(state), _params(plain))
    assert np.isfinite(metrics["loss"]) and ctx.view.epoch == 1


# ---- against the JAX package's loop ---------------------------------------

RESNET_STEPS, RESNET_BATCH = 3, 8


@functools.lru_cache(maxsize=None)
def _jax_resumable_case(ckpt_root):
    """The JAX side: ResNet-18 (f32) through fit_epochs_resumable, its
    per-step metrics."""
    variables = random_flax_variables("resnet18", seed=3, num_classes=10,
                                      hw=32)
    rng = np.random.default_rng(4)
    images = rng.standard_normal(
        (RESNET_STEPS * RESNET_BATCH, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, RESNET_STEPS * RESNET_BATCH).astype(np.int32)
    model = JR.resnet18(num_classes=10, dtype=jnp.float32)
    opt = optax.sgd(0.1, momentum=0.9)
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    step = JT.make_train_step(model, opt, 10, mesh=mesh, donate=False)
    state = JT.TrainState(variables["params"], variables["batch_stats"],
                          opt.init(variables["params"]))
    log = []
    JT.fit_epochs_resumable(step, state, images, labels,
                            batch_size=RESNET_BATCH, checkpoint_dir=ckpt_root,
                            epochs=1, checkpoint_every=2, mesh=mesh, seed=5,
                            log_fn=lambda s, m: log.append(dict(m)))
    return variables, images, labels, log


def test_fit_epochs_resumable_matches_jax(tmp_path_factory):
    variables, images, labels, ref = _jax_resumable_case(
        str(tmp_path_factory.mktemp("jax_ckpt")))
    bundle = from_flax_variables("resnet18", variables, {"num_classes": 10},
                                 input_shape=(32, 32, 3), dtype="float32")
    state = PT.TrainState.create(bundle.module(torch.device("cpu")),
                                 PT.sgd(0.1, momentum=0.9), device="cpu")
    log = []
    d = tmp_path_factory.mktemp("port_ckpt")
    state, _ = PT.fit_epochs_resumable(
        PT.make_train_step(10), state, images, labels,
        batch_size=RESNET_BATCH, checkpoint_dir=str(d), epochs=1,
        checkpoint_every=2, seed=5, log_fn=lambda s, m: log.append(dict(m)))
    assert state.step == RESNET_STEPS and len(log) == len(ref)
    np.testing.assert_allclose([m["loss"] for m in log],
                               [m["loss"] for m in ref], **LOSS_TOL)
    # the same checkpoints: every checkpoint_every steps and the last
    assert sorted(os.listdir(d)) == ["2", "3"]


# ---- DeepVisionClassifier -------------------------------------------------

def _ragged_rows(n, seed):
    """Two colour classes at four sizes, none of them all 32x32 (PIL
    resizes every row of another size on both sides)."""
    rng = np.random.default_rng(seed)
    rows = np.empty(n, object)
    labels = []
    for i in range(n):
        lab = i % 2
        h, w = [(40, 36), (32, 32), (24, 30), (50, 50)][(i // 2) % 4]
        base = np.array([30, 30, 200] if lab else [200, 30, 30], np.uint8)
        rows[i] = np.clip(rng.normal(base, 25, (h, w, 3)), 0,
                          255).astype(np.uint8)
        labels.append("pos" if lab else "neg")
    return rows, np.asarray(labels, object)


def _jpeg_rows(n):
    """The six bench_*.jpg fixtures (256x256, 224x224, 320x240 noise) as a
    bytes column, repeated to n rows, labelled by their fixture index."""
    blobs = []
    for path in sorted(glob.glob(os.path.join(FIXTURES, "bench_*.jpg"))):
        with open(path, "rb") as f:
            blobs.append(f.read())
    rows = np.empty(n, object)
    for i in range(n):
        rows[i] = blobs[i % len(blobs)]
    labels = np.asarray(["a" if (i % len(blobs)) % 2 else "b"
                         for i in range(n)], object)
    return rows, labels


_CASES = {"ragged": lambda: _ragged_rows(16, seed=12),
          "jpeg": lambda: _jpeg_rows(16)}


@functools.lru_cache(maxsize=None)
def _jax_dv_case(kind):
    rows, labels = _CASES[kind]()
    jt = JTable({"image": rows, "label": labels})
    model = JDV.DeepVisionClassifier(backbone="resnet18", epochs=1,
                                     batch_size=8, seed=0).fit(jt)
    probs = np.asarray(model.transform(jt)["probability"], np.float32)
    init = JT.init_train_state(JR.resnet18(num_classes=2, dtype=jnp.bfloat16),
                               optax.sgd(0.05, momentum=0.9), (32, 32, 3),
                               seed=0)
    variables = {"params": to_dicts(jax.tree.map(np.asarray, init.params)),
                 "batch_stats": to_dicts(jax.tree.map(np.asarray,
                                                      init.batch_stats))}
    state = from_flax_variables("resnet18", variables, {"num_classes": 2},
                                input_shape=(32, 32, 3)).state_dict
    return list(model.loss_history), probs, state


def _jax_init(monkeypatch, init_state):
    def jax_init(module, seed):
        module.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in init_state.items()})

    monkeypatch.setattr(DV, "_initial_state", jax_init)


@pytest.mark.parametrize("kind", sorted(_CASES))
def test_deep_vision_matches_jax_estimator_on_ragged_and_jpeg_rows(
        monkeypatch, kind):
    ref_history, ref_probs, init_state = _jax_dv_case(kind)
    rows, labels = _CASES[kind]()
    _jax_init(monkeypatch, init_state)
    t = Table({"image": rows, "label": labels})
    model = DV.DeepVisionClassifier(backbone="resnet18", epochs=1,
                                    batch_size=8, seed=0, device="cpu").fit(t)
    monkeypatch.undo()
    np.testing.assert_allclose(model.loss_history, ref_history,
                               rtol=DV_HISTORY_RTOL)
    probs = np.asarray(model.transform(t)["probability"], np.float32)
    assert probs.shape == (16, 2)
    np.testing.assert_allclose(probs, ref_probs, atol=DV_PROBS_ATOL)
    assert (probs.argmax(1) == ref_probs.argmax(1)).mean() >= 0.9


def test_deep_vision_host_resize_is_pils():
    """The ragged rows reach the device as PIL's resize of each row (the
    JAX package's call, on the BGR -> RGB -> BGR round trip)."""
    rows, _ = _ragged_rows(4, seed=13)
    seen = []
    for a in rows:
        got = DV._to_hw(a, 32, 32)
        want = np.asarray(Image.fromarray(a[:, :, ::-1]).resize(
            (32, 32)))[:, :, ::-1]
        np.testing.assert_array_equal(got, want)
        seen.append(got.shape)
    assert seen == [(32, 32, 3)] * 4
    gray = DV._to_hw(np.zeros((20, 10), np.uint8), 32, 32)
    assert gray.shape == (32, 32, 3)


def test_deep_vision_resumed_fit_equals_the_uninterrupted_fit(tmp_path):
    """1 epoch on a checkpoint_dir, then 2 on the same one: the second fit
    restores epoch 1's state, replays its shuffle draw and trains epoch 2
    only, ending bit for bit where a 2-epoch fit ends (ragged rows and
    JPEG bytes in one column)."""
    rows, labels = _ragged_rows(12, seed=14)
    jpeg_rows, _ = _jpeg_rows(4)
    rows = np.concatenate([rows, jpeg_rows])
    labels = np.concatenate([labels, np.asarray(["pos", "neg"] * 2, object)])
    t = Table({"image": rows, "label": labels})
    kw = dict(backbone="resnet18", batch_size=8, seed=3, device="cpu")
    full = DV.DeepVisionClassifier(epochs=2, **kw).fit(t)
    first = DV.DeepVisionClassifier(epochs=1, checkpoint_dir=str(tmp_path),
                                    **kw).fit(t)
    assert sorted(os.listdir(tmp_path)) == ["1"]
    resumed = DV.DeepVisionClassifier(epochs=2, checkpoint_dir=str(tmp_path),
                                      **kw).fit(t)
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]
    assert first.loss_history == full.loss_history[:1]
    assert resumed.loss_history == full.loss_history[1:]
    a, b = full.bundle.state_dict, resumed.bundle.state_dict
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(full.transform(t)["probability"],
                                  resumed.transform(t)["probability"])
    # a directory checkpointed at >= epochs trains nothing more
    again = DV.DeepVisionClassifier(epochs=2, checkpoint_dir=str(tmp_path),
                                    **kw).fit(t)
    assert again.loss_history == []


def test_undecodable_bytes_rows_are_dropped_or_raise():
    rows, labels = _jpeg_rows(6)
    rows[2] = b"\xff\xd8\xff not a jpeg"
    t = Table({"image": rows, "label": labels})
    model = DV.DeepVisionClassifier(epochs=1, batch_size=4,
                                    device="cpu").fit(t)
    assert len(model.loss_history) == 1
    with pytest.raises(ValueError, match="drop_na=False"):
        DV.DeepVisionClassifier(epochs=1, batch_size=4, device="cpu",
                                drop_na=False).fit(t)
