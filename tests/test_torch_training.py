"""The port's training (mmlspark_tpu_torch.models.training, the ResNet's
BatchNorm train mode, DeepVisionClassifier) held against the JAX
package's on bridged weights and the same numpy data.

* A TransformerLM (embed 128, 2 heads -> D 64, 2 layers, vocab 256, seq
  128, batch 2) through 3 steps of `make_lm_train_epoch`, the JAX side on
  its Pallas attention kernels in interpret mode (`_single_tpu` forced, as
  the JAX package's own tests do), the port's autograd through the plain
  B4/B5/B6.  Per-step losses within rtol 1e-4 / atol 1e-5, the tolerance
  of tests/test_training_scan.py:65.  Parameters after the steps: SGD
  (0.1) isolates the gradients, within 2e-5 of each tensor's scale (the
  observed gap is ~1e-6: f32 on both sides, summed in another order);
  Adam (3e-4, as bench.py runs it) within 5e-5 abs — its first updates
  are lr * g / |g|, so an entry's move does not depend on the size of its
  gradient and a rounding gap in a tiny gradient can change it by up to
  2 lr per step; the observed gap is 1.04e-5 on 1 of 65,536 entries of
  one tensor, below 1e-6 elsewhere.
* One ResNet-18 step of `make_train_step` (f32, 32x32, batch 8, SGD 0.1 /
  0.9, two steps so the momentum counts): loss, accuracy and grad_norm
  and every parameter and batch_stats entry (against its tensor's
  scale) within 1e-5 relative after step 1 and 1e-4 after step 2: step
  1's rounding rides a 0.1 * g update with |g| ~ 150 into step 2
  (observed: 2.6e-5 in grad_norm, 1.9e-5 in a conv weight).  res5's maps
  are 1x1, so a running variance updated with the unbiased batch
  variance is 8/7 off.
* `DeepVisionClassifier.fit` (16 images, 2 classes, batch 8, 1 epoch, the
  JAX estimator's initial weights bridged in): the JAX package computes in
  bf16 there (deep_vision.py:132), so `loss_history` within 5e-2 relative
  (bf16 keeps 8 mantissa bits; the two frameworks round convolutions,
  BatchNorm and the residual adds at other points, and the errors grow
  through 2 SGD steps; observed 2%) and the probabilities within 1e-1,
  with the predictions agreeing on at least 90% of the rows.  The JAX
  suite holds two of its own runs to 5e-2 (test_deep_vision.py:91); across
  frameworks bf16 alone moves them further: on this table the port's bf16
  and f32 fits differ by 0.037, and the port's bf16 fit and the JAX
  package's by 0.056-0.061.  These limits still fail a wrong fit: with
  no update (lr 0) the history is 74% off; without momentum, with half
  the learning rate, or with an unshuffled order the probabilities are
  0.39-0.44 off; with another shuffle seed the history is 28% off
  (`test_deep_vision_comparison_fails_a_wrong_fit`).
"""
import functools
import os
from unittest import mock

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.models import deep_vision as JDV
from mmlspark_tpu.models import resnet as JR
from mmlspark_tpu.models import training as JT
from mmlspark_tpu.models import transformer as T
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.models import deep_vision as DV
from mmlspark_tpu_torch.models import training as PT
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.resnet import resnet18

from torch_port_util import (random_flax_variables, random_transformer_params,
                             to_dicts)

torch.set_num_threads(2)

LM = dict(vocab_size=256, embed_dim=128, num_heads=2, num_layers=2,
          max_len=128)
LM_STEPS, LM_BATCH, LM_SEQ = 3, 2, 128
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
ADAM_ATOL = 5e-5
STEP_RTOL = (1e-5, 1e-4)   # ResNet-18 step 1, step 2
DV_PROBS_ATOL = 1e-1


def _mesh1():
    return make_mesh(data=1, devices=jax.devices()[:1])


def _flat(state_dict):
    return {k: np.asarray(v, np.float64) for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")}


def _assert_close_by_scale(got, ref, rel):
    assert sorted(got) == sorted(ref)
    for k in ref:
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(got[k], ref[k], atol=rel * scale, rtol=0,
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _lm_case(opt_name):
    """The JAX side: initial params, tokens, per-step losses and the final
    params (as a port state dict), attention on the Pallas kernels."""
    model = T.transformer_lm(dtype=jnp.float32, **LM)
    tokens = np.random.default_rng(1).integers(
        0, LM["vocab_size"], (LM_STEPS, LM_BATCH, LM_SEQ)).astype(np.int32)
    variables = random_transformer_params(model, jnp.asarray(tokens[0]),
                                          seed=2)
    opt = optax.sgd(0.1) if opt_name == "sgd" else optax.adam(3e-4)
    with mock.patch.object(T, "_single_tpu", lambda: True):
        epoch = JT.make_lm_train_epoch(model, opt, mesh=_mesh1(), donate=False)
        params, _opt_state, losses = epoch(
            variables["params"], opt.init(variables["params"]),
            jnp.asarray(tokens))
    final = from_flax_variables(
        "transformer_lm", {"params": to_dicts(jax.tree.map(np.asarray,
                                                           params))},
        LM, input_shape=(LM_SEQ,), dtype="float32").state_dict
    return variables, tokens, np.asarray(losses), final


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_lm_train_epoch_matches_jax(opt_name):
    variables, tokens, ref_losses, ref_final = _lm_case(opt_name)
    bundle = from_flax_variables("transformer_lm", variables, LM,
                                 input_shape=(LM_SEQ,), dtype="float32")
    opt = PT.sgd(0.1) if opt_name == "sgd" else PT.adam(3e-4)
    state = PT.TrainState.create(bundle.module(torch.device("cpu")), opt,
                                 device="cpu")
    state, losses = PT.make_lm_train_epoch()(state, torch.from_numpy(tokens))
    assert state.step == LM_STEPS and losses.shape == (LM_STEPS,)
    np.testing.assert_allclose(losses.numpy(), ref_losses, **LOSS_TOL)
    got = _flat(state.module.state_dict())
    if opt_name == "sgd":
        _assert_close_by_scale(got, _flat(ref_final), 2e-5)
    else:
        for k, ref in _flat(ref_final).items():
            np.testing.assert_allclose(got[k], ref, atol=ADAM_ATOL, rtol=0,
                                       err_msg=k)


@functools.lru_cache(maxsize=None)
def _resnet_case():
    """The JAX side: metrics and the state (params and batch_stats, as a
    port state dict) after each of two steps."""
    variables = random_flax_variables("resnet18", seed=3, num_classes=10,
                                      hw=32)
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, 8, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (2, 8)).astype(np.int32)
    model = JR.resnet18(num_classes=10, dtype=jnp.float32)
    opt = optax.sgd(0.1, momentum=0.9)
    step = JT.make_train_step(model, opt, 10, mesh=_mesh1(), donate=False)
    state = JT.TrainState(variables["params"], variables["batch_stats"],
                          opt.init(variables["params"]))
    metrics, states = [], []
    for i in range(2):
        state, m = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_flat(from_flax_variables(
            "resnet18", {"params": to_dicts(jax.tree.map(np.asarray,
                                                         state.params)),
                         "batch_stats": to_dicts(jax.tree.map(
                             np.asarray, state.batch_stats))},
            {"num_classes": 10}, input_shape=(32, 32, 3),
            dtype="float32").state_dict))
    return variables, images, labels, metrics, states


def test_resnet18_train_steps_match_jax_with_batch_stats():
    variables, images, labels, ref_metrics, ref_states = _resnet_case()
    bundle = from_flax_variables("resnet18", variables, {"num_classes": 10},
                                 input_shape=(32, 32, 3), dtype="float32")
    state = PT.TrainState.create(bundle.module(torch.device("cpu")),
                                 PT.sgd(0.1, momentum=0.9), device="cpu")
    step = PT.make_train_step(10)
    for i in range(2):
        state, m = step(state, torch.from_numpy(images[i]),
                        torch.from_numpy(labels[i]))
        for k in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), ref_metrics[i][k],
                                       rtol=STEP_RTOL[i],
                                       err_msg=f"step {i} {k}")
        # every parameter and every running statistic (the running
        # variance is the BIASED one: at res5's 1x1 maps the unbiased
        # update would be 8/7 off)
        _assert_close_by_scale(_flat(state.module.state_dict()),
                               ref_states[i], STEP_RTOL[i])


def test_batchnorm_train_mode_updates_running_stats_by_flax_rule():
    bn = resnet18(num_classes=2).blocks[-1].bns[0].train()
    x = torch.randn(8, bn.num_features, 1, 1)
    bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)


def test_bf16_working_copy_keeps_f32_state():
    state = PT.init_train_state(resnet18(num_classes=3), PT.sgd(0.1, 0.9),
                                seed=0, compute_dtype="bfloat16", device="cpu")
    assert state.work is not state.module
    assert all(p.dtype == torch.bfloat16 for p in state.work.parameters())
    assert all(p.dtype == torch.float32 for p in state.module.parameters())
    assert state.work.bn_init.running_var is state.module.bn_init.running_var
    x = torch.randn(4, 32, 32, 3)
    y = torch.tensor([0, 1, 2, 0])
    before = state.module.head.weight.detach().clone()
    state, m = PT.make_train_step(3)(state, x, y)
    assert state.module.bn_init.running_var.dtype == torch.float32
    assert not torch.equal(before, state.module.head.weight)
    torch.testing.assert_close(state.work.head.weight.float(),
                               state.module.head.weight, atol=1e-2, rtol=1e-2)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    # eval mode: the bf16 copy over the f32 running statistics
    pred = PT.make_eval_step()(state, x)
    assert pred.shape == (4,) and pred.dtype == torch.int64
    assert state.work.training


def test_fit_epochs_scanned_and_stepwise_agree():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((24, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 4, 24).astype(np.int32)
    logs = {}
    for mode in ("step", "epoch"):
        state = PT.init_train_state(resnet18(num_classes=4),
                                    PT.sgd(0.05, 0.9), seed=1, device="cpu")
        if mode == "step":
            state, m = PT.fit_epochs(PT.make_train_step(4), state, x, y, 8,
                                     epochs=2, seed=3)
        else:
            state, m = PT.fit_epochs(None, state, x, y, 8, epochs=2, seed=3,
                                     epoch_fn=PT.make_train_epoch(4))
        assert state.step == 6
        logs[mode] = m
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(logs["step"][k], logs["epoch"][k],
                                   rtol=1e-5)


def _color_rows(n, seed):
    rng = np.random.default_rng(seed)
    rows = np.empty(n, object)
    labels = []
    for i in range(n):
        lab = i % 2
        base = np.array([30, 30, 200] if lab else [200, 30, 30], np.uint8)
        rows[i] = np.clip(rng.normal(base, 25, (32, 32, 3)), 0,
                          255).astype(np.uint8)
        labels.append("pos" if lab else "neg")
    return rows, np.asarray(labels, object)


@functools.lru_cache(maxsize=None)
def _deep_vision_case():
    rows, labels = _color_rows(16, seed=8)
    jt = JTable({"image": rows, "label": labels})
    model = JDV.DeepVisionClassifier(backbone="resnet18", epochs=1,
                                     batch_size=8, seed=0).fit(jt)
    probs = np.asarray(model.transform(jt)["probability"], np.float32)
    # the JAX estimator's initial weights (init_train_state's, same seed)
    init = JT.init_train_state(JR.resnet18(num_classes=2, dtype=jnp.bfloat16),
                               optax.sgd(0.05, momentum=0.9), (32, 32, 3),
                               seed=0)
    variables = {"params": to_dicts(jax.tree.map(np.asarray, init.params)),
                 "batch_stats": to_dicts(jax.tree.map(np.asarray,
                                                      init.batch_stats))}
    state = from_flax_variables("resnet18", variables, {"num_classes": 2},
                                input_shape=(32, 32, 3)).state_dict
    return rows, labels, list(model.loss_history), probs, state


def _fit_and_compare_with_jax(monkeypatch):
    """The port's fit from the JAX estimator's initial weights, held
    against the JAX estimator's loss_history and probabilities."""
    rows, labels, ref_history, ref_probs, init_state = _deep_vision_case()

    def jax_init(module, seed, draw=None):
        module.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in init_state.items()})

    monkeypatch.setattr(DV, "_initial_state", jax_init)
    t = Table({"image": rows, "label": labels})
    model = DV.DeepVisionClassifier(backbone="resnet18", epochs=1,
                                    batch_size=8, seed=0, device="cpu").fit(t)
    monkeypatch.undo()
    assert isinstance(model, DV.DeepVisionModel)
    assert sorted(model.classes) == ["neg", "pos"]
    np.testing.assert_allclose(model.loss_history, ref_history, rtol=5e-2)
    out = model.transform(t)
    probs = np.asarray(out["probability"], np.float32)
    assert probs.shape == (16, 2)
    np.testing.assert_allclose(probs, ref_probs, atol=DV_PROBS_ATOL)
    assert (probs.argmax(1) == ref_probs.argmax(1)).mean() >= 0.9
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-4)


def test_deep_vision_fit_matches_jax_estimator(monkeypatch):
    _fit_and_compare_with_jax(monkeypatch)


class _Unshuffled:
    def __init__(self, seed=None):
        pass

    @staticmethod
    def permutation(n):
        return np.arange(n)


_real_sgd, _real_rng = PT.sgd, np.random.default_rng
_FAULTS = {
    "no_update": (PT, "sgd", lambda lr, m=0.0: _real_sgd(0.0, m)),
    "no_momentum": (PT, "sgd", lambda lr, m=0.0: _real_sgd(lr, 0.0)),
    "half_lr": (PT, "sgd", lambda lr, m=0.0: _real_sgd(lr / 2, m)),
    "reshuffled": (np.random, "default_rng",
                   lambda seed=None: _real_rng(seed + 1)),
    "unshuffled": (np.random, "default_rng", _Unshuffled),
}


@pytest.mark.parametrize("fault", sorted(_FAULTS))
def test_deep_vision_comparison_fails_a_wrong_fit(monkeypatch, fault):
    """The limits of the comparison above are loose enough for bf16 in two
    frameworks, and still tell a wrong fit apart: a fit with a planted
    fault (its optimizer or its shuffle order changed) fails them."""
    _deep_vision_case()  # the JAX reference, made without the fault
    monkeypatch.setattr(*_FAULTS[fault])
    with pytest.raises(AssertionError):
        _fit_and_compare_with_jax(monkeypatch)


def test_deep_vision_tail_batch_is_padded_with_zero_weight():
    rows, labels = _color_rows(12, seed=9)
    model = DV.DeepVisionClassifier(backbone="resnet18", epochs=2,
                                    batch_size=8, device="cpu").fit(
        Table({"image": rows, "label": labels}))
    assert len(model.loss_history) == 2
    assert all(np.isfinite(model.loss_history))
    # scoring takes any size: the device preprocess resizes
    wide = np.empty(2, object)
    wide[0] = np.zeros((40, 36, 3), np.uint8)
    wide[1] = np.zeros((32, 32), np.uint8)
    out = model.transform(Table({"image": wide}))
    assert out["probability"].shape == (2, 2)


def test_deep_vision_what_waits_raises_not_implemented(tmp_path):
    """The backbones of the JAX package's models/convnets.py waited for
    ROADMAP A17 and are ported (tests/test_torch_convnets.py): none of
    them raises NotImplementedError now.  AlexNet refuses the default
    32x32 inputs with the reference's ValueError before any checkpoint is
    written, and a convnet fit writes its checkpoint.  (Ragged rows,
    encoded bytes and `checkpoint_dir` are ported:
    tests/test_torch_resumable.py.)"""
    rows, labels = _color_rows(4, seed=10)
    t = Table({"image": rows, "label": labels})
    with pytest.raises(ValueError, match="at least 63x63"):
        DV.DeepVisionClassifier(epochs=1, batch_size=4, device="cpu",
                                backbone="alexnet",
                                checkpoint_dir=str(tmp_path)).fit(t)
    assert not os.listdir(tmp_path)
    model = DV.DeepVisionClassifier(epochs=1, batch_size=4, device="cpu",
                                    backbone="convnet_cifar",
                                    checkpoint_dir=str(tmp_path)).fit(t)
    assert np.all(np.isfinite(model.loss_history))
    assert os.listdir(tmp_path)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows, labels = _color_rows(4, seed=11)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DV.DeepVisionClassifier(epochs=1, batch_size=4).fit(
            Table({"image": rows, "label": labels}))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.init_train_state(resnet18(num_classes=2), PT.sgd(0.1))
