"""The port's classic CNN zoo (mmlspark_tpu_torch.models.convnets: AlexNet,
VGG-11/16, the CIFAR ConvNet) and its weight bridge held against the JAX
package's flax modules on the same weights and inputs, on the CPU.

Every leaf of the flax tree is random (numpy, He-scaled kernels, biases
~ N(0, 0.1)), so a wrong mapping cannot hide behind a zero init; fc1's
rows are in flax's (H, W, C) order, which the port's flatten keeps.

Tolerances.  f32 on both sides: every tap within 1e-4 of the tap's
largest magnitude and the gradients of the mean cross-entropy within
1e-4 of each tensor's largest (the frameworks sum convolutions in
another order; observed about 1e-6).  bf16 on both sides: `pool` within
a relative L2 error of 2e-2 (bf16 keeps 8 mantissa bits; the frameworks
round at other points), as for the ResNet (tests/test_torch_resnet.py).
The JAX gradients are taken with `train=False`, the port's with dropout
off (eval mode): the convnets have no BatchNorm, so dropout is the only
difference between the two modes.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.io.image import array_to_image_row as j_row
from mmlspark_tpu.models import convnets as JC
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu.models.image_featurizer import ImageFeaturizer as JIF

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch.io.image import array_to_image_row as p_row
from mmlspark_tpu_torch.models import convnets as PC
from mmlspark_tpu_torch.models import deep_vision as DV
from mmlspark_tpu_torch.models.bundle import from_flax_variables
from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer as PIF

torch.set_num_threads(2)

CASES = {"alexnet": (63, 63), "vgg11": (32, 32), "vgg16": (32, 32),
         "convnet_cifar": (32, 32)}
NUM_CLASSES = 7


@functools.lru_cache(maxsize=None)
def _variables(name, seed=3):
    h, w = CASES[name]
    module = getattr(JC, name)(num_classes=NUM_CLASSES, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, h, w, 3))))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    return {"params": jax.tree.map(np.asarray, dict(params))}


def _images(name, n=2, seed=11):
    h, w = CASES[name]
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, 3)).astype(np.float32)


def _port_bundle(name, dtype="float32"):
    h, w = CASES[name]
    return from_flax_variables(name, _variables(name),
                               {"num_classes": NUM_CLASSES},
                               input_shape=(h, w, 3), dtype=dtype)


def _jax_taps(name, x, dtype):
    h, w = CASES[name]
    fb = FlaxBundle(name, {"num_classes": NUM_CLASSES, "dtype": dtype},
                    variables=_variables(name), input_shape=(h, w, 3))
    return {k: np.asarray(v, np.float32)
            for k, v in jax.jit(fb.apply)(fb.variables, jnp.asarray(x)).items()}


def _port_taps(bundle, x):
    with torch.inference_mode():
        taps = bundle.apply(bundle.module(torch.device("cpu")),
                            torch.from_numpy(x))
    return {k: v.float().numpy() for k, v in taps.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_tap_matches_flax_in_f32(name):
    x = _images(name)
    ref = _jax_taps(name, x, jnp.float32)
    bundle = _port_bundle(name)
    got = _port_taps(bundle, x)
    module_cls = {"alexnet": PC.AlexNet, "vgg11": PC.VGG, "vgg16": PC.VGG,
                  "convnet_cifar": PC.ConvNetCifar}[name]
    assert bundle.layer_names == module_cls.layer_names
    assert sorted(got) == sorted(ref)
    assert set(bundle.layer_names) <= set(got)
    assert bundle.layer_names[:2] == ["logits", "pool"]
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4 * scale,
                                   rtol=0, err_msg=k)
    assert got["logits"].shape == (2, NUM_CLASSES)
    assert got["pool"].ndim == 2


@pytest.mark.parametrize("name", ["convnet_cifar", "vgg11"])
def test_pool_matches_flax_in_bf16(name):
    x = _images(name)
    ref = _jax_taps(name, x, jnp.bfloat16)["pool"]
    got = _port_taps(_port_bundle(name, "bfloat16"), x)["pool"]
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 2e-2, rel


def test_taps_dtypes_follow_the_reference():
    """conv taps in the compute dtype, dense taps and logits in f32."""
    x = _images("convnet_cifar")
    bundle = _port_bundle("convnet_cifar", "bfloat16")
    with torch.inference_mode():
        taps = bundle.apply(bundle.module(torch.device("cpu")),
                            torch.from_numpy(x))
    assert taps["conv1"].dtype == torch.bfloat16
    assert taps["conv1"].shape == (2, 16, 16, 64)  # NHWC
    assert taps["pool"].dtype == taps["logits"].dtype == torch.float32


def test_alexnet_refuses_small_inputs_with_the_reference_message():
    module = PC.alexnet(num_classes=3, image_size=(63, 63))
    with pytest.raises(ValueError, match="at least 63x63"):
        module(torch.zeros(1, 62, 70, 3))
    assert module(torch.zeros(1, 63, 63, 3))[0].shape == (1, 3)


def test_the_bridge_raises_on_leftover_and_missing_leaves():
    variables = _variables("convnet_cifar")
    extra = {"params": dict(variables["params"], conv9a={
        "kernel": np.zeros((3, 3, 3, 3), np.float32)})}
    with pytest.raises(KeyError, match="conv9a"):
        from_flax_variables("convnet_cifar", extra,
                            {"num_classes": NUM_CLASSES},
                            input_shape=(32, 32, 3))
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "fc1"}}
    with pytest.raises(KeyError, match="fc1"):
        from_flax_variables("convnet_cifar", missing,
                            {"num_classes": NUM_CLASSES},
                            input_shape=(32, 32, 3))


@pytest.mark.parametrize("name", ["convnet_cifar", "alexnet"])
def test_loss_gradients_match_jax_with_dropout_off(name):
    x = _images(name, n=4, seed=12)
    y = np.random.default_rng(13).integers(0, NUM_CLASSES, 4)
    module = getattr(JC, name)(num_classes=NUM_CLASSES, dtype=jnp.float32)
    variables = _variables(name)

    def loss_fn(params):
        logits, _ = module.apply({"params": params}, jnp.asarray(x),
                                 train=False)
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)))

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    h, w = CASES[name]
    want = from_flax_variables(
        name, {"params": jax.tree.map(np.asarray, dict(jgrads))},
        {"num_classes": NUM_CLASSES}, input_shape=(h, w, 3)).state_dict
    net = _port_bundle(name).module(torch.device("cpu")).eval()
    logits, _ = net(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for k, p in net.named_parameters():
        ref = want[k]
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-4 * scale,
                                   rtol=0, err_msg=k)


class _Tail(torch.nn.Module):
    """An identity fc1 (+1) and head, to read the dropout mask."""

    def __init__(self, width=4096):
        super().__init__()
        self.fc1 = torch.nn.Linear(width, width)
        self.head = torch.nn.Linear(width, width)
        self.n_hidden = 1
        with torch.no_grad():
            for lin in (self.fc1, self.head):
                lin.weight.copy_(torch.eye(width))
                lin.bias.zero_()
            self.fc1.bias.fill_(1.0)


def test_dropout_runs_in_train_mode_only_at_rate_half_scaled_by_two():
    tail = _Tail()
    x = torch.rand(8, 4096)
    taps = {}
    torch.manual_seed(0)
    out = PC._run_head(tail.train(), x, taps)
    pool = taps["pool"]
    assert torch.equal(pool, x + 1.0)
    kept = out != 0
    assert torch.equal(out[kept], 2.0 * pool[kept])
    # 32,768 draws at p = 0.5: 4 standard errors is 0.011
    assert abs(float(kept.float().mean()) - 0.5) < 0.011
    taps = {}
    out = PC._run_head(tail.eval(), x, taps)
    assert torch.equal(out, taps["pool"])


def _rows(n, hw=32, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (hw, hw, 3)).astype(np.uint8)
            for _ in range(n)]


def test_image_featurizer_over_a_convnet_bundle():
    arrays = _rows(3)
    jrows = np.empty(3, object)
    prows = np.empty(3, object)
    for i, a in enumerate(arrays):
        jrows[i], prows[i] = j_row(a), p_row(a)
    fb = FlaxBundle("convnet_cifar", {"num_classes": NUM_CLASSES,
                                      "dtype": jnp.float32},
                    variables=_variables("convnet_cifar"),
                    input_shape=(32, 32, 3))
    tb = _port_bundle("convnet_cifar")
    for cut, width in ((1, 512), (0, NUM_CLASSES)):
        ref = np.asarray(JIF(bundle=fb, batch_size=2, cut_output_layers=cut)
                         .transform(JTable({"image": jrows}))["features"])
        got = np.asarray(PIF(bundle=tb, batch_size=2, cut_output_layers=cut,
                             device="cpu")
                         .transform(PTable({"image": prows}))["features"])
        assert got.shape == ref.shape == (3, width)
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_train_step_runs_without_batchnorm():
    from mmlspark_tpu_torch.models import training as PT

    state = PT.init_train_state(PC.convnet_cifar(num_classes=10), PT.sgd(0.05),
                                seed=0, compute_dtype="float32",
                                device="cpu")
    step = PT.make_train_step(10)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 32, 32, 3)).astype(np.float32))
    y = torch.arange(8) % 10
    state, m = step(state, x, y)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("backbone", ["convnet_cifar"])
def test_deep_vision_classifier_fits_and_transforms_a_convnet(backbone):
    arrays = _rows(8, seed=22)
    col = np.empty(8, object)
    for i, a in enumerate(arrays):
        col[i] = a
    labels = np.asarray(["cat", "dog"] * 4)
    model = DV.DeepVisionClassifier(backbone=backbone, epochs=1,
                                    batch_size=4, device="cpu").fit(
        PTable({"image": col, "label": labels}))
    assert len(model.loss_history) == 1
    assert np.all(np.isfinite(model.loss_history))
    out = model.transform(PTable({"image": col}))
    probs = np.asarray(out["probability"])
    assert probs.shape == (8, 2)
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-4)
    assert set(np.asarray(out["prediction"]).tolist()) <= {"cat", "dog"}
