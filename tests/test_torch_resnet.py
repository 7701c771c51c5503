"""The port's ResNet (mmlspark_tpu_torch.models.resnet) and the weight
bridge (`from_flax_variables`) held against the JAX package's flax ResNet
on the same weights and inputs.

Every leaf of the flax tree is filled with numpy random values, BN
statistics included (scale and var in U(0.5, 1.5), He-scaled convs), not
taken from flax's init: its last BN of every block starts at scale 0,
which zeroes every residual branch and would let a wrong conv mapping
pass.

Tolerances.  f32 on both sides: every tap within 1e-4 of the tap's
largest magnitude (the two frameworks sum convolutions in a different
order; the observed gap is about 1e-6).  bf16 on both sides: `pool`
within a relative L2 error of 2e-2 — bf16 keeps 8 mantissa bits
(rounding error ~4e-3 per op), the frameworks round at different points
(flax's BatchNorm and the residual adds run in bf16, and XLA and
PyTorch's CPU convolutions round their outputs differently), and those
errors add up over 20 to 50 layers to about 1e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import resnet as JR
from mmlspark_tpu.models.bundle import FlaxBundle
from mmlspark_tpu_torch.models.bundle import (TorchBundle, from_flax_variables,
                                              get_builder, init_state_dict)
from mmlspark_tpu_torch.models.zoo import ModelRepo, get_or_create_resnet

from torch_port_util import random_flax_variables

torch.set_num_threads(2)

HW = 32
NUM_CLASSES = 10


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def case(request):
    name = request.param
    variables = random_flax_variables(name, seed=7, num_classes=NUM_CLASSES,
                                      hw=HW)
    x = np.random.default_rng(11).standard_normal(
        (2, HW, HW, 3)).astype(np.float32)
    return name, variables, x


def _jax_taps(name, variables, x, dtype):
    fb = FlaxBundle(name, {"num_classes": NUM_CLASSES, "dtype": dtype},
                    variables=variables, input_shape=(HW, HW, 3))
    taps = jax.jit(fb.apply)(fb.variables, jnp.asarray(x))
    return {k: np.asarray(v, np.float32) for k, v in taps.items()}


def _port_taps(name, variables, x, dtype):
    tb = from_flax_variables(name, variables, {"num_classes": NUM_CLASSES},
                             input_shape=(HW, HW, 3), dtype=dtype)
    with torch.inference_mode():
        taps = tb.apply(tb.module(torch.device("cpu")), torch.from_numpy(x))
    return {k: v.float().numpy() for k, v in taps.items()}


def test_every_tap_matches_flax_in_f32(case):
    name, variables, x = case
    ref = _jax_taps(name, variables, x, jnp.float32)
    got = _port_taps(name, variables, x, "float32")
    assert sorted(got) == sorted(ref) == sorted(JR.LAYER_NAMES)
    for k in JR.LAYER_NAMES:
        assert got[k].shape == ref[k].shape, k
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


def test_pool_matches_flax_in_bf16(case):
    name, variables, x = case
    ref = _jax_taps(name, variables, x, jnp.bfloat16)["pool"]
    got = _port_taps(name, variables, x, "bfloat16")["pool"]
    assert got.shape == ref.shape == (2, 512 if name == "resnet18" else 2048)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel <= 2e-2, rel


def test_bridge_raises_on_leftover_and_missing_leaves(case):
    name, variables, _x = case
    extra = {"params": dict(variables["params"]),
             "batch_stats": variables["batch_stats"]}
    extra["params"]["head"] = dict(extra["params"]["head"],
                                   extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError):
        from_flax_variables(name, extra, {"num_classes": NUM_CLASSES})
    missing = {"params": dict(variables["params"]),
               "batch_stats": variables["batch_stats"]}
    del missing["params"]["head"]
    with pytest.raises(KeyError):
        from_flax_variables(name, missing, {"num_classes": NUM_CLASSES})
    stray = {"params": variables["params"],
             "batch_stats": variables["batch_stats"], "kvcache": {}}
    with pytest.raises(KeyError):
        from_flax_variables(name, stray, {"num_classes": NUM_CLASSES})
    with pytest.raises(ValueError):
        from_flax_variables(name, variables, {"num_classes": NUM_CLASSES + 1})


def test_zoo_seeds_and_reloads_random_init(tmp_path):
    repo = ModelRepo(str(tmp_path))
    a = get_or_create_resnet("resnet18", (HW, HW, 3), NUM_CLASSES, repo=repo)
    b = get_or_create_resnet("resnet18", (HW, HW, 3), NUM_CLASSES, repo=repo)
    assert repo.list_models() == [f"resnet18_{HW}x{HW}_{NUM_CLASSES}"]
    assert b.bundle_id == a.bundle_id
    again = TorchBundle("resnet18", {"num_classes": NUM_CLASSES}, seed=0)
    for k, v in a.state_dict.items():
        np.testing.assert_array_equal(v, again.state_dict[k])
    # flax's zero-init of each residual branch's last BatchNorm
    assert not a.state_dict["blocks.0.bns.1.weight"].any()
    assert a.state_dict["blocks.0.bns.0.weight"].all()


@pytest.mark.parametrize("random_bn", [False, True])
def test_random_bn_init_lets_every_branch_count(random_bn):
    """Under flax's init every residual branch ends in a zero-scale
    BatchNorm, so a branch's 3x3 conv cannot change the output; under
    `random_bn` it must (numerical checks of the card's forward use it)."""
    module = get_builder("resnet18")(num_classes=NUM_CLASSES)
    sd = init_state_dict(module, seed=3, random_bn=random_bn)
    bns = [k for k in sd if ".bns." in k and k.endswith(".weight")]
    assert all(sd[k].all() for k in bns) == random_bn
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, HW, HW, 3)).astype(np.float32))

    def pool(state):
        module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
        with torch.inference_mode():
            return module.eval()(x)[1]["pool"].numpy()

    broken = dict(sd, **{"blocks.3.convs.0.weight":
                         np.zeros_like(sd["blocks.3.convs.0.weight"])})
    changed = np.abs(pool(broken) - pool(sd)).max() > 1e-3 * np.abs(pool(sd)).max()
    assert changed == random_bn
