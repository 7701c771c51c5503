"""The plain references against the program at tiny widths on seeded
weights, PIL's resize against PIL, and the stage's initial weights drawn
again from the seed."""
import numpy as np
import pytest
import torch

from perfbench.harness import data
from perfbench.reference import preprocess, resnet, vit
from perfbench.tests import tiny

RESNET_TINY = {"stage_sizes": [1, 1], "width": 64, "num_classes": 10,
               "image_size": [32, 32]}
VIT_TINY = {"patch_size": 16, "hidden_size": 192, "num_hidden_layers": 12,
            "num_attention_heads": 3, "intermediate_size": 768,
            "num_labels": 10, "image_size": [32, 32]}


@pytest.fixture
def images():
    g = torch.Generator().manual_seed(3)
    return torch.randint(0, 256, (3, 40, 50, 3), dtype=torch.uint8,
                         generator=g)


def test_resize_normalize_is_the_programs(images):
    from mmlspark_tpu_torch.ops.image_kernels import fused_resize_normalize

    for hw in ((32, 32), (40, 50), (64, 48)):
        got = fused_resize_normalize(images, *hw, preprocess.IMAGENET_MEAN_BGR,
                                     preprocess.IMAGENET_STD_BGR)
        want = preprocess.resize_normalize(images, *hw)
        assert torch.allclose(got, want, atol=1e-5, rtol=0)


def test_resnet_reference_matches_the_port(images):
    from mmlspark_tpu_torch.models import bundle

    tiny.register_builders()
    w = data.make_weights(resnet.param_shapes(RESNET_TINY), 7, "cpu")
    b = bundle.TorchBundle(tiny.RESNET_TINY, {"num_classes": 10},
                           state_dict={k: v.numpy() for k, v in w.items()},
                           input_shape=(32, 32, 3), dtype="float32")
    x = preprocess.resize_normalize(images, 32, 32)
    with torch.no_grad():
        got = b.apply(b.module("cpu"), x)["pool"]
        want = resnet.features(w, x, RESNET_TINY)
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_vit_reference_draws_the_stage_init_and_matches_the_port(images):
    from mmlspark_tpu_torch.models import vit as port_vit
    from mmlspark_tpu_torch.models.bundle import init_state_dict

    m = port_vit.vit_tiny(num_classes=10, image_size=32)
    init_state_dict(m, 11)
    w = vit.init_weights(VIT_TINY, 11)
    assert set(w) == set(m.state_dict())
    for k, v in m.state_dict().items():
        assert torch.equal(v, w[k]), k
    x = preprocess.resize_normalize(images, 32, 32)
    with torch.no_grad():
        got = m(x)[0]
        want = vit.logits(w, x, VIT_TINY)
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_vit_reference_gradients_match_autograd_on_the_port(images):
    from mmlspark_tpu_torch.models import vit as port_vit
    from mmlspark_tpu_torch.models.training import _per_example_ce

    m = port_vit.vit_tiny(num_classes=10, image_size=32)
    w = vit.init_weights(VIT_TINY, 5)
    m.load_state_dict(w)
    x = preprocess.resize_normalize(images, 32, 32)
    y = torch.tensor([1, 4, 9])
    _per_example_ce(m(x)[0], y).mean().backward()
    loss, grads = vit.loss_and_grads(w, lambda lo, hi: x[lo:hi], y, VIT_TINY,
                                     micro=2)
    for name, p in m.named_parameters():
        assert torch.allclose(p.grad, grads[name], atol=1e-6, rtol=1e-4), name


@pytest.mark.parametrize("hw", [(256, 256), (320, 240), (375, 500),
                                (224, 224), (20, 300)])
def test_pil_resize_is_pils(hw):
    from PIL import Image

    rng = np.random.default_rng(hw[0])
    x = rng.integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    got = preprocess.pil_bicubic_resize(torch.from_numpy(x), 224, 224).numpy()
    want = np.stack([np.asarray(Image.fromarray(
        np.ascontiguousarray(a[:, :, ::-1])).resize((224, 224)))[:, :, ::-1]
        for a in x])
    assert np.array_equal(got, want)


def test_sgd_momentum_is_torchs():
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    opt = torch.optim.SGD([p], lr=0.1, momentum=0.9)
    w, buf = {"p": p.detach().clone()}, {}
    for g in ([0.5, 1.0], [-1.0, 2.0], [0.25, 0.0]):
        p.grad = torch.tensor(g)
        opt.step()
        vit.sgd_momentum_step(w, buf, {"p": torch.tensor(g)}, 0.1, 0.9)
    assert torch.allclose(w["p"], p.detach())
