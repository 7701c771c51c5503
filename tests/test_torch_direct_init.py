"""`bundle.DirectInit` (the fit's initial weights put straight onto the
device) against `bundle.init_state_dict` on a module its builder made:
every entry of the state dict equal bit for bit, at the backbones' smallest
inputs, two seeds (three for the ViTs and the ResNet) and with
`random_bn`, and the same parameters (names,
shapes, dtypes, layouts, trainable).  One flat draw would not do: torch's
CPU normal fill pairs values within a tensor and redraws the tail of one
whose length is not a multiple of 16, so each leaf is drawn into its own
slice."""
import pytest
import torch
from torch import nn

from mmlspark_tpu_torch.models.bundle import (DirectInit, _builder_kwargs,
                                              get_builder, init_state_dict)

torch.set_num_threads(2)

# the smallest input each backbone builds for: one ViT patch, one pooled
# cell of the CIFAR convnet, AlexNet's 63 px; a ResNet takes any size
SMALLEST = {"vit_tiny": (16, 16), "vit_base": (16, 16), "resnet18": (32, 32),
            "convnet_cifar": (8, 8), "alexnet": (63, 63)}
CASES = [(name, seed, False) for name in SMALLEST for seed in (0, 11)] + [
    ("resnet18", seed, True) for seed in (0, 11)] + [
    (name, 2 ** 31 + 3, False) for name in ("vit_tiny", "vit_base",
                                            "resnet18")]


@pytest.mark.parametrize("backbone,seed,random_bn", CASES)
def test_direct_init_is_init_state_dict_bit_for_bit(backbone, seed,
                                                    random_bn):
    kwargs = _builder_kwargs(backbone, {"num_classes": 10},
                             SMALLEST[backbone] + (3,))
    direct = DirectInit.build(backbone, kwargs, "cpu", random_bn=random_bn)
    assert direct is not None
    direct.land(direct.draw(seed))
    got = direct.module.state_dict()
    ref = get_builder(backbone)(**kwargs)
    want = init_state_dict(ref, seed, random_bn=random_bn)
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
    params = dict(direct.module.named_parameters())
    for k, p in ref.named_parameters():
        q = params.pop(k)
        assert isinstance(q, nn.Parameter) and q.requires_grad, k
        assert (q.shape, q.dtype, q.stride()) == (p.shape, p.dtype,
                                                  p.stride()), k
    assert not params


def test_a_module_with_a_tensor_the_walk_does_not_write_is_not_direct(
        monkeypatch):
    from mmlspark_tpu_torch.models import bundle

    class Scaled(nn.Module):
        def __init__(self):
            super().__init__()
            self.head = nn.Linear(4, 2)
            self.scale = nn.Parameter(torch.ones(()))

    class Masked(nn.Module):
        def __init__(self):
            super().__init__()
            self.head = nn.Linear(4, 2)
            self.register_buffer("mask", torch.ones(2), persistent=False)

    class Offset(nn.Module):
        def __init__(self):
            super().__init__()
            self.head = nn.Linear(4, 2)
            self.offset = torch.zeros(2)  # neither parameter nor buffer

    for name, builder in (("test_scaled", Scaled), ("test_masked", Masked),
                          ("test_offset", Offset)):
        monkeypatch.setitem(bundle._BUILDERS, name, builder)
        assert DirectInit.build(name, {}, "cpu") is None, name
    monkeypatch.setitem(bundle._BUILDERS, "test_plain",
                        lambda: nn.Sequential(nn.Linear(4, 2)))
    assert DirectInit.build("test_plain", {}, "cpu") is not None
