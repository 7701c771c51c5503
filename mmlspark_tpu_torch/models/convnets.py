"""Classic CNN zoo: AlexNet / VGG / CIFAR ConvNet as `nn.Module`s.

The reference's ModelDownloader ships CNTK zoo binaries beyond ResNet —
AlexNet and plain ConvNets (SURVEY §2.9.6; deep-learning DownloaderSuite,
docs model list).  Counterpart of the JAX package's `models/convnets.py`
(flax), with the same architectures, tap names and `(logits, taps)`
contract as models/resnet.py, so ImageFeaturizer's `cutOutputLayers`
addressing (ImageFeaturizer.scala:40-197) works unchanged — taps are
ordered output-backwards and `taps[layer_names[1]]` is always the
penultimate feature vector.

As in the port's ResNet, inputs and taps keep the NHWC layout at the
module's boundary (the NCHW view of an NHWC tensor is `channels_last` in
memory), and the compute dtype is the parameters' (`module.to(dtype)`;
bf16 on the card).  The conv taps come out in the compute dtype, the
dense taps and the logits in f32, where the flax modules cast them.
Max-pools are VALID (flax's default: no padding).  The dense tail
flattens the NHWC map in (H, W, C) order, as flax's `reshape` does, so a
flax `fc1` kernel loads as it is.  Module names mirror flax's (`conv1`,
`conv2_1`, `conv1a`, `fc1`, `head`), so the weight bridge is a rename.

No LRN (obsolete; modern reimplementations drop it).  Dropout 0.5 runs
only in train mode (`module.train()`), scaled by 1/keep as flax's is.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["AlexNet", "VGG", "ConvNetCifar", "alexnet", "vgg11", "vgg16",
           "convnet_cifar"]

Taps = Dict[str, torch.Tensor]


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(dtype)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H * W * C] in flax's NHWC order."""
    return _nhwc(x).reshape(x.shape[0], -1)


def _add_head(owner: nn.Module, in_features: int, num_classes: int,
              hidden: Sequence[int]) -> int:
    """The shared fc tail's layers on `owner`: `fc1`.. `fc<n>` and `head`;
    returns n."""
    widths = [in_features] + list(hidden)
    for k in range(len(hidden)):
        owner.add_module(f"fc{k + 1}", nn.Linear(widths[k], widths[k + 1]))
    owner.add_module("head", nn.Linear(widths[-1], num_classes))
    return len(hidden)


def _run_head(owner: nn.Module, x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """Shared fc tail: hidden dense layers (the last one is the 'pool' tap
    / penultimate feature), each followed by train-time dropout, then the
    head.  Records 'fc<k>' / 'pool' / 'logits' taps in f32."""
    n = owner.n_hidden
    for k in range(n):
        x = torch.relu(getattr(owner, f"fc{k + 1}")(x))
        taps["pool" if k == n - 1 else f"fc{k + 1}"] = x.float()
        x = F.dropout(x, 0.5, training=owner.training)
    logits = owner.head(x).float()
    taps["logits"] = logits
    return logits


class AlexNet(nn.Module):
    """AlexNet (single-tower): 5 convs + 2 fc layers + head."""

    layer_names = ["logits", "pool", "fc1", "conv5", "conv3", "conv1"]

    def __init__(self, num_classes: int = 1000,
                 input_hw: Tuple[int, int] = (224, 224)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 96, 11, stride=4, padding=2)
        self.conv2 = nn.Conv2d(96, 256, 5, padding=2)
        self.conv3 = nn.Conv2d(256, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 384, 3, padding=1)
        self.conv5 = nn.Conv2d(384, 256, 3, padding=1)
        h, w = (_alexnet_side(s) for s in input_hw)
        self.n_hidden = _add_head(self, 256 * h * w, num_classes, (4096, 4096))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Taps]:
        """x: [B, H, W, 3] (NHWC, any float or uint8 dtype)."""
        if x.shape[1] < 63 or x.shape[2] < 63:
            raise ValueError(
                f"AlexNet needs inputs of at least 63x63 (three stride-2 "
                f"3x3 pools after a stride-4 conv); got "
                f"{x.shape[1]}x{x.shape[2]} — resize up or pick a "
                f"small-input backbone (convnet_cifar, resnet18)")
        taps: Taps = {}
        x = _nchw(x, self.conv1.weight.dtype)
        x = torch.relu(self.conv1(x))
        taps["conv1"] = _nhwc(x)
        x = F.max_pool2d(x, 3, 2)
        x = torch.relu(self.conv2(x))
        x = F.max_pool2d(x, 3, 2)
        x = torch.relu(self.conv3(x))
        taps["conv3"] = _nhwc(x)
        x = torch.relu(self.conv4(x))
        x = torch.relu(self.conv5(x))
        taps["conv5"] = _nhwc(x)
        x = F.max_pool2d(x, 3, 2)
        logits = _run_head(self, _flatten(x), taps)
        return logits, taps


def _alexnet_side(s: int) -> int:
    s = (s + 4 - 11) // 4 + 1          # conv1 11x11/4, pad 2
    for _ in range(3):                  # three 3x3/2 VALID pools
        s = (s - 3) // 2 + 1
    return max(s, 0)


class VGG(nn.Module):
    """VGG-style conv stacks; cfg is filters-per-stack (max_pool between)."""

    layer_names = ["logits", "pool", "fc1", "conv_out"]

    def __init__(self, cfg: Sequence[Sequence[int]], num_classes: int = 1000,
                 input_hw: Tuple[int, int] = (224, 224)):
        super().__init__()
        self.cfg = [list(c) for c in cfg]
        self.conv_names: List[str] = []
        c_in = 3
        for s, widths in enumerate(self.cfg):
            for k, width in enumerate(widths):
                name = f"conv{s + 1}_{k + 1}"
                self.add_module(name, nn.Conv2d(c_in, width, 3, padding=1))
                self.conv_names.append(name)
                c_in = width
        h, w = (side >> len(self.cfg) for side in input_hw)
        self.n_hidden = _add_head(self, c_in * h * w, num_classes, (4096, 4096))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Taps]:
        taps: Taps = {}
        x = _nchw(x, self.conv1_1.weight.dtype)
        names = iter(self.conv_names)
        for widths in self.cfg:
            for _ in widths:
                x = torch.relu(getattr(self, next(names))(x))
            x = F.max_pool2d(x, 2, 2)
        taps["conv_out"] = _nhwc(x)
        logits = _run_head(self, _flatten(x), taps)
        return logits, taps


class ConvNetCifar(nn.Module):
    """The small ConvNet of the CIFAR tutorials (CNTK ConvNet_CIFAR10
    shape): 3 conv/pool stages + one hidden dense."""

    layer_names = ["logits", "pool", "conv3", "conv2", "conv1"]

    def __init__(self, num_classes: int = 10,
                 input_hw: Tuple[int, int] = (32, 32)):
        super().__init__()
        c_in = 3
        for i, width in enumerate((64, 128, 256)):
            self.add_module(f"conv{i + 1}a", nn.Conv2d(c_in, width, 3,
                                                       padding=1))
            self.add_module(f"conv{i + 1}b", nn.Conv2d(width, width, 3,
                                                       padding=1))
            c_in = width
        h, w = (side >> 3 for side in input_hw)
        self.n_hidden = _add_head(self, 256 * h * w, num_classes, (512,))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Taps]:
        taps: Taps = {}
        x = _nchw(x, self.conv1a.weight.dtype)
        for i in range(3):
            x = torch.relu(getattr(self, f"conv{i + 1}a")(x))
            x = torch.relu(getattr(self, f"conv{i + 1}b")(x))
            x = F.max_pool2d(x, 2, 2)
            taps[f"conv{i + 1}"] = _nhwc(x)
        logits = _run_head(self, _flatten(x), taps)
        return logits, taps


def alexnet(num_classes: int = 1000, image_size=(224, 224)) -> AlexNet:
    return AlexNet(num_classes, tuple(image_size))


def vgg11(num_classes: int = 1000, image_size=(224, 224)) -> VGG:
    return VGG(((64,), (128,), (256, 256), (512, 512), (512, 512)),
               num_classes, tuple(image_size))


def vgg16(num_classes: int = 1000, image_size=(224, 224)) -> VGG:
    return VGG(((64, 64), (128, 128), (256, 256, 256),
                (512, 512, 512), (512, 512, 512)), num_classes,
               tuple(image_size))


def convnet_cifar(num_classes: int = 10, image_size=(32, 32)) -> ConvNetCifar:
    return ConvNetCifar(num_classes, tuple(image_size))
