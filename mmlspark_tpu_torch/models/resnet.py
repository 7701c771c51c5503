"""ResNet family as `nn.Module`s — the vision backbone of the featurizer.

Counterpart of the JAX package's `models/resnet.py` (flax), with the same
architecture, tap names and numerics:

* the stem is a 7x7/2 conv with padding (3, 3), BN, ReLU and a 3x3/2
  max-pool with padding 1 (PyTorch pads max-pool with -inf, as flax does);
* 3x3 convs pad (1, 1); 1x1 convs pad 0 (what flax's 'SAME' gives a 1x1
  kernel at any stride); the stride of a bottleneck sits on its 3x3 conv;
* BatchNorm uses eps 1e-5 and its running statistics (inference);
* a block's projection shortcut exists where its shape changes.

Inputs and taps keep the JAX package's NHWC layout at the module's
boundary: an NHWC tensor permuted to NCHW is already `channels_last` in
memory, so no copy is made.  `forward` returns `(logits, taps)` with
taps ordered output-backwards like `LAYER_NAMES`; `pool` and `logits`
are f32.  The compute dtype is the dtype of the module's parameters
(`module.to(dtype)`): bf16 on the card, as the JAX package runs it.

Module names mirror flax's so the weight bridge (bundle.py) is a rename:
`blocks[i]` is flax's `<Block>_i`, and `blocks[i].convs[j]` /
`blocks[i].bns[j]` are its `Conv_j` / `BatchNorm_j` (the last index is the
projection shortcut when there is one).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Type

import torch
from torch import nn

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "LAYER_NAMES",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]

LAYER_NAMES = ["logits", "pool", "res5", "res4", "res3", "res2", "stem"]

_EPS = 1e-5


def _conv(c_in: int, c_out: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=(k - 1) // 2,
                     bias=False)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=_EPS)


class BasicBlock(nn.Module):
    """Two 3x3 convs; flax names Conv_0/1 (+ Conv_2 projection)."""

    expansion = 1

    def __init__(self, c_in: int, filters: int, stride: int = 1):
        super().__init__()
        c_out = filters * self.expansion
        self.stride = stride
        self.has_proj = stride != 1 or c_in != c_out
        convs = [_conv(c_in, filters, 3, stride), _conv(filters, filters, 3)]
        if self.has_proj:
            convs.append(_conv(c_in, c_out, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(_bn(c.out_channels) for c in convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, b = self.convs, self.bns
        y = torch.relu(b[0](c[0](x)))
        y = b[1](c[1](y))
        residual = b[2](c[2](x)) if self.has_proj else x
        return torch.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 (x4); flax names Conv_0..2 (+ Conv_3
    projection)."""

    expansion = 4

    def __init__(self, c_in: int, filters: int, stride: int = 1):
        super().__init__()
        c_out = filters * self.expansion
        self.stride = stride
        self.has_proj = stride != 1 or c_in != c_out
        convs = [_conv(c_in, filters, 1), _conv(filters, filters, 3, stride),
                 _conv(filters, c_out, 1)]
        if self.has_proj:
            convs.append(_conv(c_in, c_out, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(_bn(c.out_channels) for c in convs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, b = self.convs, self.bns
        y = torch.relu(b[0](c[0](x)))
        y = torch.relu(b[1](c[1](y)))
        y = b[2](c[2](y))
        residual = b[3](c[3](x)) if self.has_proj else x
        return torch.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int],
                 block_cls: Type[nn.Module], num_classes: int = 1000):
        super().__init__()
        self.stage_sizes = list(stage_sizes)
        self.block_cls = block_cls
        self.conv_init = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn_init = _bn(64)
        self.pool_init = nn.MaxPool2d(3, stride=2, padding=1)
        blocks: List[nn.Module] = []
        c_in = 64
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(c_in, 64 * 2 ** i, stride))
                c_in = 64 * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(c_in, num_classes)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x: [B, H, W, 3] (NHWC, any float or uint8 dtype)."""
        taps: Dict[str, torch.Tensor] = {}
        dtype = self.conv_init.weight.dtype
        x = x.permute(0, 3, 1, 2).to(dtype)  # NCHW view, channels_last memory
        x = torch.relu(self.bn_init(self.conv_init(x)))
        x = self.pool_init(x)
        taps["stem"] = x.permute(0, 2, 3, 1)
        k = 0
        for i, n_blocks in enumerate(self.stage_sizes):
            for _ in range(n_blocks):
                x = self.blocks[k](x)
                k += 1
            taps[f"res{i + 2}"] = x.permute(0, 2, 3, 1)
        pooled = x.mean(dim=(2, 3))
        taps["pool"] = pooled.float()
        logits = self.head(pooled).float()
        taps["logits"] = logits
        return logits, taps


def resnet18(num_classes: int = 1000) -> ResNet:
    return ResNet([2, 2, 2, 2], BasicBlock, num_classes)


def resnet34(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], BasicBlock, num_classes)


def resnet50(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 6, 3], BottleneckBlock, num_classes)


def resnet101(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 4, 23, 3], BottleneckBlock, num_classes)


def resnet152(num_classes: int = 1000) -> ResNet:
    return ResNet([3, 8, 36, 3], BottleneckBlock, num_classes)
