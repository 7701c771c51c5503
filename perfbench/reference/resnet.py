"""Plain float32 ResNet (v1.5, bottleneck blocks) forward: the reference
of the featurize cells.

He et al., arXiv:1512.03385, in torchvision's v1.5 form: the stride of a
bottleneck sits on its 3x3 conv; the stem is a 7x7/2 conv, BatchNorm,
ReLU and a 3x3/2 max-pool; a projection shortcut where the shape changes;
BatchNorm in inference form (running statistics, eps 1e-5); the pooled
features are the global average of the last stage.  Inputs are NHWC
float32 images, already resized and normalised.

The sizes come from a configuration dict (`stage_sizes`, `width`,
`num_classes`, `image_size`).  The weights are a dict of tensors under
the names `param_shapes` lists (the layout the benchmark hands the
program as well).  `quant`, when given, is applied to the input and the
weight of every convolution (the lower-precision control); None computes
in float32.
Imports nothing but torch.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["param_shapes", "features", "forward_macs"]

_EPS = 1e-5


def _blocks(stage_sizes: Sequence[int], width: int
            ) -> List[Tuple[int, int, int, bool]]:
    """(c_in, filters, stride, has_projection) of every bottleneck."""
    out, c_in = [], width
    for i, n in enumerate(stage_sizes):
        filters = width * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            out.append((c_in, filters, stride,
                        stride != 1 or c_in != 4 * filters))
            c_in = 4 * filters
    return out


def param_shapes(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every weight, in order; kind is "conv",
    "bn_scale", "bn_shift", "bn_mean", "bn_var", "bn_count", "dense" or
    "bias"."""
    stage_sizes, width = cfg["stage_sizes"], cfg["width"]
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def bn(prefix: str, c: int):
        out.extend([(f"{prefix}.weight", (c,), "bn_scale"),
                    (f"{prefix}.bias", (c,), "bn_shift"),
                    (f"{prefix}.running_mean", (c,), "bn_mean"),
                    (f"{prefix}.running_var", (c,), "bn_var"),
                    (f"{prefix}.num_batches_tracked", (), "bn_count")])

    out.append(("conv_init.weight", (width, 3, 7, 7), "conv"))
    bn("bn_init", width)
    c_last = width
    for k, (c_in, f, _stride, proj) in enumerate(_blocks(stage_sizes, width)):
        convs = [(f, c_in, 1, 1), (f, f, 3, 3), (4 * f, f, 1, 1)]
        if proj:
            convs.append((4 * f, c_in, 1, 1))
        for j, shape in enumerate(convs):
            out.append((f"blocks.{k}.convs.{j}.weight", shape, "conv"))
        for j, shape in enumerate(convs):
            bn(f"blocks.{k}.bns.{j}", shape[0])
        c_last = 4 * f
    out.append(("head.weight", (cfg["num_classes"], c_last), "dense"))
    out.append(("head.bias", (cfg["num_classes"],), "bias"))
    return out


def forward_macs(cfg: dict) -> int:
    """Multiply-accumulates of one image's forward: every convolution and
    the head, from the layer shapes (BatchNorm, ReLU and pooling left
    out, as model FLOP counts leave them out)."""
    h, w = cfg["image_size"]
    h, w = (h + 1) // 2, (w + 1) // 2                      # the 7x7/2 stem
    macs = h * w * cfg["width"] * 3 * 49
    h, w = (h + 1) // 2, (w + 1) // 2                      # the max-pool
    for c_in, f, stride, proj in _blocks(cfg["stage_sizes"], cfg["width"]):
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        macs += h * w * f * c_in + ho * wo * f * f * 9 + ho * wo * 4 * f * f
        if proj:
            macs += ho * wo * 4 * f * c_in
        h, w = ho, wo
    c_last = 4 * cfg["width"] * 2 ** (len(cfg["stage_sizes"]) - 1)
    return macs + c_last * cfg["num_classes"]


def _bn(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str
        ) -> torch.Tensor:
    return F.batch_norm(x, w[f"{prefix}.running_mean"],
                        w[f"{prefix}.running_var"], w[f"{prefix}.weight"],
                        w[f"{prefix}.bias"], False, 0.0, _EPS)


def features(w: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
             quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> torch.Tensor:
    """NHWC float32 images [B, H, W, 3] -> pooled features in float32
    (the `pool` output)."""
    q = quant or (lambda t: t)

    def conv(t, name, stride, pad):
        return F.conv2d(q(t), q(w[name]), stride=stride, padding=pad)

    x = x.permute(0, 3, 1, 2).float()
    x = torch.relu(_bn(conv(x, "conv_init.weight", 2, 3), w, "bn_init"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for k, (_c_in, _f, stride, proj) in enumerate(
            _blocks(cfg["stage_sizes"], cfg["width"])):
        p = f"blocks.{k}"
        y = torch.relu(_bn(conv(x, f"{p}.convs.0.weight", 1, 0), w, f"{p}.bns.0"))
        y = torch.relu(_bn(conv(y, f"{p}.convs.1.weight", stride, 1), w,
                           f"{p}.bns.1"))
        y = _bn(conv(y, f"{p}.convs.2.weight", 1, 0), w, f"{p}.bns.2")
        r = (_bn(conv(x, f"{p}.convs.3.weight", stride, 0), w, f"{p}.bns.3")
             if proj else x)
        x = torch.relu(y + r)
    return x.mean(dim=(2, 3))
