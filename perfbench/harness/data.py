"""The general generator: image tables and weights from the seed.

A traffic mix of images names its sizes, how many rows of each a table
holds, how many tables the pool cycles through and, for training, how
many classes the labels are drawn over.  Every seed gives the same sizes
and counts; the seed changes the pixels, the row order and the labels.
Pixels and weights are drawn on the device by a seeded generator in one
call per block, and the pixels come to the host once, as the rows of the
tables (uint8, HWC, BGR); nothing is written to disk.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["sub_seed", "generator", "image_tables", "make_weights"]


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed."""
    a, b = np.random.SeedSequence([int(seed), *salt]).generate_state(
        2, np.uint32)
    return (int(a) << 31) ^ int(b)


def generator(seed: int, device, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *salt))


class ImageTable:
    """One table of the pool: `rows` (HWC uint8 arrays in table order)
    and `labels` (int64, or None)."""

    def __init__(self, rows: List[np.ndarray], labels):
        self.rows = rows
        self.labels = labels

    def column(self) -> np.ndarray:
        col = np.empty(len(self.rows), dtype=object)
        for i, r in enumerate(self.rows):
            col[i] = r
        return col


def image_tables(mix: dict, seed: int, device) -> List[ImageTable]:
    sizes = [tuple(s) for s in mix["sizes"]]
    per_size, c = int(mix["rows_per_size"]), int(mix.get("channels", 3))
    n = per_size * len(sizes)
    tables = []
    for t in range(int(mix["tables"])):
        blocks = [torch.randint(0, 256, (per_size, h, w, c), dtype=torch.uint8,
                                device=device,
                                generator=generator(seed, device, 1, t, i)
                                ).cpu().numpy()
                  for i, (h, w) in enumerate(sizes)]
        rng = np.random.default_rng(sub_seed(seed, 2, t))
        order = rng.permutation(n)
        rows = [blocks[k // per_size][k % per_size] for k in order]
        labels = None
        if mix.get("classes"):
            labels = rng.permutation(np.arange(n) % int(mix["classes"]))
        tables.append(ImageTable(rows, labels))
    return tables


_NORMAL = {"conv", "dense", "bn_shift", "bn_mean", "pos"}
_UNIFORM = {"bn_scale", "bn_var"}


def make_weights(shapes: Sequence[Tuple[str, Tuple[int, ...], str]],
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights on `device` in two draws: kernels LeCun-normal
    (variance 1 / fan-in), BatchNorm scales and variances U(0.5, 1.5) and
    shifts and means N(0, 0.1) (every residual branch contributes), the
    position table N(0, 0.02), biases and LayerNorm shifts 0, LayerNorm
    scales 1, BatchNorm counters 0."""
    sizes = {k: sum(math.prod(s) for _n, s, kk in shapes if kk in kinds)
             for k, kinds in (("n", _NORMAL), ("u", _UNIFORM))}
    z = torch.randn(sizes["n"], device=device,
                    generator=generator(seed, device, 3))
    u = torch.rand(sizes["u"], device=device,
                   generator=generator(seed, device, 4))
    out: Dict[str, torch.Tensor] = {}
    at = {"n": 0, "u": 0}
    for name, shape, kind in shapes:
        size = math.prod(shape)
        if kind in _NORMAL or kind in _UNIFORM:
            src = "n" if kind in _NORMAL else "u"
            t = (z if src == "n" else u)[at[src]:at[src] + size].view(shape)
            at[src] += size
            if kind in ("conv", "dense"):
                t = t / math.prod(shape[1:]) ** 0.5
            elif kind in ("bn_shift", "bn_mean"):
                t = 0.1 * t
            elif kind == "pos":
                t = 0.02 * t
            else:
                t = 0.5 + t
            out[name] = t.clone()
        elif kind == "bn_count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "ln_scale":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
