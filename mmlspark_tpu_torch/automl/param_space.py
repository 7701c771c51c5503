"""Hyperparameter spaces: grid + random distributions.

Reference: core automl/HyperparamBuilder.scala:11-113, ParamSpace.scala:11-40,
DefaultHyperparams.scala:13 (DiscreteHyperParam, RangeHyperParam variants,
GridSpace / RandomSpace).

A copy of the JAX package's `automl/param_space.py` for this package.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Sequence

import numpy as np

__all__ = [
    "DiscreteHyperParam",
    "IntRangeHyperParam",
    "FloatRangeHyperParam",
    "LogRangeHyperParam",
    "HyperparamBuilder",
    "GridSpace",
    "RandomSpace",
]


class Dist:
    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError

    def values(self) -> List[Any]:
        raise NotImplementedError("not enumerable; use RandomSpace")


class DiscreteHyperParam(Dist):
    def __init__(self, values: Sequence[Any]):
        self._values = list(values)

    def sample(self, rng):
        return self._values[int(rng.integers(len(self._values)))]

    def values(self):
        return list(self._values)


class IntRangeHyperParam(Dist):
    def __init__(self, low: int, high: int):
        self.low, self.high = int(low), int(high)

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))


class FloatRangeHyperParam(Dist):
    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


class LogRangeHyperParam(Dist):
    def __init__(self, low: float, high: float):
        self.low, self.high = float(low), float(high)

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


class HyperparamBuilder:
    """Collect (param_name -> Dist) pairs (HyperparamBuilder.scala)."""

    def __init__(self):
        self._space: Dict[str, Dist] = {}

    def add_hyperparam(self, name: str, dist: Dist) -> "HyperparamBuilder":
        self._space[name] = dist
        return self

    def build(self) -> Dict[str, Dist]:
        return dict(self._space)


class GridSpace:
    """Cartesian product of enumerable dists (ParamSpace.scala GridSpace)."""

    def __init__(self, space: Dict[str, Dist]):
        self.space = space

    def param_maps(self) -> Iterator[Dict[str, Any]]:
        names = list(self.space)
        grids = [self.space[n].values() for n in names]
        idx = [0] * len(names)
        if not names:
            yield {}
            return
        while True:
            yield {n: grids[i][idx[i]] for i, n in enumerate(names)}
            j = len(names) - 1
            while j >= 0:
                idx[j] += 1
                if idx[j] < len(grids[j]):
                    break
                idx[j] = 0
                j -= 1
            if j < 0:
                return


class RandomSpace:
    """Random sampling from dists (ParamSpace.scala RandomSpace)."""

    def __init__(self, space: Dict[str, Dist], num_samples: int, seed: int = 0):
        self.space = space
        self.num_samples = int(num_samples)
        self.seed = int(seed)

    def param_maps(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_samples):
            yield {n: d.sample(rng) for n, d in self.space.items()}
