"""Serializable ball trees for maximum-inner-product search.

Reference: core nn/BallTree.scala:31-271 — `BallTree(keys, values)` with
`findMaximumInnerProducts(query, k)` and `ConditionalBallTree` whose queries
carry a set of allowed labels (label-filtered NN for conditional image
matching).  The tree is the *host* path (single-query serving); bulk
transforms use the batched matmul path in `nn/knn.py` — on the card a dense
`Q @ K^T` + top-k beats pointer-chasing for any realistic batch.

Build: recursive median split along the dimension of maximal spread; each
node stores (centroid mu, radius r) so the max attainable inner product in a
ball is bounded by `q . mu + |q| * r` (Cauchy–Schwarz), the same bound the
reference uses for branch pruning.

A copy of the JAX package's `nn/ball_tree.py` for this package (host
numpy, as there).
"""
from __future__ import annotations

import heapq
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BallTree", "ConditionalBallTree", "BestMatch"]


class BestMatch:
    """A single query result: item index, payload value, inner product."""

    __slots__ = ("index", "value", "distance")

    def __init__(self, index: int, value: Any, distance: float):
        self.index = index
        self.value = value
        self.distance = distance

    def __repr__(self):
        return f"BestMatch(index={self.index}, value={self.value!r}, distance={self.distance:.6g})"

    def __eq__(self, other):
        return (
            isinstance(other, BestMatch)
            and self.index == other.index
            and abs(self.distance - other.distance) < 1e-9
        )


class _Node:
    __slots__ = ("mu", "radius", "lo", "hi", "left", "right")

    def __init__(self, mu, radius, lo, hi, left=None, right=None):
        self.mu = mu          # ball centroid
        self.radius = radius  # max distance from centroid to member
        self.lo = lo          # [lo, hi) slice into the permuted index array
        self.hi = hi
        self.left = left
        self.right = right

    @property
    def is_leaf(self):
        return self.left is None


def _build(keys: np.ndarray, perm: np.ndarray, lo: int, hi: int, leaf_size: int) -> _Node:
    pts = keys[perm[lo:hi]]
    mu = pts.mean(axis=0)
    radius = float(np.sqrt(((pts - mu) ** 2).sum(axis=1).max())) if hi > lo else 0.0
    node = _Node(mu, radius, lo, hi)
    if hi - lo <= leaf_size:
        return node
    spread = pts.max(axis=0) - pts.min(axis=0)
    dim = int(np.argmax(spread))
    order = np.argsort(pts[:, dim], kind="stable")
    perm[lo:hi] = perm[lo:hi][order]
    mid = (lo + hi) // 2
    if mid == lo or mid == hi:  # all points identical along every axis
        return node
    node.left = _build(keys, perm, lo, mid, leaf_size)
    node.right = _build(keys, perm, mid, hi, leaf_size)
    return node


class BallTree:
    """Maximum-inner-product ball tree (BallTree.scala:31-271).

    `keys`: (N, D) float array.  `values`: optional payload per key (defaults
    to the integer index, like the reference's `values: IndexedSeq[V]`).
    """

    def __init__(
        self,
        keys: np.ndarray,
        values: Optional[Sequence[Any]] = None,
        leaf_size: int = 50,
    ):
        self.keys = np.ascontiguousarray(np.asarray(keys, dtype=np.float64))
        if self.keys.ndim != 2:
            raise ValueError(f"keys must be (N, D), got {self.keys.shape}")
        n = len(self.keys)
        self.values: List[Any] = list(values) if values is not None else list(range(n))
        if len(self.values) != n:
            raise ValueError("values length must match keys")
        self.leaf_size = int(leaf_size)
        self._perm = np.arange(n)
        self._root = _build(self.keys, self._perm, 0, n, self.leaf_size) if n else None

    # -- query ----------------------------------------------------------
    def _upper_bound(self, q: np.ndarray, qnorm: float, node: _Node) -> float:
        return float(q @ node.mu) + qnorm * node.radius

    def find_maximum_inner_products(
        self, query: np.ndarray, k: int = 1, allowed: Optional[set] = None,
        labels: Optional[np.ndarray] = None,
    ) -> List[BestMatch]:
        """Top-k by inner product; `allowed`/`labels` implement the
        conditional (label-filtered) variant."""
        if self._root is None or k <= 0:
            return []
        q = np.asarray(query, dtype=np.float64).ravel()
        qnorm = float(np.linalg.norm(q))
        heap: List[Tuple[float, int]] = []  # min-heap of (ip, index)

        def visit(node: _Node):
            if len(heap) == k and self._upper_bound(q, qnorm, node) <= heap[0][0]:
                return  # prune: ball cannot beat current k-th best
            if node.is_leaf:
                idx = self._perm[node.lo:node.hi]
                if allowed is not None:
                    mask = np.fromiter(
                        (labels[i] in allowed for i in idx), bool, count=len(idx)
                    )
                    idx = idx[mask]
                    if not len(idx):
                        return
                ips = self.keys[idx] @ q
                for i, ip in zip(idx, ips):
                    if len(heap) < k:
                        heapq.heappush(heap, (float(ip), int(i)))
                    elif ip > heap[0][0]:
                        heapq.heapreplace(heap, (float(ip), int(i)))
                return
            # visit the more promising child first for earlier pruning
            bl = self._upper_bound(q, qnorm, node.left)
            br = self._upper_bound(q, qnorm, node.right)
            first, second = (
                (node.left, node.right) if bl >= br else (node.right, node.left)
            )
            visit(first)
            visit(second)

        visit(self._root)
        out = sorted(heap, key=lambda t: -t[0])
        return [BestMatch(i, self.values[i], ip) for ip, i in out]

    def __len__(self):
        return len(self.keys)

    # -- serialization (pickled as a ComplexParam; rebuild on load) ------
    def __getstate__(self):
        return {"keys": self.keys, "values": self.values, "leaf_size": self.leaf_size}

    def __setstate__(self, state):
        self.__init__(state["keys"], state["values"], state["leaf_size"])


class ConditionalBallTree(BallTree):
    """Label-filtered ball tree (BallTree.scala ConditionalBallTree).

    Queries carry a set of allowed labels; only items whose label is in the
    set compete for the top-k.
    """

    def __init__(
        self,
        keys: np.ndarray,
        values: Optional[Sequence[Any]] = None,
        labels: Optional[Sequence[Any]] = None,
        leaf_size: int = 50,
    ):
        super().__init__(keys, values, leaf_size)
        if labels is None:
            raise ValueError("ConditionalBallTree requires labels")
        self.labels = np.asarray(list(labels), dtype=object)
        if len(self.labels) != len(self.keys):
            raise ValueError("labels length must match keys")

    def find_maximum_inner_products(
        self, query: np.ndarray, k: int = 1, allowed: Optional[set] = None, labels=None
    ) -> List[BestMatch]:
        if allowed is None:
            raise ValueError("conditional query requires the set of allowed labels")
        return super().find_maximum_inner_products(
            query, k, allowed=set(allowed), labels=self.labels
        )

    def __getstate__(self):
        d = super().__getstate__()
        d["labels"] = self.labels
        return d

    def __setstate__(self, state):
        self.__init__(state["keys"], state["values"], state["labels"], state["leaf_size"])
