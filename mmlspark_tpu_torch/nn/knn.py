"""KNN estimators: batched maximum-inner-product search on the card.

Reference: core nn/KNN.scala:48-126 (KNN broadcasts a BallTree, maps rows to
`findMaximumInnerProducts(q, k)`) and nn/ConditionalKNN.scala:31-120 (adds a
per-query set of allowed labels).  Counterpart of the JAX package's
`nn/knn.py`, with its Params, defaults and output columns: the bulk
transform is a dense `Q @ K^T` in full f32 (`models/linear._full_f32`)
plus a top-k with `jax.lax.top_k`'s order, ties to the lower index
(`ops/topk.topk_lower_index`); the serialized BallTree (nn/ball_tree.py)
remains the single-query host path for serving.  Queries go to the card
in chunks whose (chunk, keys) score matrix fits a fixed budget of device
memory (at most the JAX package's 4,096 queries); the result does not
depend on the chunk.  Each stage has a `device` Param: the card unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table, features_matrix as _matrix
from ..device import DEVICE_DOC, resolve_device
from ..ops.topk import topk_lower_index
from .ball_tree import BallTree, ConditionalBallTree

__all__ = ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel"]

_CHUNK = 4096  # query rows per device batch, at most
_SCORE_BYTES = 1 << 31  # device memory for one chunk's (B, N) f32 scores


def _chunk_rows(n_keys: int) -> int:
    return max(1, min(_CHUNK, _SCORE_BYTES // (4 * max(n_keys, 1))))


def _batched_topk(keys_np, queries_np, k, mask_np=None, device=None):
    """Chunked device top-k; returns (values (B,k), indices (B,k)) numpy."""
    from ..models.linear import _full_f32

    if len(queries_np) == 0:
        return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
    dev = resolve_device(device)
    keys = torch.as_tensor(np.ascontiguousarray(keys_np, np.float32),
                           device=dev)
    step = _chunk_rows(len(keys_np))
    vals, idxs = [], []
    for lo in range(0, len(queries_np), step):
        q = torch.as_tensor(np.ascontiguousarray(
            queries_np[lo: lo + step], np.float32), device=dev)
        with _full_f32():
            scores = q @ keys.T
        if mask_np is not None:
            m = torch.as_tensor(mask_np[lo: lo + step], device=dev)
            scores = torch.where(m, scores, float("-inf"))
        v, i = topk_lower_index(scores, k)
        vals.append(v.cpu().numpy())
        idxs.append(i.to(torch.int32).cpu().numpy())
    return np.concatenate(vals), np.concatenate(idxs)


class _KNNParams:
    features_col = Param("query features column", default="features")
    values_col = Param("payload column returned with each match", default="values")
    output_col = Param("output column of matches", default="output")
    k = Param("number of matches", default=5, converter=TypeConverters.to_int)
    leaf_size = Param("ball-tree leaf size", default=50, converter=TypeConverters.to_int)
    device = Param(DEVICE_DOC, default=None)


@register_stage
class KNN(Estimator, _KNNParams):
    """Fit memorizes the (features, values) index table; transform scores
    queries against it (KNN.scala:48)."""

    def _fit(self, table: Table) -> "KNNModel":
        keys = _matrix(table[self.features_col])
        values = list(table[self.values_col])
        return KNNModel(
            features_col=self.features_col,
            output_col=self.output_col,
            k=self.k,
            ball_tree=BallTree(keys, values, leaf_size=self.leaf_size),
            device=self.device,
        )


@register_stage
class KNNModel(Model):
    features_col = Param("query features column", default="features")
    output_col = Param("output column of matches", default="output")
    k = Param("number of matches", default=5, converter=TypeConverters.to_int)
    ball_tree = ComplexParam("fitted BallTree (host single-query path)")
    device = Param(DEVICE_DOC, default=None)

    def _transform(self, table: Table) -> Table:
        tree: BallTree = self.ball_tree
        queries = _matrix(table[self.features_col])
        k = min(self.k, len(tree))
        vals, idxs = _batched_topk(tree.keys.astype(np.float32), queries, k,
                                   device=self.device)
        out = np.empty(len(queries), dtype=object)
        for r in range(len(queries)):
            out[r] = [
                {"value": tree.values[int(i)], "distance": float(v)}
                for v, i in zip(vals[r], idxs[r])
            ]
        return table.with_column(self.output_col, out)

    def query_one(self, point: np.ndarray, k: Optional[int] = None):
        """Single-query host path via the ball tree (serving latency path)."""
        return self.ball_tree.find_maximum_inner_products(point, k or self.k)

    def transform_schema(self, columns: List[str]) -> List[str]:
        if self.features_col not in columns:
            raise ValueError(f"missing features column '{self.features_col}'")
        return columns + [self.output_col]


@register_stage
class ConditionalKNN(Estimator, _KNNParams):
    """KNN whose index rows carry labels and whose queries carry the set of
    labels they may match (ConditionalKNN.scala:31)."""

    label_col = Param("index label column", default="labels")

    def _fit(self, table: Table) -> "ConditionalKNNModel":
        keys = _matrix(table[self.features_col])
        values = list(table[self.values_col])
        labels = list(table[self.label_col])
        return ConditionalKNNModel(
            features_col=self.features_col,
            output_col=self.output_col,
            conditioner_col=self.conditioner_col,
            k=self.k,
            ball_tree=ConditionalBallTree(keys, values, labels, leaf_size=self.leaf_size),
            device=self.device,
        )

    conditioner_col = Param("query column holding the allowed-label set", default="conditioner")


@register_stage
class ConditionalKNNModel(Model):
    features_col = Param("query features column", default="features")
    output_col = Param("output column of matches", default="output")
    conditioner_col = Param("query column holding the allowed-label set", default="conditioner")
    k = Param("number of matches", default=5, converter=TypeConverters.to_int)
    ball_tree = ComplexParam("fitted ConditionalBallTree")
    device = Param(DEVICE_DOC, default=None)

    def _transform(self, table: Table) -> Table:
        tree: ConditionalBallTree = self.ball_tree
        queries = _matrix(table[self.features_col])
        conditioners = table[self.conditioner_col]
        k = min(self.k, len(tree))
        # vectorized label filter: code labels to ints once, build (B, N) mask
        levels = {v: i for i, v in enumerate(dict.fromkeys(tree.labels.tolist()))}
        codes = np.array([levels[v] for v in tree.labels.tolist()], dtype=np.int32)
        mask = np.zeros((len(queries), len(tree)), dtype=bool)
        for r, cond in enumerate(conditioners):
            allowed = {levels[c] for c in cond if c in levels}
            if allowed:
                mask[r] = np.isin(codes, list(allowed))
        vals, idxs = _batched_topk(tree.keys.astype(np.float32), queries, k,
                                   mask, device=self.device)
        out = np.empty(len(queries), dtype=object)
        for r in range(len(queries)):
            matches = []
            for v, i in zip(vals[r], idxs[r]):
                if not np.isfinite(v):
                    continue  # fewer than k items matched the conditioner
                matches.append(
                    {
                        "value": tree.values[int(i)],
                        "distance": float(v),
                        "label": tree.labels[int(i)],
                    }
                )
            out[r] = matches
        return table.with_column(self.output_col, out)

    def query_one(self, point: np.ndarray, allowed: set, k: Optional[int] = None):
        return self.ball_tree.find_maximum_inner_products(point, k or self.k, allowed=allowed)

    def transform_schema(self, columns: List[str]) -> List[str]:
        for c in (self.features_col, self.conditioner_col):
            if c not in columns:
                raise ValueError(f"missing column '{c}'")
        return columns + [self.output_col]
