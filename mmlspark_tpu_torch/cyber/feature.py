"""CyberML feature utilities: per-partition indexers and scalers.

Reference: core python mmlspark/cyber/feature/*.py (~400 LoC) — IdIndexer
(string ids -> per-tenant contiguous ints) and partitioned standard/min-max
scalers (statistics computed independently per partition key, e.g. tenant).

A copy of the JAX package's `cyber/feature.py` for this package.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = [
    "IdIndexer",
    "IdIndexerModel",
    "PartitionedStandardScaler",
    "PartitionedMinMaxScaler",
    "PartitionedScalerModel",
]


@register_stage
class IdIndexer(Estimator):
    """Per-tenant contiguous indexing of string ids."""

    input_col = Param("raw id column", default="user")
    partition_key = Param("tenant column ('' = global)", default="")
    output_col = Param("indexed output column", default="indexed")

    def _fit(self, table: Table) -> "IdIndexerModel":
        keys = (
            table[self.partition_key]
            if self.partition_key and self.partition_key in table
            else np.zeros(len(table), np.int64)
        )
        vocab: Dict = {}
        for k, v in zip(keys, table[self.input_col]):
            vocab.setdefault(k, {}).setdefault(str(v), len(vocab.get(k, {})))
        return IdIndexerModel(
            vocab=vocab, input_col=self.input_col,
            partition_key=self.partition_key, output_col=self.output_col,
        )


@register_stage
class IdIndexerModel(Model):
    input_col = Param("raw id column", default="user")
    partition_key = Param("tenant column", default="")
    output_col = Param("indexed output column", default="indexed")
    vocab = ComplexParam("per-partition vocab dict")

    def _transform(self, table: Table) -> Table:
        keys = (
            table[self.partition_key]
            if self.partition_key and self.partition_key in table
            else np.zeros(len(table), np.int64)
        )
        vocab = self.vocab
        out = np.full(len(table), -1, np.int64)
        for i, (k, v) in enumerate(zip(keys, table[self.input_col])):
            out[i] = vocab.get(k, {}).get(str(v), -1)
        return table.with_column(self.output_col, out)

    def partition_size(self, key) -> int:
        return len(self.vocab.get(key, {}))


class _PartitionedScalerBase(Estimator):
    input_col = Param("value column", default="value")
    partition_key = Param("tenant column ('' = global)", default="")
    output_col = Param("scaled output column", default="scaled")

    def _keys(self, table: Table) -> np.ndarray:
        if self.partition_key and self.partition_key in table:
            return np.asarray(table[self.partition_key])
        return np.zeros(len(table), np.int64)

    def _stats(self, vals: np.ndarray) -> Tuple[float, float]:
        raise NotImplementedError

    def _fit(self, table: Table) -> "PartitionedScalerModel":
        keys = self._keys(table)
        vals = np.asarray(table[self.input_col], np.float64)
        stats = {}
        for k in np.unique(keys):
            stats[k] = self._stats(vals[keys == k])
        return PartitionedScalerModel(
            stats=stats, input_col=self.input_col,
            partition_key=self.partition_key, output_col=self.output_col,
        )


@register_stage
class PartitionedStandardScaler(_PartitionedScalerBase):
    """(x - mean) / std per partition."""

    def _stats(self, vals):
        return float(vals.mean()), float(vals.std() + 1e-12)


@register_stage
class PartitionedMinMaxScaler(_PartitionedScalerBase):
    """(x - min) / (max - min) per partition."""

    def _stats(self, vals):
        lo, hi = float(vals.min()), float(vals.max())
        return lo, max(hi - lo, 1e-12)


@register_stage
class PartitionedScalerModel(Model):
    input_col = Param("value column", default="value")
    partition_key = Param("tenant column", default="")
    output_col = Param("scaled output column", default="scaled")
    stats = ComplexParam("per-partition (shift, scale)")

    def _transform(self, table: Table) -> Table:
        keys = (
            np.asarray(table[self.partition_key])
            if self.partition_key and self.partition_key in table
            else np.zeros(len(table), np.int64)
        )
        vals = np.asarray(table[self.input_col], np.float64)
        out = np.zeros(len(table), np.float64)
        stats = self.stats
        for k in np.unique(keys):  # one vectorized op per partition
            shift, scale = stats.get(k, (0.0, 1.0))
            mask = keys == k
            out[mask] = (vals[mask] - shift) / scale
        return table.with_column(self.output_col, out)
