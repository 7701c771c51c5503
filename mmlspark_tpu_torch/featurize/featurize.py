"""Featurize: automatic feature assembly from arbitrary typed columns.

Reference: core featurize/Featurize.scala:36-238 — per-column strategy
(numeric passthrough + mean-impute, categorical one-hot under a cardinality
threshold, text hashing, vector concat) assembled into one dense `features`
vector; plus DataConversion.scala:21-173 and CountSelector.scala.

The output is a dense float32 [N, D] matrix, directly device-feedable;
hashing uses crc32 (deterministic across processes).  A copy of the JAX
package's `featurize/featurize.py` for this package.
"""
from __future__ import annotations

import zlib
from typing import Dict

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model, Transformer
from ..core.registry import register_stage
from ..core.schema import CategoricalMap, Table

__all__ = ["Featurize", "FeaturizeModel", "DataConversion", "CountSelector",
           "CountSelectorModel"]


def _hash_token(tok: str, dims: int) -> int:
    return zlib.crc32(tok.encode("utf-8")) % dims


@register_stage
class Featurize(Estimator):
    input_cols = Param("columns to featurize", converter=TypeConverters.to_list_str)
    output_col = Param("assembled features column", default="features")
    one_hot_encode_categoricals = Param("one-hot under threshold", default=True,
                                        converter=TypeConverters.to_bool)
    number_of_features = Param("hash dims for text", default=256,
                               converter=TypeConverters.to_int)
    categorical_threshold = Param("max distinct for one-hot", default=100,
                                  converter=TypeConverters.to_int)

    def _fit(self, table: Table) -> "FeaturizeModel":
        strategies: Dict[str, dict] = {}
        for c in self.input_cols:
            col = table[c]
            if col.ndim > 1:
                strategies[c] = {"kind": "vector", "dim": int(col.shape[1])}
            elif col.dtype == object and len(col) and isinstance(col[0], np.ndarray):
                strategies[c] = {"kind": "vector", "dim": int(len(col[0]))}
            elif col.dtype.kind in "ifub":
                vals = np.asarray(col, dtype=np.float64)
                valid = vals[~np.isnan(vals)]
                strategies[c] = {"kind": "numeric",
                                 "mean": float(valid.mean()) if len(valid) else 0.0}
            else:
                values = [str(v) for v in col]
                distinct = sorted(set(values))
                if (
                    self.one_hot_encode_categoricals
                    and len(distinct) <= self.categorical_threshold
                ):
                    strategies[c] = {"kind": "onehot", "levels": distinct}
                else:
                    strategies[c] = {"kind": "hash", "dims": self.number_of_features}
        return FeaturizeModel(
            input_cols=self.input_cols,
            output_col=self.output_col,
            strategies=strategies,
        )


@register_stage
class FeaturizeModel(Model):
    input_cols = Param("columns to featurize", converter=TypeConverters.to_list_str)
    output_col = Param("assembled features column", default="features")
    strategies = ComplexParam("column -> strategy dict")

    def _block(self, table: Table, c: str) -> np.ndarray:
        strat = self.strategies[c]
        col = table[c]
        n = table.num_rows
        kind = strat["kind"]
        if kind == "numeric":
            vals = np.asarray(col, dtype=np.float64)
            vals = np.where(np.isnan(vals), strat["mean"], vals)
            return vals[:, None]
        if kind == "vector":
            if col.dtype == object:
                return np.stack([np.asarray(v, dtype=np.float64) for v in col])
            return np.asarray(col, dtype=np.float64)
        if kind == "onehot":
            index = {v: i for i, v in enumerate(strat["levels"])}
            out = np.zeros((n, len(index)), dtype=np.float64)
            for i, v in enumerate(col):
                j = index.get(str(v))
                if j is not None:
                    out[i, j] = 1.0
            return out
        if kind == "hash":
            dims = strat["dims"]
            out = np.zeros((n, dims), dtype=np.float64)
            for i, v in enumerate(col):
                for tok in str(v).split():
                    out[i, _hash_token(tok, dims)] += 1.0
            return out
        raise ValueError(f"unknown strategy {kind!r}")

    def _transform(self, table: Table) -> Table:
        if not self.input_cols:
            raise ValueError("Featurize: no input columns to featurize")
        blocks = [self._block(table, c) for c in self.input_cols]
        feats = np.concatenate(blocks, axis=1).astype(np.float32)
        return table.with_column(self.output_col, feats)


@register_stage
class DataConversion(Transformer):
    """Column type conversion (featurize/DataConversion.scala:21-173).
    convert_to: boolean|byte|short|integer|long|float|double|string|categorical
    """

    cols = Param("columns to convert", converter=TypeConverters.to_list_str)
    convert_to = Param("target type", default="double")

    _NUMPY = {"boolean": np.bool_, "byte": np.int8, "short": np.int16,
              "integer": np.int32, "long": np.int64, "float": np.float32,
              "double": np.float64}

    def _transform(self, table: Table) -> Table:
        t = self.convert_to.lower()
        for c in self.cols:
            col = table[c]
            if t in self._NUMPY:
                table = table.with_column(c, np.asarray(col).astype(self._NUMPY[t]))
            elif t == "string":
                table = table.with_column(c, [str(v) for v in col])
            elif t == "categorical":
                vals = [v.item() if isinstance(v, np.generic) else v for v in col]
                cm = CategoricalMap(sorted(set(vals)))
                idx = np.array([cm.get_index(v) for v in vals], dtype=np.int32)
                table = table.with_column(c, idx, meta={"categorical": cm})
            else:
                raise ValueError(f"DataConversion: unknown target {self.convert_to!r}")
        return table


@register_stage
class CountSelector(Estimator):
    """Drop always-zero slots from a vector column (featurize/CountSelector.scala)."""

    input_col = Param("vector column", default="features")
    output_col = Param("selected vector column", default="features")

    def _fit(self, table: Table) -> "CountSelectorModel":
        col = table[self.input_col]
        mat = (np.stack([np.asarray(v) for v in col])
               if col.dtype == object else np.asarray(col))
        keep = np.where(np.abs(mat).sum(axis=0) > 0)[0]
        return CountSelectorModel(
            input_col=self.input_col, output_col=self.output_col,
            indices=keep.astype(np.int64),
        )


@register_stage
class CountSelectorModel(Model):
    input_col = Param("vector column", default="features")
    output_col = Param("selected vector column", default="features")
    indices = ComplexParam("kept slot indices")

    def _transform(self, table: Table) -> Table:
        col = table[self.input_col]
        mat = (np.stack([np.asarray(v) for v in col])
               if col.dtype == object else np.asarray(col))
        return table.with_column(self.output_col, mat[:, np.asarray(self.indices)])
