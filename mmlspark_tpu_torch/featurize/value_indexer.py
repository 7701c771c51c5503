"""ValueIndexer: categorical value <-> index with metadata round-trip.

Reference: core featurize/ValueIndexer.scala:56-203 (ValueIndexer /
ValueIndexerModel) and IndexToValue.scala — indexes arbitrary typed label
columns, storing the level map in column metadata so downstream stages
(TrainClassifier, ComputeModelStatistics) can invert predictions.  A copy
of the JAX package's `featurize/value_indexer.py` for this package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Model, Transformer
from ..core.registry import register_stage
from ..core.schema import CategoricalMap, Table

__all__ = ["ValueIndexer", "ValueIndexerModel", "IndexToValue"]


@register_stage
class ValueIndexer(Estimator):
    input_col = Param("column to index", default="label")
    output_col = Param("indexed column", default="indexed")

    def _fit(self, table: Table) -> "ValueIndexerModel":
        col = table[self.input_col]
        vals = [v.item() if isinstance(v, np.generic) else v for v in col]
        non_null = [v for v in vals if v is not None]
        try:
            levels = sorted(set(non_null))
        except TypeError:  # mixed uncomparable types
            levels = list(dict.fromkeys(non_null))
        return ValueIndexerModel(
            input_col=self.input_col,
            output_col=self.output_col,
            levels=CategoricalMap(levels),
        )


@register_stage
class ValueIndexerModel(Model):
    input_col = Param("column to index", default="label")
    output_col = Param("indexed column", default="indexed")
    levels = ComplexParam("CategoricalMap of levels")

    def _transform(self, table: Table) -> Table:
        cm: CategoricalMap = self.levels
        out = np.empty(table.num_rows, dtype=np.float64)
        for i, v in enumerate(table[self.input_col]):
            v = v.item() if isinstance(v, np.generic) else v
            idx = cm.get_index_option(v)
            if idx is None:
                raise ValueError(
                    f"ValueIndexerModel: value {v!r} not seen during fit "
                    f"(levels: {cm.levels[:10]}...)"
                )
            out[i] = idx
        return table.with_column(
            self.output_col, out, meta={"categorical": cm}
        )


@register_stage
class IndexToValue(Transformer):
    """Inverse mapping using the categorical metadata on the input column
    (featurize/IndexToValue.scala)."""

    input_col = Param("indexed column", default="indexed")
    output_col = Param("restored column", default="value")

    def _transform(self, table: Table) -> Table:
        cm: Optional[CategoricalMap] = table.get_meta(self.input_col).get("categorical")
        if cm is None:
            raise ValueError(
                f"IndexToValue: column '{self.input_col}' has no categorical metadata"
            )
        vals = [cm.get_level(int(i)) for i in table[self.input_col]]
        return table.with_column(self.output_col, vals)
