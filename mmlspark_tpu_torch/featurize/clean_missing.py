"""CleanMissingData: imputation estimator.

Reference: core featurize/CleanMissingData.scala:48-182 — mean/median/custom
imputation over numeric columns, NaN/None treated as missing.  A copy of
the JAX package's `featurize/clean_missing.py` for this package.
"""
from __future__ import annotations

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = ["CleanMissingData", "CleanMissingDataModel"]


@register_stage
class CleanMissingData(Estimator):
    input_cols = Param("columns to clean", converter=TypeConverters.to_list_str)
    output_cols = Param("output columns (default: in place)", default=None)
    cleaning_mode = Param("Mean|Median|Custom", default="Mean")
    custom_value = Param("fill value for Custom mode", default=None)

    def _fit(self, table: Table) -> "CleanMissingDataModel":
        fills = {}
        mode = self.cleaning_mode.lower()
        for c in self.input_cols:
            col = np.asarray(table[c], dtype=np.float64)
            valid = col[~np.isnan(col)]
            if mode == "mean":
                fills[c] = float(valid.mean()) if len(valid) else 0.0
            elif mode == "median":
                fills[c] = float(np.median(valid)) if len(valid) else 0.0
            elif mode == "custom":
                if self.custom_value is None:
                    raise ValueError("CleanMissingData: Custom mode needs custom_value")
                fills[c] = float(self.custom_value)
            else:
                raise ValueError(f"unknown cleaning_mode {self.cleaning_mode!r}")
        return CleanMissingDataModel(
            input_cols=self.input_cols,
            output_cols=self.output_cols,
            fill_values=fills,
        )


@register_stage
class CleanMissingDataModel(Model):
    input_cols = Param("columns to clean", converter=TypeConverters.to_list_str)
    output_cols = Param("output columns", default=None)
    fill_values = ComplexParam("column -> fill value")

    def _transform(self, table: Table) -> Table:
        outs = self.output_cols or self.input_cols
        for c, o in zip(self.input_cols, outs):
            col = np.asarray(table[c], dtype=np.float64)
            filled = np.where(np.isnan(col), self.fill_values[c], col)
            table = table.with_column(o, filled)
        return table
