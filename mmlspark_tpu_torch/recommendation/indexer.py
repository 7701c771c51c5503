"""RecommendationIndexer: string user/item ids -> contiguous indices.

Reference: core recommendation/RecommendationIndexer.scala (user+item
StringIndexer pair with inverse transform for recommendations).

A copy of the JAX package's `recommendation/indexer.py` for this
package.
"""
from __future__ import annotations

import numpy as np

from ..core.params import ComplexParam, Param
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import CategoricalMap, Table

__all__ = ["RecommendationIndexer", "RecommendationIndexerModel"]


@register_stage
class RecommendationIndexer(Estimator):
    user_input_col = Param("raw user column", default="customerID")
    user_output_col = Param("indexed user column", default="user")
    item_input_col = Param("raw item column", default="itemID")
    item_output_col = Param("indexed item column", default="item")
    rating_col = Param("rating column (passed through)", default="rating")

    def _fit(self, table: Table) -> "RecommendationIndexerModel":
        users = CategoricalMap(sorted({str(v) for v in table[self.user_input_col]}))
        items = CategoricalMap(sorted({str(v) for v in table[self.item_input_col]}))
        return RecommendationIndexerModel(
            user_map=users, item_map=items,
            user_input_col=self.user_input_col,
            user_output_col=self.user_output_col,
            item_input_col=self.item_input_col,
            item_output_col=self.item_output_col,
        )


@register_stage
class RecommendationIndexerModel(Model):
    user_input_col = Param("raw user column", default="customerID")
    user_output_col = Param("indexed user column", default="user")
    item_input_col = Param("raw item column", default="itemID")
    item_output_col = Param("indexed item column", default="item")
    user_map = ComplexParam("user CategoricalMap")
    item_map = ComplexParam("item CategoricalMap")

    def _transform(self, table: Table) -> Table:
        umap: CategoricalMap = self.user_map
        imap: CategoricalMap = self.item_map
        u = np.array(
            [umap.get_index_option(str(v)) for v in table[self.user_input_col]],
            dtype=object,
        )
        i = np.array(
            [imap.get_index_option(str(v)) for v in table[self.item_input_col]],
            dtype=object,
        )
        keep = np.array([x is not None for x in u], dtype=bool) & np.array(
            [x is not None for x in i], dtype=bool
        )
        out = table.filter(keep)
        out = out.with_column(
            self.user_output_col,
            np.array([x for x in u[keep]], np.int64),
        )
        return out.with_column(
            self.item_output_col,
            np.array([x for x in i[keep]], np.int64),
        )

    def recover_user(self, index: int) -> str:
        return self.user_map.get_level(index)

    def recover_item(self, index: int) -> str:
        return self.item_map.get_level(index)
