"""Hashed sparse featurization: columns -> (indices, values) namespaces.

Reference: vw/VowpalWabbitFeaturizer.scala:231 with per-type strategies in
vw/featurizer/*.scala (Numeric/String/StringSplit/Map/Seq/Vector/Boolean) and
client-side quadratic interactions vw/VowpalWabbitInteractions.scala:96 +
VectorZipper.scala.

A featurized row is a pair of same-length arrays (indices uint32 in
[0, 2^num_bits), values float32); duplicate indices accumulate at update time
(collision semantics identical to VW's weight-table adds).
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ..core.params import Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table
from .hashing import FeatureHasher

__all__ = ["VowpalWabbitFeaturizer", "VowpalWabbitInteractions", "VectorZipper",
           "sparse_to_padded"]


def _featurize_value(hasher: FeatureHasher, col: str, v: Any,
                     split: bool, idx: List[int], val: List[float]) -> None:
    """Per-type strategy dispatch (reference featurizer/*.scala)."""
    if v is None:
        return
    if isinstance(v, (bool, np.bool_)):
        if v:
            idx.append(hasher(col, col))
            val.append(1.0)
    elif isinstance(v, (int, float, np.integer, np.floating)):
        if v != 0:
            idx.append(hasher(col, col))
            val.append(float(v))
    elif isinstance(v, str):
        toks = v.split() if split else [v]
        for t in toks:
            idx.append(hasher(col, t))
            val.append(1.0)
    elif isinstance(v, dict):
        for k, x in v.items():
            if isinstance(x, (int, float, np.integer, np.floating)):
                idx.append(hasher(col, str(k)))
                val.append(float(x))
            else:
                idx.append(hasher(col, f"{k}={x}"))
                val.append(1.0)
    elif isinstance(v, np.ndarray) and v.dtype.kind in "fiu":
        base = hasher.namespace_seed(col)
        d = v.shape[0]
        indices = (base + np.arange(d, dtype=np.uint64)) & np.uint64(hasher.mask)
        nz = np.nonzero(v)[0]
        idx.extend(int(i) for i in indices[nz])
        val.extend(float(x) for x in v[nz])
    elif isinstance(v, (list, tuple)):
        for item in v:
            _featurize_value(hasher, col, item, split, idx, val)
    else:
        idx.append(hasher(col, str(v)))
        val.append(1.0)


@register_stage
class VowpalWabbitFeaturizer(Transformer):
    """Hash arbitrary typed columns into one sparse namespace column.

    Reference: vw/VowpalWabbitFeaturizer.scala:231.
    """

    input_cols = Param("columns to featurize", default=None,
                       converter=TypeConverters.to_list_str)
    output_col = Param("sparse features output column", default="features")
    num_bits = Param("weight-table bits (dim = 2^bits)", default=18,
                     converter=TypeConverters.to_int)
    seed = Param("hash seed", default=0, converter=TypeConverters.to_int)
    string_split_cols = Param("string columns to tokenize on whitespace",
                              default=None, converter=TypeConverters.to_list_str)
    sum_collisions = Param("accumulate colliding indices (vs last-wins)",
                           default=True, converter=TypeConverters.to_bool)

    def __init__(self, **kw):
        super().__init__(**kw)

    def _transform(self, table: Table) -> Table:
        cols = self.get_or_default("input_cols") or [
            c for c in table.column_names if c != self.output_col
        ]
        split_set = set(self.get_or_default("string_split_cols") or [])
        hasher = FeatureHasher(int(self.num_bits), int(self.seed))
        n = len(table)
        out = np.empty(n, dtype=object)
        data = {c: table[c] for c in cols}
        for i in range(n):
            idx: List[int] = []
            val: List[float] = []
            for c in cols:
                _featurize_value(hasher, c, data[c][i], c in split_set, idx, val)
            ind = np.asarray(idx, np.uint32)
            va = np.asarray(val, np.float32)
            if self.sum_collisions and len(ind):
                uniq, inv = np.unique(ind, return_inverse=True)
                acc = np.zeros(len(uniq), np.float32)
                np.add.at(acc, inv, va)
                ind, va = uniq, acc
            out[i] = (ind, va)
        return table.with_column(self.output_col, out,
                                 meta={"num_bits": int(self.num_bits)})


@register_stage
class VowpalWabbitInteractions(Transformer):
    """Client-side quadratic feature interactions between namespaces.

    Reference: vw/VowpalWabbitInteractions.scala:96 — for namespaces (a, b),
    the crossed index is the VW pairing `h(a)*prime + h(b)` masked to the
    table, value = v_a * v_b.
    """

    input_cols = Param("sparse namespace columns to cross", default=None,
                       converter=TypeConverters.to_list_str)
    output_col = Param("crossed output column", default="interactions")
    num_bits = Param("weight-table bits", default=18,
                     converter=TypeConverters.to_int)

    _PRIME = 16777619  # FNV prime, same role as VW's quadratic constant

    def __init__(self, **kw):
        super().__init__(**kw)

    def _transform(self, table: Table) -> Table:
        cols = self.get_or_default("input_cols")
        if not cols or len(cols) < 2:
            raise ValueError("VowpalWabbitInteractions needs >= 2 input_cols")
        mask = (1 << int(self.num_bits)) - 1
        n = len(table)
        out = np.empty(n, dtype=object)
        col_data = [table[c] for c in cols]
        for i in range(n):
            ind_acc, val_acc = None, None
            for data in col_data:
                ind_b, val_b = data[i]
                if ind_acc is None:
                    ind_acc = ind_b.astype(np.uint64)
                    val_acc = val_b.astype(np.float32)
                    continue
                cross_i = (
                    (ind_acc[:, None] * self._PRIME + ind_b[None, :].astype(np.uint64))
                    & np.uint64(mask)
                ).reshape(-1)
                cross_v = (val_acc[:, None] * val_b[None, :]).reshape(-1)
                ind_acc, val_acc = cross_i, cross_v
            out[i] = (ind_acc.astype(np.uint32), val_acc.astype(np.float32))
        return table.with_column(self.output_col, out,
                                 meta={"num_bits": int(self.num_bits)})


@register_stage
class VectorZipper(Transformer):
    """Zip several columns into one column of tuples (reference
    vw/VectorZipper.scala) — used to assemble ADF action lists."""

    input_cols = Param("columns to zip", default=None,
                       converter=TypeConverters.to_list_str)
    output_col = Param("output column", default="zipped")

    def __init__(self, **kw):
        super().__init__(**kw)

    def _transform(self, table: Table) -> Table:
        cols = self.get_or_default("input_cols")
        n = len(table)
        out = np.empty(n, dtype=object)
        data = [table[c] for c in cols]
        for i in range(n):
            out[i] = [d[i] for d in data]
        return table.with_column(self.output_col, out)


def sparse_to_padded(col: np.ndarray, max_active: Optional[int] = None):
    """Stack a sparse (indices, values) object column into padded device
    arrays (n, A) uint32 / float32.  Padding uses index 0 with value 0 —
    a no-op in every scatter/gather because the value multiplies through."""
    n = len(col)
    if max_active is None:
        max_active = max((len(v[0]) for v in col), default=1)
    max_active = max(max_active, 1)
    idx = np.zeros((n, max_active), np.uint32)
    val = np.zeros((n, max_active), np.float32)
    for i, (ind, va) in enumerate(col):
        a = min(len(ind), max_active)
        idx[i, :a] = ind[:a]
        val[i, :a] = va[:a]
    return idx, val
