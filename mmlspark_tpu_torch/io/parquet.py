"""Parquet read/write for Tables.

The reference's pipelines live on parquet (every Spark DataFrame
checkpoint, the generated python fuzz fixtures — Fuzzing.scala:47-140
writes saved parquet fixtures); a user switching over needs their data
to load.  Arrow is the bridge: columnar both sides, so dense numeric
columns map zero-ish-copy, strings/bytes/lists round-trip through the
object dtype.  A copy of the JAX package's `io/parquet.py` for this
package; `pyarrow` is imported at the first call.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.schema import Table

__all__ = ["read_parquet", "write_parquet"]


def read_parquet(path: str, columns: Optional[List[str]] = None) -> Table:
    """One parquet file (or directory of row-group files) -> Table."""
    import pyarrow.parquet as pq

    at = pq.read_table(path, columns=columns)
    data = {}
    for name in at.column_names:
        col = at.column(name)
        np_col = col.to_numpy(zero_copy_only=False)
        if np_col.dtype.kind == "O":
            # list<...> columns arrive as object-of-ndarray already;
            # bytes/str stay objects — both are Table's ragged convention
            arr = np.empty(len(np_col), object)
            for i, v in enumerate(np_col):
                arr[i] = v
            np_col = arr
        data[name] = np_col
    return Table(data)


def write_parquet(table: Table, path: str) -> None:
    """Table -> one parquet file.  Dense numeric columns write as native
    arrow types; object columns become list/binary/string columns."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    cols, names = [], []
    for name in table.column_names:
        col = table[name]
        if col.dtype.kind == "O":
            cols.append(pa.array(list(col)))
        elif col.ndim > 1:
            # fixed-width matrices (feature vectors) write as lists —
            # the Spark VectorUDT-ish convention readers expect
            cols.append(pa.array(list(np.asarray(col))))
        else:
            cols.append(pa.array(col))
        names.append(name)
    pq.write_table(pa.Table.from_arrays(cols, names=names), path)
