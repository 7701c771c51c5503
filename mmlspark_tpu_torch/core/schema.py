"""Columnar Table: the framework's DataFrame-equivalent.

A copy of the JAX package's `core/schema.py` for this package.

The reference builds on Spark DataFrames; the core data structure here is a
host-side *columnar batch* designed to feed host->device copies directly:
every column is a NumPy array (dense numeric columns are device-feedable
as-is; ragged / object columns hold Python values).  Column-level metadata mirrors
Spark's column metadata (categorical maps, label/score tagging):

  - categorical metadata  <- reference core/schema/Categoricals.scala:150
  - label/score tagging   <- reference core/schema/SparkSchema.scala:11
  - image schema          <- reference core/schema/ImageSchemaUtils.scala:9
  - findUnusedColumnName  <- reference core/schema/DatasetExtensions.scala:11
"""
from __future__ import annotations

import numpy as np
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence

__all__ = [
    "Table",
    "CategoricalMap",
    "find_unused_column_name",
    "features_matrix",
    "IMAGE_FIELDS",
    "is_image_column",
]


def features_matrix(col: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Densify a features column to an (N, D) matrix: typed 2-D columns pass
    through, object columns of per-row vectors are stacked."""
    if col.dtype == object:
        return np.stack([np.asarray(v, dtype=dtype) for v in col])
    return np.asarray(col, dtype=dtype)

# Spark-style image row: struct<origin,height,width,nChannels,mode,data>
# (reference org/apache/spark/ml/source/image schema; ImageSchemaUtils.scala:9).
IMAGE_FIELDS = ("origin", "height", "width", "nChannels", "mode", "data")


def _as_column(values: Any) -> np.ndarray:
    """Coerce to a 1-D (or n-D with leading row axis) numpy array.

    Lists of scalars become typed arrays; ragged lists become object arrays.
    """
    if isinstance(values, np.ndarray):
        return values
    if isinstance(values, (list, tuple)):
        try:
            arr = np.asarray(values)
            if arr.dtype == object or arr.dtype.kind in "OSU" and not all(
                isinstance(v, str) for v in values
            ):
                raise ValueError
            return arr
        except ValueError:
            arr = np.empty(len(values), dtype=object)
            for i, v in enumerate(values):
                arr[i] = v
            return arr
    raise TypeError(f"cannot build column from {type(values)}")


class CategoricalMap:
    """Bidirectional value<->index map stored as column metadata.

    Reference: core/schema/Categoricals.scala:150-314 (CategoricalMap / CategoricalUtilities).
    """

    def __init__(self, levels: Sequence[Any], ordinal: bool = False):
        self.levels: List[Any] = list(levels)
        self.ordinal = bool(ordinal)
        self._index: Dict[Any, int] = {v: i for i, v in enumerate(self.levels)}

    def get_index(self, value: Any) -> int:
        return self._index[value]

    def get_index_option(self, value: Any) -> Optional[int]:
        return self._index.get(value)

    def get_level(self, index: int) -> Any:
        return self.levels[int(index)]

    def __len__(self) -> int:
        return len(self.levels)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, CategoricalMap)
            and self.levels == other.levels
            and self.ordinal == other.ordinal
        )

    def to_json(self) -> dict:
        return {"levels": [_json_safe(v) for v in self.levels], "ordinal": self.ordinal}

    @staticmethod
    def from_json(d: dict) -> "CategoricalMap":
        return CategoricalMap(d["levels"], d.get("ordinal", False))


def _json_safe(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def find_unused_column_name(prefix: str, existing: Iterable[str]) -> str:
    """Reference: core/schema/DatasetExtensions.scala:11 (findUnusedColumnName)."""
    existing = set(existing)
    if prefix not in existing:
        return prefix
    i = 1
    while f"{prefix}_{i}" in existing:
        i += 1
    return f"{prefix}_{i}"


def is_image_column(table: "Table", col: str) -> bool:
    """True if the column holds image-struct dicts (ImageSchemaUtils.scala:9)."""
    if col not in table.columns:
        return False
    arr = table[col]
    if arr.dtype != object or len(arr) == 0:
        return False
    v = arr[0]
    return isinstance(v, dict) and {"height", "width", "nChannels", "data"} <= set(v)


class Table:
    """An ordered, immutable-by-convention columnar batch.

    Columns are numpy arrays sharing a leading row axis.  `meta` carries
    per-column metadata dicts (e.g. {"categorical": CategoricalMap, "ml_attr":...}).
    """

    def __init__(
        self,
        columns: Mapping[str, Any],
        meta: Optional[Mapping[str, dict]] = None,
    ):
        self.columns: Dict[str, np.ndarray] = {}
        n = None
        for name, values in columns.items():
            arr = _as_column(values)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"column '{name}' has {len(arr)} rows, expected {n}"
                )
            self.columns[name] = arr
        self._num_rows = 0 if n is None else int(n)
        self.meta: Dict[str, dict] = {k: dict(v) for k, v in (meta or {}).items()}

    # ---- construction -------------------------------------------------
    @staticmethod
    def from_pandas(df) -> "Table":
        cols = {}
        for c in df.columns:
            s = df[c]
            if s.dtype == object:
                cols[c] = _as_column(list(s))
            else:
                cols[c] = s.to_numpy()
        return Table(cols)

    @staticmethod
    def from_records(records: Sequence[Mapping[str, Any]], names: Optional[Sequence[str]] = None) -> "Table":
        if not records:
            return Table({name: [] for name in (names or [])})
        names = list(names or records[0].keys())
        return Table({n: [r.get(n) for r in records] for n in names})

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({k: list(v) if v.ndim > 1 or v.dtype == object else v
                             for k, v in self.columns.items()})

    # ---- basic accessors ----------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    @property
    def column_names(self) -> List[str]:
        return list(self.columns.keys())

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def get_meta(self, name: str) -> dict:
        return self.meta.get(name, {})

    def rows(self) -> Iterator[Dict[str, Any]]:
        names = self.column_names
        for i in range(self._num_rows):
            yield {n: self.columns[n][i] for n in names}

    # ---- transformations (all return new Tables) ----------------------
    def with_column(self, name: str, values: Any, meta: Optional[dict] = None) -> "Table":
        cols = dict(self.columns)
        arr = _as_column(values)
        if self.columns and len(arr) != self._num_rows:
            raise ValueError(
                f"column '{name}' has {len(arr)} rows, expected {self._num_rows}"
            )
        cols[name] = arr
        new_meta = dict(self.meta)
        if meta is not None:
            new_meta[name] = dict(meta)
        return Table(cols, new_meta)

    def with_meta(self, name: str, meta: dict) -> "Table":
        new_meta = dict(self.meta)
        new_meta[name] = dict(meta)
        return Table(self.columns, new_meta)

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names},
                     {n: m for n, m in self.meta.items() if n in names})

    def drop(self, *names: str) -> "Table":
        drop = set(names)
        return Table({n: v for n, v in self.columns.items() if n not in drop},
                     {n: m for n, m in self.meta.items() if n not in drop})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        cols = {mapping.get(n, n): v for n, v in self.columns.items()}
        meta = {mapping.get(n, n): m for n, m in self.meta.items()}
        return Table(cols, meta)

    def take(self, indices) -> "Table":
        idx = np.asarray(indices)
        return Table({n: v[idx] for n, v in self.columns.items()}, self.meta)

    def slice(self, start: int, stop: Optional[int] = None) -> "Table":
        sl = slice(start, stop)
        return Table({n: v[sl] for n, v in self.columns.items()}, self.meta)

    def filter(self, mask) -> "Table":
        mask = np.asarray(mask, dtype=bool)
        return Table({n: v[mask] for n, v in self.columns.items()}, self.meta)

    def head(self, n: int = 5) -> "Table":
        return self.slice(0, n)

    def map_column(self, name: str, fn: Callable[[Any], Any], out: Optional[str] = None) -> "Table":
        out = out or name
        return self.with_column(out, [fn(v) for v in self.columns[name]])

    def iter_batches(self, batch_size: int) -> Iterator["Table"]:
        for start in range(0, self._num_rows, batch_size):
            yield self.slice(start, start + batch_size)

    def shuffle(self, seed: int = 0) -> "Table":
        rng = np.random.default_rng(seed)
        return self.take(rng.permutation(self._num_rows))

    def sort_by(self, name: str, descending: bool = False) -> "Table":
        order = np.argsort(self.columns[name], kind="stable")
        if descending:
            order = order[::-1]
        return self.take(order)

    def group_indices(self, name: str) -> Dict[Any, np.ndarray]:
        """Map each distinct key in `name` to the row indices holding it."""
        out: Dict[Any, List[int]] = {}
        for i, v in enumerate(self.columns[name]):
            key = v.item() if isinstance(v, np.generic) else v
            out.setdefault(key, []).append(i)
        return {k: np.asarray(ix) for k, ix in out.items()}

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        tables = [t for t in tables if t.num_rows > 0] or list(tables[:1])
        if not tables:
            return Table({})
        names = tables[0].column_names
        cols = {}
        for n in names:
            parts = [t.columns[n] for t in tables]
            if any(p.dtype == object for p in parts):
                merged = np.empty(sum(len(p) for p in parts), dtype=object)
                i = 0
                for p in parts:
                    merged[i : i + len(p)] = p
                    i += len(p)
                cols[n] = merged
            else:
                cols[n] = np.concatenate(parts, axis=0)
        meta = {}
        for t in tables:
            meta.update(t.meta)
        return Table(cols, meta)

    # ---- equality (used by the fuzzing harness) ------------------------
    def approx_equals(self, other: "Table", rtol: float = 1e-5, atol: float = 1e-6) -> bool:
        """DataFrameEquality analog (reference core/test/base/TestBase.scala)."""
        if self.column_names != other.column_names or self.num_rows != other.num_rows:
            return False
        for n in self.column_names:
            a, b = self.columns[n], other.columns[n]
            if a.dtype == object or b.dtype == object:
                for x, y in zip(a, b):
                    if not _values_close(x, y, rtol, atol):
                        return False
            elif a.dtype.kind in "fc":
                if not np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
                    return False
            else:
                if not np.array_equal(a, b):
                    return False
        return True

    def __repr__(self) -> str:
        spec = ", ".join(
            f"{n}:{v.dtype}{list(v.shape[1:]) if v.ndim > 1 else ''}"
            for n, v in self.columns.items()
        )
        return f"Table[{self._num_rows} rows]({spec})"


def _values_close(x, y, rtol, atol) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(x, dict) and isinstance(y, dict):
        return set(x) == set(y) and all(_values_close(x[k], y[k], rtol, atol) for k in x)
    if isinstance(x, (list, tuple, np.ndarray)) or isinstance(y, (list, tuple, np.ndarray)):
        xa, ya = np.asarray(x), np.asarray(y)
        if xa.shape != ya.shape:
            return False
        if xa.dtype == object:
            return all(_values_close(a, b, rtol, atol) for a, b in zip(xa.ravel(), ya.ravel()))
        if xa.dtype.kind in "fc":
            return bool(np.allclose(xa, ya, rtol=rtol, atol=atol, equal_nan=True))
        return bool(np.array_equal(xa, ya))
    if isinstance(x, float) or isinstance(y, float):
        return bool(np.isclose(float(x), float(y), rtol=rtol, atol=atol, equal_nan=True))
    return x == y
