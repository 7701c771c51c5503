"""Plumbing transformers: the fully-serializable pipeline stage toolbox.

Reference: core stages/*.scala — DropColumns, SelectColumns, RenameColumn,
Repartition, Cacher, Explode, UDFTransformer (UDFTransformer.scala:26),
MultiColumnAdapter (:19), EnsembleByKey (:20), ClassBalancer (:25),
SummarizeData (:101), Timer (:55), StratifiedRepartition (:31),
PartitionConsolidator (PartitionConsolidator.scala:22).  A copy of the
JAX package's `stages/basic.py` for this package; `StratifiedRepartition`'s
default shard count is `utils.cluster.get_num_shards()` (the world size
inside a process group, else the local card count).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model, Transformer
from ..core.registry import register_stage
from ..core.schema import Table
from ..core.shared import shared_singleton

__all__ = [
    "DropColumns",
    "SelectColumns",
    "RenameColumn",
    "Repartition",
    "Cacher",
    "Explode",
    "UDFTransformer",
    "MultiColumnAdapter",
    "EnsembleByKey",
    "ClassBalancer",
    "ClassBalancerModel",
    "SummarizeData",
    "Timer",
    "TimerModel",
    "StratifiedRepartition",
    "PartitionConsolidator",
]


@register_stage
class DropColumns(Transformer):
    cols = Param("columns to drop", default=None, converter=TypeConverters.to_list_str)

    def __init__(self, cols: Optional[List[str]] = None, **kw):
        super().__init__(**kw)
        if cols is not None:
            self.set(cols=cols)

    def _transform(self, table: Table) -> Table:
        return table.drop(*(self.cols or []))

    def transform_schema(self, columns: List[str]) -> List[str]:
        drop = set(self.cols or [])
        missing = drop - set(columns)
        if missing:
            raise ValueError(f"DropColumns: missing columns {sorted(missing)}")
        return [c for c in columns if c not in drop]


@register_stage
class SelectColumns(Transformer):
    cols = Param("columns to keep", default=None, converter=TypeConverters.to_list_str)

    def __init__(self, cols: Optional[List[str]] = None, **kw):
        super().__init__(**kw)
        if cols is not None:
            self.set(cols=cols)

    def _transform(self, table: Table) -> Table:
        return table.select(self.cols or [])

    def transform_schema(self, columns: List[str]) -> List[str]:
        missing = set(self.cols or []) - set(columns)
        if missing:
            raise ValueError(f"SelectColumns: missing columns {sorted(missing)}")
        return list(self.cols or [])


@register_stage
class RenameColumn(Transformer):
    input_col = Param("source column")
    output_col = Param("target column")

    def _transform(self, table: Table) -> Table:
        return table.rename({self.input_col: self.output_col})


@register_stage
class Repartition(Transformer):
    """Sets the shard-count hint used when sharding a table over devices.
    In Spark this physically repartitions; here partitioning is logical —
    `num_partitions` is recorded in table meta for downstream shard-aware
    stages.  Reference: stages/Repartition.scala.
    """

    n = Param("number of partitions", default=1, converter=TypeConverters.to_int)

    def _transform(self, table: Table) -> Table:
        return table.with_meta("__partitioning__", {"num_partitions": self.n})


@register_stage
class Cacher(Transformer):
    """Materialization point.  Columnar tables are already materialized, so
    this is an (intentional) identity kept for pipeline parity.
    Reference: stages/Cacher.scala."""

    def _transform(self, table: Table) -> Table:
        return table


@register_stage
class Explode(Transformer):
    """One output row per element of a list-typed column; other columns are
    repeated.  Reference: stages/Explode.scala."""

    input_col = Param("column of sequences")

    def _transform(self, table: Table) -> Table:
        col = table[self.input_col]
        counts = [len(v) for v in col]
        idx = np.repeat(np.arange(table.num_rows), counts)
        exploded = [x for v in col for x in v]
        out = table.take(idx)
        return out.with_column(self.input_col, exploded)


@register_stage
class UDFTransformer(Transformer):
    """Apply a python function to one column (or a row-dict for multi-input).
    Reference: stages/UDFTransformer.scala:26."""

    input_col = Param("input column", default=None)
    input_cols = Param("input columns (row-dict mode)", default=None)
    output_col = Param("output column")
    udf = ComplexParam("value(s) -> value callable")

    def _transform(self, table: Table) -> Table:
        fn = self.udf
        if self.input_col is not None:
            out = [fn(v) for v in table[self.input_col]]
        else:
            cols = [table[c] for c in self.input_cols]
            out = [fn(*vals) for vals in zip(*cols)]
        return table.with_column(self.output_col, out)


@register_stage
class MultiColumnAdapter(Transformer):
    """Replicate a single-column stage across many columns.
    Reference: stages/MultiColumnAdapter.scala:19."""

    base_stage = ComplexParam("stage with input_col/output_col params")
    input_cols = Param("input columns", converter=TypeConverters.to_list_str)
    output_cols = Param("output columns", converter=TypeConverters.to_list_str)

    def _transform(self, table: Table) -> Table:
        for i, o in zip(self.input_cols, self.output_cols):
            stage = self.base_stage.copy({"input_col": i, "output_col": o})
            stage.uid = f"{self.base_stage.uid}_{i}"
            table = stage.transform(table)
        return table


@register_stage
class EnsembleByKey(Transformer):
    """Group rows by key column(s) and average numeric/vector columns.
    Reference: stages/EnsembleByKey.scala:20."""

    keys = Param("key columns", converter=TypeConverters.to_list_str)
    cols = Param("value columns to average", converter=TypeConverters.to_list_str)
    col_names = Param("output names", default=None)
    collapse_group = Param("one row per group", default=True,
                           converter=TypeConverters.to_bool)

    def _transform(self, table: Table) -> Table:
        keys = self.keys
        out_names = self.col_names or [f"mean({c})" for c in self.cols]
        key_col = (
            table[keys[0]]
            if len(keys) == 1
            else np.array([tuple(table[k][i] for k in keys) for i in range(table.num_rows)],
                          dtype=object)
        )
        groups: Dict[Any, List[int]] = {}
        for i, k in enumerate(key_col):
            kk = k.item() if isinstance(k, np.generic) else k
            groups.setdefault(kk, []).append(i)
        means: Dict[str, Dict[Any, Any]] = {c: {} for c in self.cols}
        for c in self.cols:
            col = table[c]
            for k, idxs in groups.items():
                vals = [np.asarray(col[i], dtype=np.float64) for i in idxs]
                means[c][k] = np.mean(np.stack(vals), axis=0)
        if self.collapse_group:
            group_keys = list(groups.keys())
            cols: Dict[str, Any] = {}
            for j, k in enumerate(keys):
                cols[k] = [gk if len(keys) == 1 else gk[j] for gk in group_keys]
            for c, o in zip(self.cols, out_names):
                vals = [means[c][gk] for gk in group_keys]
                cols[o] = vals if np.asarray(vals[0]).ndim else np.asarray(vals)
            return Table(cols)
        out = table
        for c, o in zip(self.cols, out_names):
            vals = [means[c][k.item() if isinstance(k, np.generic) else k] for k in key_col]
            out = out.with_column(o, vals if np.asarray(vals[0]).ndim else np.asarray(vals))
        return out


@register_stage
class ClassBalancer(Estimator):
    """Adds an inverse-frequency weight column: weight = max_count / count.
    Reference: stages/ClassBalancer.scala:25."""

    input_col = Param("label column", default="label")
    output_col = Param("weight column", default="weight")
    broadcast_join = Param("kept for API parity", default=True,
                           converter=TypeConverters.to_bool)

    def _fit(self, table: Table) -> "ClassBalancerModel":
        col = table[self.input_col]
        if len(col) == 0:
            raise ValueError("ClassBalancer: cannot fit on an empty table")
        vals, counts = np.unique(np.asarray(col), return_counts=True)
        weights = counts.max() / counts.astype(np.float64)
        return ClassBalancerModel(
            input_col=self.input_col,
            output_col=self.output_col,
            weights={v.item() if isinstance(v, np.generic) else v: float(w)
                     for v, w in zip(vals, weights)},
        )


@register_stage
class ClassBalancerModel(Model):
    input_col = Param("label column", default="label")
    output_col = Param("weight column", default="weight")
    weights = ComplexParam("label -> weight map")

    def _transform(self, table: Table) -> Table:
        w = self.weights
        # unseen labels get NaN, matching the reference's left-join nulls
        out = np.array([w.get(v.item() if isinstance(v, np.generic) else v, np.nan)
                        for v in table[self.input_col]])
        return table.with_column(self.output_col, out)


@register_stage
class SummarizeData(Transformer):
    """Counts / missing / quantile / basic-stat summary per column.
    Reference: stages/SummarizeData.scala:101."""

    counts = Param("include counts", default=True, converter=TypeConverters.to_bool)
    basic = Param("include basic stats", default=True, converter=TypeConverters.to_bool)
    percentiles = Param("include percentiles", default=True, converter=TypeConverters.to_bool)

    def _transform(self, table: Table) -> Table:
        records = []
        for name in table.column_names:
            col = table.columns[name]
            rec: Dict[str, Any] = {"Feature": name}
            is_num = col.dtype.kind in "ifub"
            vals = col.astype(np.float64) if is_num else None
            if self.counts:
                rec["Count"] = float(table.num_rows)
                if is_num:
                    rec["Unique Value Count"] = float(len(np.unique(col)))
                    rec["Missing Value Count"] = float(np.isnan(vals).sum())
                else:
                    rec["Unique Value Count"] = float(len(set(col.tolist())))
                    rec["Missing Value Count"] = float(sum(v is None for v in col))
            if self.basic:
                if is_num and len(vals):
                    rec.update(
                        Min=float(np.nanmin(vals)), Max=float(np.nanmax(vals)),
                        Mean=float(np.nanmean(vals)), Variance=float(np.nanvar(vals, ddof=1))
                        if len(vals) > 1 else 0.0,
                    )
                else:
                    rec.update(Min=np.nan, Max=np.nan, Mean=np.nan, Variance=np.nan)
            if self.percentiles:
                for q, label in [(0.005, "P0.5"), (0.01, "P1"), (0.05, "P5"), (0.25, "P25"),
                                 (0.5, "Median"), (0.75, "P75"), (0.95, "P95"), (0.99, "P99"),
                                 (0.995, "P99.5")]:
                    rec[label] = float(np.nanquantile(vals, q)) if is_num and len(vals) else np.nan
            records.append(rec)
        return Table.from_records(records)


@register_stage
class Timer(Estimator):
    """Wraps a stage and records fit/transform wall time.
    Reference: stages/Timer.scala:55."""

    stage = ComplexParam("wrapped stage")
    log_to_logger = Param("also log", default=True, converter=TypeConverters.to_bool)

    def _fit(self, table: Table) -> "TimerModel":
        inner = self.stage
        t0 = time.perf_counter()
        fitted = inner.fit(table) if isinstance(inner, Estimator) else inner
        fit_time = time.perf_counter() - t0
        return TimerModel(stage=fitted).set(last_fit_time=fit_time)


@register_stage
class TimerModel(Model):
    stage = ComplexParam("wrapped fitted stage")
    last_fit_time = Param("seconds", default=0.0, converter=TypeConverters.to_float)
    last_transform_time = Param("seconds", default=0.0, converter=TypeConverters.to_float)

    def _transform(self, table: Table) -> Table:
        t0 = time.perf_counter()
        out = self.stage.transform(table)
        self.set(last_transform_time=time.perf_counter() - t0)
        return out


@register_stage
class StratifiedRepartition(Transformer):
    """Reassign rows to `n` partitions so every partition sees every label —
    needed by distributed GBDT multiclass (each shard must observe all
    classes).  Emits a `__partition__` column + meta hint.
    Reference: stages/StratifiedRepartition.scala:31."""

    label_col = Param("label column", default="label")
    n = Param("number of partitions", default=None, converter=TypeConverters.to_int)
    mode = Param("equal|original|mixed", default="equal")
    seed = Param("shuffle seed for mixed mode", default=0, converter=TypeConverters.to_int)

    def _transform(self, table: Table) -> Table:
        from ..utils.cluster import get_num_shards

        n = self.n or get_num_shards()
        part = np.zeros(table.num_rows, dtype=np.int32)
        if self.mode == "equal":
            # every partition gets an equal share of every class
            for _, idxs in table.group_indices(self.label_col).items():
                part[idxs] = np.arange(len(idxs)) % n
        elif self.mode == "original":
            # preserve the incoming class distribution per partition
            part = np.arange(table.num_rows, dtype=np.int32) % n
        elif self.mode == "mixed":
            # equal shares, shuffled within each class
            rng = np.random.default_rng(self.seed)
            for _, idxs in table.group_indices(self.label_col).items():
                part[idxs] = rng.permutation(len(idxs)) % n
        else:
            raise ValueError(f"StratifiedRepartition: unknown mode {self.mode!r}")
        out = table.with_column("__partition__", part)
        return out.with_meta("__partitioning__", {"num_partitions": n})


class _ConsolidationRound:
    __slots__ = ("parts", "last_arrival")

    def __init__(self, table, now):
        self.parts = [table]
        self.last_arrival = now


class Consolidator:
    """Election + funnel shared by concurrent transform callers.

    Reference: stages/PartitionConsolidator.scala:51-137 Consolidator — the
    first caller opens a round and is 'chosen'; every caller arriving while
    the round is open deposits its rows INTO the round (atomically, under
    the round lock) and returns empty; the chosen caller closes the round
    once no new deposit has arrived for a grace period and emits everything.
    Because deposit and close both hold the lock, a straggler either lands
    in the round it observed or opens a fresh round it owns — rows can
    never be left behind in a shared buffer after the owner has returned.
    """

    def __init__(self, grace_period_s: float = 1.0, poll_s: float = 0.01):
        import threading

        self.grace_period_s = float(grace_period_s)
        self.poll_s = float(poll_s)
        self._lock = threading.Lock()
        self._round: Optional[_ConsolidationRound] = None

    def register_and_receive(self, table: Table) -> Table:
        import time

        with self._lock:
            if self._round is None:
                self._round = rnd = _ConsolidationRound(table, time.monotonic())
                chosen = True
            else:
                self._round.parts.append(table)
                self._round.last_arrival = time.monotonic()
                chosen = False
        if not chosen:
            return table.take(np.empty(0, np.int64))
        # chosen: wait until the round has been quiet for the grace period
        # (the reference's gracePeriod sleep, PartitionConsolidator.scala:76),
        # then close it atomically
        while True:
            with self._lock:
                quiet = time.monotonic() - rnd.last_arrival
                if quiet >= self.grace_period_s:
                    parts = rnd.parts
                    self._round = None
                    break
            time.sleep(min(self.poll_s, self.grace_period_s))
        return Table.concat(parts)


@register_stage
class PartitionConsolidator(Transformer):
    """Funnel all concurrently-transforming data through one elected caller
    per process so a rate-limited per-host resource (one HTTP client, one
    metered API) is driven single-file.

    Reference: stages/PartitionConsolidator.scala:22-49 — 1-of-N Spark
    partitions per JVM is elected via a SharedSingleton Consolidator; here
    the callers are concurrent transform invocations sharing the
    process-wide Consolidator keyed by stage uid.
    """

    grace_period_ms = Param("quiet time before the chosen caller closes its "
                            "round; every round (including a lone caller) "
                            "pays this wait once.  Default 250ms trades the "
                            "reference's 1s gracePeriod "
                            "(PartitionConsolidator.scala:76) for per-batch "
                            "latency; raise it when concurrent callers can "
                            "arrive far apart", default=250,
                            converter=TypeConverters.to_int)

    def _transform(self, table: Table) -> Table:
        # key includes the grace so stage.set(grace_period_ms=...) after a
        # first transform is honored (same rule as get_shared_client)
        grace = int(self.grace_period_ms)
        consolidator = shared_singleton(
            ("PartitionConsolidator", self.uid, grace),
            lambda: Consolidator(grace_period_s=grace / 1000.0),
        )
        return consolidator.register_and_receive(table)
