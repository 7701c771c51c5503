"""MiniBatch stages: row streams <-> batch rows.

Reference: core stages/MiniBatchTransformer.scala:15-229 —
`FixedMiniBatchTransformer` (:47, optional double buffering),
`DynamicMiniBatchTransformer` (:71), `TimeIntervalMiniBatchTransformer` (:145),
`FlattenBatch` (:181), `HasMiniBatcher` mixin (:102).

A "batch row" holds, per column, the stacked values of `batch_size` input rows:
dense numeric columns stack to `[B, ...]` numpy arrays (directly
device-feedable); object columns become lists.  This is the host half of the
device feed path: MiniBatch -> host-to-device copy -> forward ->
FlattenBatch.  A copy of the JAX package's `stages/batching.py` for this
package.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.batching import FixedBufferedBatcher, time_interval_batcher
from ..core.params import Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = [
    "FixedMiniBatchTransformer",
    "DynamicMiniBatchTransformer",
    "TimeIntervalMiniBatchTransformer",
    "FlattenBatch",
    "HasMiniBatcher",
]


def _stack_batch(table: Table, start: int, stop: int) -> dict:
    row = {}
    for name in table.column_names:
        col = table.columns[name]
        chunk = col[start:stop]
        if chunk.dtype == object:
            row[name] = list(chunk)
        else:
            row[name] = np.asarray(chunk)
    return row


def _batches_to_table(batch_rows: List[dict], names: List[str]) -> Table:
    cols = {}
    for n in names:
        arr = np.empty(len(batch_rows), dtype=object)
        for i, r in enumerate(batch_rows):
            arr[i] = r[n]
        cols[n] = arr
    return Table(cols)


class _MiniBatchBase(Transformer):
    def _batch_bounds(self, table: Table):
        raise NotImplementedError

    def _transform(self, table: Table) -> Table:
        names = table.column_names
        rows = [
            _stack_batch(table, a, b) for a, b in self._batch_bounds(table)
        ]
        return _batches_to_table(rows, names)


@register_stage
class FixedMiniBatchTransformer(_MiniBatchBase):
    """Fixed-size minibatches; `buffered` prefetches batches on a background
    thread (double buffering the host side of the device feed).
    Reference: MiniBatchTransformer.scala:47.
    """

    batch_size = Param("rows per batch", default=32, converter=TypeConverters.to_int)
    # `buffered` is API parity with the reference; on a materialized Table the
    # output is eager either way, so prefetch would add no overlap here.  The
    # streaming double-buffer lives in core.batching.FixedBufferedBatcher and
    # the TorchModel device feed.
    buffered = Param("kept for API parity (Tables are materialized)", default=False,
                     converter=TypeConverters.to_bool)
    max_buffer_size = Param("max buffered batches", default=2,
                            converter=TypeConverters.to_int)

    def _transform(self, table: Table) -> Table:
        names = table.column_names
        bounds = [
            (s, min(s + self.batch_size, table.num_rows))
            for s in range(0, table.num_rows, self.batch_size)
        ]
        rows = [_stack_batch(table, a, b) for a, b in bounds]
        return _batches_to_table(rows, names)


@register_stage
class DynamicMiniBatchTransformer(_MiniBatchBase):
    """Drain-queue batching: batch size adapts to consumer speed.  On a
    materialized table this degenerates to one batch (all available rows are
    drained at once) — matching the reference's semantics on a static
    partition.  Reference: MiniBatchTransformer.scala:71.
    """

    max_batch_size = Param("cap on dynamic batch size", default=2**30,
                           converter=TypeConverters.to_int)

    def _batch_bounds(self, table: Table):
        n = table.num_rows
        cap = self.max_batch_size
        return [(s, min(s + cap, n)) for s in range(0, n, cap)]


@register_stage
class TimeIntervalMiniBatchTransformer(_MiniBatchBase):
    """Flush a batch every `interval_ms` while rows stream in.
    Reference: MiniBatchTransformer.scala:145.
    """

    interval_ms = Param("flush interval in ms", default=1000,
                        converter=TypeConverters.to_int)
    max_batch_size = Param("cap on batch size", default=2**30,
                           converter=TypeConverters.to_int)

    def _transform(self, table: Table) -> Table:
        names = table.column_names
        idx_batches = time_interval_batcher(
            range(table.num_rows), self.interval_ms, self.max_batch_size
        )
        rows = []
        for idxs in idx_batches:
            sub = table.take(np.asarray(idxs))
            rows.append(_stack_batch(sub, 0, sub.num_rows))
        return _batches_to_table(rows, names)


@register_stage
class FlattenBatch(Transformer):
    """Inverse of minibatching: explode each batch row back into scalar rows.
    Reference: MiniBatchTransformer.scala:181.
    """

    def _transform(self, table: Table) -> Table:
        names = table.column_names
        out_cols: dict = {n: [] for n in names}
        for i in range(table.num_rows):
            lengths = set()
            vals = {}
            for n in names:
                v = table.columns[n][i]
                vals[n] = v
                if isinstance(v, (list, np.ndarray)):
                    lengths.add(len(v))
            if len(lengths) > 1:
                raise ValueError(
                    f"FlattenBatch: batch row {i} has mismatched column lengths "
                    f"{sorted(lengths)}; refusing to silently misalign rows"
                )
            size = lengths.pop() if lengths else 1
            for n in names:
                v = vals[n]
                if isinstance(v, (list, np.ndarray)) and len(v) == size:
                    out_cols[n].extend(list(v))
                else:
                    out_cols[n].extend([v] * size)
        cols = {}
        for n in names:
            vals = out_cols[n]
            if vals and isinstance(vals[0], np.ndarray) and all(
                isinstance(v, np.ndarray) and v.shape == vals[0].shape and v.dtype == vals[0].dtype
                for v in vals
            ) and vals[0].dtype != object:
                cols[n] = np.stack(vals)
            else:
                cols[n] = vals
        return Table(cols)


class HasMiniBatcher:
    """Mixin param: stages that internally minibatch (e.g. TorchModel).
    Reference: MiniBatchTransformer.scala:102."""

    mini_batcher = Param("minibatching strategy stage", default=None)

    def get_mini_batcher(self) -> Transformer:
        return self.mini_batcher or FixedMiniBatchTransformer()
