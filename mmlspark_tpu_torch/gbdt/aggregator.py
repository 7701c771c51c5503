"""Per-host dataset aggregation — LightGBM "single dataset mode".

Reference: lightgbm/SharedState.scala:16-106 + dataset/DatasetAggregator.scala
:69-515 — all task threads on an executor append their partitions' rows into
shared chunked native arrays (SWIG ChunkedArray), a CountDownLatch waits for
every helper, and ONE elected worker builds the native Dataset and trains;
the helpers contribute data but no duplicate training.

Host analog (a copy of the JAX package's `gbdt/aggregator.py`): concurrent feeder threads in a host process append row
chunks into a `ChunkedArray` (amortized growth, no per-append realloc); the
first feeder to register is elected; `wait_and_build` latches until every
registered feeder called `done()` and materializes the merged arrays once —
the elected feeder then runs the single per-host `Booster.fit` whose
histograms build on the device.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["ChunkedArray", "DatasetAggregator"]


class ChunkedArray:
    """Growable row store: fixed-size chunks, one concatenating copy at
    materialize (the SWIG ChunkedArray's coalesce, SWIG.scala:13)."""

    def __init__(self, num_cols: int, dtype=np.float64, chunk_rows: int = 4096):
        self.num_cols = int(num_cols)
        self.dtype = np.dtype(dtype)
        self.chunk_rows = int(chunk_rows)
        self._chunks: List[np.ndarray] = []
        self._fill = 0  # rows used in the last chunk
        self.num_rows = 0

    def append(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, self.dtype)
        if rows.ndim == 1:
            rows = rows.reshape(-1, self.num_cols) if self.num_cols > 1 \
                else rows.reshape(-1, 1)
        if rows.shape[1] != self.num_cols:
            raise ValueError(f"expected {self.num_cols} cols, got {rows.shape[1]}")
        i = 0
        n = len(rows)
        while i < n:
            if not self._chunks or self._fill == self.chunk_rows:
                self._chunks.append(
                    np.empty((self.chunk_rows, self.num_cols), self.dtype))
                self._fill = 0
            take = min(self.chunk_rows - self._fill, n - i)
            self._chunks[-1][self._fill:self._fill + take] = rows[i:i + take]
            self._fill += take
            i += take
        self.num_rows += n

    def materialize(self) -> np.ndarray:
        if not self._chunks:
            return np.empty((0, self.num_cols), self.dtype)
        parts = self._chunks[:-1] + [self._chunks[-1][: self._fill]]
        return np.concatenate(parts, axis=0)


class DatasetAggregator:
    """Elected-worker merge of concurrent feeders' rows before device feed.

    Protocol (SharedState.scala's linkSharedState/CountDownLatch shape):

        chosen = agg.register(feeder_id)     # first registrant is elected
        agg.append(feeder_id, x, y[, w])     # any number of chunks
        agg.done(feeder_id)
        if chosen:
            x, y, w = agg.wait_and_build(timeout=...)  # latches on all done
            booster.fit(x, y, ...)           # ONE training per host

    Rows merge in feeder-id order (not arrival order), so the built dataset
    is deterministic regardless of thread interleaving.
    """

    def __init__(self, num_features: int, expected_feeders: Optional[int] = None,
                 chunk_rows: int = 4096, registration_grace_s: float = 0.5):
        self.num_features = int(num_features)
        self.expected_feeders = expected_feeders
        self.chunk_rows = int(chunk_rows)
        # without an expected count, build waits for a registration-quiet
        # window so a straggler that registers after earlier feeders
        # finished still joins (SharedState sizes the latch from
        # ClusterUtil's task count; pass expected_feeders for that exactness)
        self.registration_grace_s = float(registration_grace_s)
        self._lock = threading.Lock()
        self._all_done = threading.Event()
        self._last_registration = 0.0
        self._feeders: Dict[object, Tuple[ChunkedArray, ChunkedArray, ChunkedArray]] = {}
        self._registration_order: List[object] = []
        self._done: set = set()
        self._elected: Optional[object] = None
        self._built: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    def register(self, feeder_id) -> bool:
        """Join as a feeder; True for the elected (first) one."""
        with self._lock:
            if self._built is not None:
                raise RuntimeError("aggregator already built")
            if feeder_id in self._feeders:
                raise ValueError(f"feeder {feeder_id!r} already registered")
            self._feeders[feeder_id] = (
                ChunkedArray(self.num_features, chunk_rows=self.chunk_rows),
                ChunkedArray(1, chunk_rows=self.chunk_rows),
                ChunkedArray(1, chunk_rows=self.chunk_rows),
            )
            self._registration_order.append(feeder_id)
            import time

            self._last_registration = time.monotonic()
            self._all_done.clear()  # a new feeder reopens the latch
            if self._elected is None:
                self._elected = feeder_id
                return True
            return False

    def append(self, feeder_id, x: np.ndarray, y: np.ndarray,
               weight: Optional[np.ndarray] = None) -> None:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        w = (np.ones(len(y)) if weight is None
             else np.asarray(weight, np.float64))
        if not (len(x) == len(y) == len(w)):
            raise ValueError("chunk length mismatch")
        with self._lock:
            if feeder_id in self._done:
                raise RuntimeError(f"feeder {feeder_id!r} already done")
            xs, ys, ws = self._feeders[feeder_id]
        # ChunkedArray appends are per-feeder, so no lock across the copy
        xs.append(x)
        ys.append(y)
        ws.append(w)

    def done(self, feeder_id) -> None:
        """Count down the latch (SharedState helperStartSignal analog)."""
        with self._lock:
            if feeder_id not in self._feeders:
                raise ValueError(f"feeder {feeder_id!r} never registered")
            self._done.add(feeder_id)
            complete = (len(self._done) == len(self._feeders)
                        and (self.expected_feeders is None
                             or len(self._done) >= self.expected_feeders))
            if complete:
                self._all_done.set()

    def wait_and_build(self, timeout: Optional[float] = None):
        """Elected worker: block until every feeder finished, then merge
        once — natural feeder-id sort order (0..11 numerically, not
        lexicographically), falling back to registration order when ids
        don't compare.  Returns (x, y, weight).

        With expected_feeders unset, completion additionally requires a
        registration-quiet window, so 'first feeder finishes before the
        second registers' does not build a partial dataset."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)
            if not self._all_done.wait(remaining):
                with self._lock:
                    missing = set(self._feeders) - self._done
                raise TimeoutError(
                    f"feeders never finished: {sorted(map(repr, missing))}")
            if self.expected_feeders is not None:
                break
            with self._lock:
                quiet = time.monotonic() - self._last_registration
                if self._all_done.is_set() and quiet >= self.registration_grace_s:
                    break
            time.sleep(min(0.01, self.registration_grace_s))
        with self._lock:
            if self._built is None:
                try:
                    order = sorted(self._feeders)  # natural id order
                except TypeError:
                    order = list(self._registration_order)
                xs = [self._feeders[f][0].materialize() for f in order]
                ys = [self._feeders[f][1].materialize()[:, 0] for f in order]
                ws = [self._feeders[f][2].materialize()[:, 0] for f in order]
                self._built = (np.concatenate(xs) if xs else
                               np.empty((0, self.num_features)),
                               np.concatenate(ys) if ys else np.empty(0),
                               np.concatenate(ws) if ws else np.empty(0))
                self._feeders.clear()  # free the chunk store
        return self._built
