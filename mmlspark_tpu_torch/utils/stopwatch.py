"""Nanosecond stopwatch (reference: core/utils/StopWatch.scala:6 — the
ns-resolution timer behind VW's TrainingStats phase diagnostics).

A copy of the JAX package's `utils/stopwatch.py` for this package.  It
keeps both of that module's surfaces: `with sw:` / `sw.measure(fn)`,
plus `with sw.measure():` and `elapsed_sec`.
"""
from __future__ import annotations

import contextlib
import time

__all__ = ["StopWatch"]


class StopWatch:
    def __init__(self):
        self._start = None
        self.elapsed_ns = 0

    def start(self) -> "StopWatch":
        self._start = time.perf_counter_ns()
        return self

    def stop(self) -> int:
        if self._start is not None:
            self.elapsed_ns += time.perf_counter_ns() - self._start
            self._start = None
        return self.elapsed_ns

    def restart(self) -> "StopWatch":
        self.elapsed_ns = 0
        return self.start()

    @property
    def elapsed_s(self) -> float:
        running = (
            time.perf_counter_ns() - self._start
            if self._start is not None else 0
        )
        return (self.elapsed_ns + running) / 1e9

    # the old core.telemetry.StopWatch spelling
    elapsed_sec = elapsed_s

    def __enter__(self) -> "StopWatch":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def measure(self, fn=None, *args, **kwargs):
        """Two historical shapes behind one name:

        * ``measure(fn, *args)`` times one call, returns
          ``(result, elapsed_ns of the call)``;
        * ``measure()`` (no fn) returns a context manager that
          accumulates the block's wall time (the old
          core.telemetry.StopWatch.measure).
        """
        if fn is None:
            return self._measure_block()
        t0 = time.perf_counter_ns()
        out = fn(*args, **kwargs)
        dt = time.perf_counter_ns() - t0
        self.elapsed_ns += dt
        return out, dt

    @contextlib.contextmanager
    def _measure_block(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()
