"""In-process time-series engine: bounded recent history for metrics.

The registry (metrics.py) answers "what is the value *now*"; this module
answers "what happened *lately*" without any external TSDB — the
Monarch-style pattern of keeping a fixed-capacity ring of recent samples
in-process and querying it cheaply.  A `TimeSeriesStore` samples the
declared series in `SAMPLED_SERIES` on a configurable cadence (one
`tick()` per training step is the intended driver; the cadence gate
makes extra ticks free) and supports PromQL-shaped queries over any
window: `rate()`, `delta()` (both counter-reset aware),
`quantile_over_time()`, and cadence-aligned window extraction.

Design points, mirroring the rest of the telemetry plane:

- **Declared series table.**  `SAMPLED_SERIES` is a plain dict literal
  (name -> "counter" | "gauge" | "histogram"), AST-parseable the same
  way graftlint parses `DECLARED_METRICS`; the M004 lint checks every
  key here resolves to a declared metric so the sampler never chases a
  renamed series.  Histogram-kind entries are sampled as two derived
  counter series, `<name>.count` and `<name>.sum` (cumulative, so rate
  over them gives throughput and mean latency over any window).
- **Lock striping.**  Series rings are striped across `_N_STRIPES`
  locks hashed by series name, so a sampler tick and a concurrent
  reader of a different series never contend.
- **Injectable clock.**  Defaults to `utils.faults.monotonic`, so soaks
  driving a `VirtualClock` get virtual-time series for free and tests
  can step time deterministically.
- **Exact cross-host merge** lives in `fleet.merge_timeseries_exports`
  with the same strictness as histogram merges: mismatched kind or
  sampling cadence across hosts raises instead of merging inexactly.

Timestamps are the process's monotonic clock — per-host, not
wall-synchronized.  Cross-host bucket alignment in the merge is exact
on the cadence grid but only *comparable* across hosts to within clock
skew; the merge keeps per-host series verbatim for that reason.
"""
from __future__ import annotations

import math
import threading
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from ...utils.faults import monotonic as _monotonic
from .metrics import REGISTRY, MetricsRegistry

__all__ = ["SAMPLED_SERIES", "TimeSeriesStore", "STORE",
           "merge_timeseries_exports"]


# ---------------------------------------------------------------------------
# The declared-series table.  Every key must resolve in DECLARED_METRICS
# (exact name or a child of a declared family) with a matching kind —
# graftlint rule M004 enforces this statically, the same way M001 pins
# incr()/gauge() call sites to the registry.  Keep this a PLAIN LITERAL:
# the lint AST-parses it without importing the module.
SAMPLED_SERIES: Dict[str, str] = {
    # counters: windows over these answer "how often lately", which the
    # instantaneous registry value cannot
    "training.autosave": "counter",
    "training.rollback": "counter",
    "training.resume": "counter",
    "training.straggler": "counter",
    "checkpoint.write_failed": "counter",
    "dist.host.lost": "counter",
    "xla.compile.count": "counter",
    # gauges: recent level / trend
    "models.training.examples_per_sec": "gauge",
    "training.goodput.frac": "gauge",
    "training.goodput.window_frac": "gauge",
    # histograms: sampled as cumulative <name>.count / <name>.sum
    # counter pairs (rate -> throughput, sum-rate/count-rate -> mean)
    "models.training.step_latency": "histogram",
}

_N_STRIPES = 8


class _Series:
    """One fixed-capacity ring of (t, value) samples.

    Not self-locking — the owning store's stripe lock guards every
    access (`#: guarded-by stripe lock` discipline, same as Histogram's
    stripes carrying their own lock in metrics.py)."""

    __slots__ = ("kind", "ts", "vs", "head", "size", "evicted")

    def __init__(self, kind: str, capacity: int):
        self.kind = kind
        self.ts: List[float] = [0.0] * capacity
        self.vs: List[float] = [0.0] * capacity
        self.head = 0       # next write slot
        self.size = 0
        self.evicted = 0    # samples dropped since creation

    def append(self, t: float, v: float) -> None:
        cap = len(self.ts)
        if self.size == cap:
            self.evicted += 1
        else:
            self.size += 1
        self.ts[self.head] = t
        self.vs[self.head] = v
        self.head = (self.head + 1) % cap

    def points(self) -> List[Tuple[float, float]]:
        """Chronological (t, v) pairs."""
        cap = len(self.ts)
        start = (self.head - self.size) % cap
        out = []
        for i in range(self.size):
            j = (start + i) % cap
            out.append((self.ts[j], self.vs[j]))
        return out


class TimeSeriesStore:
    """Lock-striped ring-buffer store for recent metric history.

    `tick()` is cheap to call once per step: it no-ops until `cadence_s`
    has elapsed since the last sample, then snapshots every series in
    the declared table from the registry.  `record()` appends an
    explicit point outside the sampled table (series created on first
    touch, kind "gauge" unless given).
    """

    def __init__(self, capacity: int = 512, cadence_s: float = 1.0,
                 clock: Optional[Callable[[], float]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 series: Optional[Mapping[str, str]] = None):
        if capacity < 2:
            raise ValueError("timeseries capacity must be >= 2")
        if cadence_s <= 0:
            raise ValueError("timeseries cadence_s must be > 0")
        self.capacity = capacity
        self.cadence_s = float(cadence_s)
        self._clock = clock if clock is not None else _monotonic
        self._registry = registry if registry is not None else REGISTRY
        self._table = dict(SAMPLED_SERIES if series is None else series)
        self._stripes = [threading.Lock() for _ in range(_N_STRIPES)]
        #: guarded-by the stripe lock for hash(name)
        self._series: List[Dict[str, _Series]] = [
            {} for _ in range(_N_STRIPES)]
        self._tick_lock = threading.Lock()
        self._last_tick: Optional[float] = None  #: guarded-by self._tick_lock

    # ---- write side ----------------------------------------------------
    def _stripe(self, name: str) -> int:
        # hash() is salted per-process for str; series placement only
        # needs to be stable within one process, which it is
        return hash(name) % _N_STRIPES

    def record(self, name: str, value: float, t: Optional[float] = None,
               kind: str = "gauge") -> None:
        """Append one explicit sample (outside the cadence sampler)."""
        t = self._clock() if t is None else float(t)
        i = self._stripe(name)
        with self._stripes[i]:
            s = self._series[i].get(name)
            if s is None:
                s = self._series[i][name] = _Series(kind, self.capacity)
            s.append(t, float(value))

    def tick(self, now: Optional[float] = None) -> bool:
        """Cadence-gated sample of every declared series; returns True
        when a sample was actually taken."""
        now = self._clock() if now is None else float(now)
        with self._tick_lock:
            if (self._last_tick is not None
                    and now - self._last_tick < self.cadence_s):
                return False
            self._last_tick = now
        self.sample(now)
        return True

    def sample(self, now: Optional[float] = None) -> None:
        """Unconditionally snapshot the declared table from the
        registry (counters cumulative, gauges instantaneous, histograms
        as derived .count/.sum cumulative pairs)."""
        now = self._clock() if now is None else float(now)
        counters = gauges = hists = None
        for name, kind in self._table.items():
            if kind == "counter":
                if counters is None:
                    counters = self._registry.counter_values()
                self.record(name, float(counters.get(name, 0)), t=now,
                            kind="counter")
            elif kind == "gauge":
                if gauges is None:
                    gauges = self._registry.gauge_values()
                if name in gauges:
                    self.record(name, gauges[name], t=now, kind="gauge")
            elif kind == "histogram":
                if hists is None:
                    hists = self._registry.histograms()
                n, total = 0, 0.0
                for (hname, _labels), h in hists.items():
                    if hname == name:
                        snap = h.snapshot()
                        n += int(snap["count"])
                        total += float(snap["sum"])
                self.record(name + ".count", float(n), t=now, kind="counter")
                self.record(name + ".sum", total, t=now, kind="counter")
            else:
                raise ValueError(
                    f"sampled series {name!r}: unknown kind {kind!r}")
        self._registry.incr("timeseries.samples")

    # ---- read side -----------------------------------------------------
    def points(self, name: str, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Chronological samples for one series, optionally restricted
        to the last `window_s` seconds."""
        i = self._stripe(name)
        with self._stripes[i]:
            s = self._series[i].get(name)
            pts = s.points() if s is not None else []
        if window_s is not None:
            now = self._clock() if now is None else float(now)
            lo = now - float(window_s)
            pts = [p for p in pts if p[0] >= lo]
        return pts

    def kind(self, name: str) -> Optional[str]:
        i = self._stripe(name)
        with self._stripes[i]:
            s = self._series[i].get(name)
            return s.kind if s is not None else None

    @staticmethod
    def _increase(pts: Sequence[Tuple[float, float]]) -> Optional[float]:
        """Counter increase over the points, reset-aware: a value drop
        means the counter restarted from zero, so the post-reset value
        is itself an increase (PromQL `increase` semantics, without
        range extrapolation)."""
        if len(pts) < 2:
            return None
        inc = 0.0
        for (_, prev), (_, cur) in zip(pts, pts[1:]):
            inc += (cur - prev) if cur >= prev else cur
        return inc

    def delta(self, name: str, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
        """Total increase of a counter series (reset-aware) or net
        change of a gauge series over the window; None when fewer than
        two samples cover it."""
        pts = self.points(name, window_s=window_s, now=now)
        if len(pts) < 2:
            return None
        if self.kind(name) == "counter":
            return self._increase(pts)
        return pts[-1][1] - pts[0][1]

    def rate(self, name: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second rate of increase over the window (counter-reset
        aware); None when fewer than two samples cover it."""
        pts = self.points(name, window_s=window_s, now=now)
        if len(pts) < 2:
            return None
        span = pts[-1][0] - pts[0][0]
        if span <= 0:
            return None
        inc = self._increase(pts)
        return None if inc is None else inc / span

    def quantile_over_time(self, name: str, q: float, window_s: float,
                           now: Optional[float] = None) -> Optional[float]:
        """Linear-interpolated quantile of the raw sample VALUES in the
        window (numpy's default "linear" method) — meaningful for gauge
        series; for counters you almost always want rate() first."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        pts = self.points(name, window_s=window_s, now=now)
        if not pts:
            return None
        vs = sorted(v for _, v in pts)
        pos = q * (len(vs) - 1)
        lo = int(math.floor(pos))
        hi = int(math.ceil(pos))
        if lo == hi:
            return vs[lo]
        return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)

    def aligned_window(self, name: str, window_s: float,
                       align_s: Optional[float] = None,
                       now: Optional[float] = None) -> Dict[str, object]:
        """The last `window_s` seconds with both edges snapped DOWN to
        the `align_s` grid (default: the sampling cadence), so repeated
        queries and cross-host comparisons see stable bucket edges
        rather than sliding ones."""
        now = self._clock() if now is None else float(now)
        align = self.cadence_s if align_s is None else float(align_s)
        if align <= 0:
            raise ValueError("align_s must be > 0")
        t_end = math.floor(now / align) * align
        t_start = t_end - float(window_s)
        pts = [p for p in self.points(name) if t_start < p[0] <= t_end]
        return {"t_start": t_start, "t_end": t_end, "align_s": align,
                "points": pts}

    # ---- export / lifecycle --------------------------------------------
    def export(self) -> Dict[str, object]:
        """The wire block served under `/metrics.json` `"timeseries"`:
        cadence, capacity, and every series' chronological points."""
        series: Dict[str, Dict[str, object]] = {}
        for i, lock in enumerate(self._stripes):
            with lock:
                for name, s in self._series[i].items():
                    series[name] = {
                        "kind": s.kind,
                        "evicted": s.evicted,
                        "points": [[round(t, 6), v] for t, v in s.points()],
                    }
        return {"cadence_s": self.cadence_s, "capacity": self.capacity,
                "series": series}

    def reset(self) -> None:
        """Drop every ring and re-arm the cadence gate (tests/soaks)."""
        for i, lock in enumerate(self._stripes):
            with lock:
                self._series[i].clear()
        with self._tick_lock:
            self._last_tick = None


#: The process-wide store `fit_epochs_resumable` ticks once per step and
#: `export_snapshot` serializes; tests construct private stores instead.
STORE = TimeSeriesStore()


# copied from the JAX package's core/telemetry/fleet.py, beside the
# export it merges
def merge_timeseries_exports(sources: Mapping[str, Mapping[str, Any]]
                             ) -> Dict[str, Any]:
    """Exact merge of per-host `TimeSeriesStore.export()` blocks, with
    the same strictness as histogram merges: a series whose kind or
    sampling cadence differs across hosts raises instead of merging
    inexactly (the timeseries twin of bucket-edge drift).

    Counter series are summed on the cadence-aligned bucket grid, and
    only on buckets where EVERY host contributed a sample — a partial
    bucket would under-count, which is exactly the silent-wrongness the
    histogram plane refuses.  Gauge series are never summed (same rule
    as `merge_snapshots`); per-host points are kept verbatim under
    ``by_host`` for both kinds.  Timestamps are each host's monotonic
    clock, so the merged grid is exact per host and comparable across
    hosts only to within clock skew.
    """
    series: Dict[str, Dict[str, Any]] = {}
    cadence: Optional[float] = None
    for host in sorted(sources):
        exp = sources[host] or {}
        host_cad = exp.get("cadence_s")
        for name, s in sorted((exp.get("series") or {}).items()):
            ent = series.setdefault(name, {"kind": s.get("kind"),
                                           "cadence_s": host_cad,
                                           "by_host": {}})
            if s.get("kind") != ent["kind"]:
                raise ValueError(
                    f"timeseries {name!r}: kind differs across hosts "
                    f"({ent['kind']!r} vs {s.get('kind')!r}) — merge "
                    f"would be inexact")
            if host_cad != ent["cadence_s"]:
                raise ValueError(
                    f"timeseries {name!r}: sampling cadence differs "
                    f"across hosts ({ent['cadence_s']!r} vs "
                    f"{host_cad!r}) — merge would be inexact")
            ent["by_host"][host] = [
                (float(t), float(v)) for t, v in (s.get("points") or [])]
        if host_cad is not None:
            cadence = host_cad
    for name, ent in series.items():
        if ent["kind"] != "counter":
            ent["merged"] = None
            continue
        cad = float(ent["cadence_s"] or 1.0)
        hosts = set(ent["by_host"])
        buckets: Dict[int, Dict[str, float]] = {}
        for host, pts in ent["by_host"].items():
            for t, v in pts:
                # last sample in a bucket wins (cumulative counters:
                # the latest value subsumes earlier ones)
                buckets.setdefault(int(math.floor(t / cad)), {})[host] = v
        ent["merged"] = [
            [b * cad, sum(by.values())]
            for b, by in sorted(buckets.items()) if set(by) == hosts]
    return {"hosts": sorted(sources), "cadence_s": cadence,
            "series": series}
