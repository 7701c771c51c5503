"""Metric primitives behind one process-wide registry.

A copy of the JAX package's `core/telemetry/metrics.py` for this package,
with the declared-name table cut to the names this package records.

Three instrument kinds, Prometheus-shaped:

* **counters** — monotonic ints (`incr("feed.transfer_retry")`), a plain
  dict under one lock: `incr` sits on fault/retry paths and must stay a
  few hundred ns.
* **gauges** — last-written values (queue depths, overlap fractions).
  `gauge(name).set(v)` / `.inc()`.
* **histograms** — fixed log-spaced buckets, LOCK-STRIPED: each
  observing thread hashes onto one of `_STRIPES` independent
  (lock, counts, sum) shards so hot paths never serialize on a single
  histogram lock; snapshots merge the stripes.

Naming convention: ``layer.component.metric`` (e.g.
``io.feed.transfer.bytes``).  Every static name instrumented in this
package appears in ``DECLARED_METRICS`` below; dynamic per-entity
suffixes (``faults.injected.<point>``) are valid when their PREFIX is
declared.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DECLARED_METRICS", "is_declared", "Gauge", "Histogram",
           "MetricsRegistry", "REGISTRY", "default_buckets",
           "BYTE_BUCKETS", "FILL_BUCKETS", "BUCKET_FAMILIES",
           "HISTOGRAM_FAMILY", "buckets_for"]

# The declared-name table: every static metric/counter name in this package.
DECLARED_METRICS: Dict[str, str] = {
    # -- counters
    "feed.transfer_retry": "counter",
    "feed.degraded": "counter",
    # -- counters: the sharded direct-to-device path (io/shard_put.py)
    "feed.shard_retry": "counter",
    "feed.shard_degraded": "counter",
    "io.feed.shard.puts": "counter",
    "io.feed.shard.fallback": "counter",
    "io.feed.shard.compressed_groups": "counter",  # compressed put_groups
    "faults.injected": "counter",         # + .<fault-point> variants
    "io.pipeline.items": "counter",       # + .<stage> variants
    "flow.items": "counter",              # + .<stage> variants
    "flow.expired": "counter",            # + .<stage> variants
    "flow.shed": "counter",               # + .<stage> variants
    # registered Stage subclasses declare their exact rows
    "flow.shed.admission": "counter",
    "flow.expired.admission": "counter",
    "flow.shed.h2d": "counter",
    "flow.expired.h2d": "counter",
    "serving.shed": "counter",
    "serving.deadline_expired": "counter",
    "batcher.shed": "counter",
    "batcher.deadline_expired": "counter",
    "checkpoint.corrupt": "counter",
    "checkpoint.fallback": "counter",
    "checkpoint.quarantine": "counter",
    "checkpoint.write_failed": "counter",
    "training.autosave": "counter",
    "training.resume": "counter",
    "training.anomaly": "counter",        # + .<kind> variants
    "training.quarantine": "counter",     # + .skip variant (replay skips)
    "training.rollback": "counter",
    "training.abort": "counter",
    "training.hang": "counter",
    "training.straggler": "counter",      # + .<host> variants (merge side)
    "timeseries.samples": "counter",      # one per TimeSeriesStore sweep
    # -- counters: HTTP circuit breakers (io/http/clients.py)
    "circuit.open": "counter",            # + .<breaker-name> variants
    "circuit.closed": "counter",
    "circuit.half_open_probe": "counter",
    # -- counters: fleet gateway event ledger (serving/fleet.py)
    "serving.fleet.retry": "counter",
    "serving.fleet.eject": "counter",
    "serving.fleet.reinstate": "counter",
    "serving.fleet.no_replica": "counter",
    "serving.fleet.deadline_expired": "counter",
    "serving.fleet.rollback": "counter",
    "serving.fleet.promote": "counter",
    # -- counters: federated telemetry plane (core/telemetry/fleet.py)
    "fleet.pull": "counter",              # one per completed federated pull
    "fleet.pull_failed": "counter",       # + .<replica> variants
    "fleet.incident": "counter",          # flight-recorder bundles written
    "slo.alert.pending": "counter",       # + .<slo> variants
    "slo.alert.firing": "counter",        # + .<slo> variants
    "slo.alert.resolved": "counter",      # + .<slo> variants
    "autoscale.up": "counter",
    "autoscale.down": "counter",
    # -- counters: the compile sentry (core/telemetry/device.py)
    "xla.compile.count": "counter",       # kernel builds + new signatures
    "xla.compile.hot_path": "counter",    # + .<fn> variants: steady-state
    # -- counters: elastic multi-host runtime (parallel/distributed.py)
    "dist.rendezvous.attempt": "counter",   # one per join attempt
    "dist.rendezvous.retry": "counter",     # backed-off re-attempts
    "dist.rendezvous.failed": "counter",    # deadline/budget exhausted
    "dist.heartbeat.missed": "counter",     # dropped beats (injected/lost)
    "dist.host.lost": "counter",            # + .<host> variants
    "dist.membership.update": "counter",    # published epoch advances
    "dist.membership.stale": "counter",     # rejected stale epochs
    "dist.barrier.timeout": "counter",
    "dist.collective.overrun": "counter",   # hang-budget deadline fired
    # -- histograms
    "io.feed.transfer.latency": "histogram",
    "io.feed.transfer.bytes": "histogram",
    "io.feed.shard.latency": "histogram",   # one observation per shard put
    "io.feed.shard.bytes": "histogram",
    "io.pipeline.stage.latency": "histogram",   # labeled {stage=...}
    "flow.stage.latency": "histogram",          # labeled {stage=...}
    "serving.request.latency": "histogram",     # labeled {endpoint, outcome}
    "serving.batch.fill": "histogram",
    "serving.batcher.batch_fill": "histogram",  # one observation per tick
    "models.training.step_latency": "histogram",  # seconds per optimizer step
    "checkpoint.verify.latency": "histogram",
    "io.http.request.latency": "histogram",
    "serving.fleet.request.latency": "histogram",   # gateway e2e, labeled
    "serving.fleet.replica.latency": "histogram",   # labeled {replica=...}
    "fleet.scrape.latency": "histogram",    # one full federated pull+merge
    "xla.compile.latency": "histogram",
    "dist.rendezvous.latency": "histogram",  # join time, per host
    # -- gauges
    "io.feed.queue.depth": "gauge",
    "io.feed.degraded_engines": "gauge",
    "io.feed.overlap_frac": "gauge",
    "io.feed.stall_s": "gauge",
    "io.feed.shard.concurrency": "gauge",   # pool in-flight high-water
    "io.feed.shard.wire_ratio": "gauge",    # raw/sent on the RLE wire
    "io.feed.shard.queue.depth": "gauge",   # transfer-pool task backlog
    "io.pipeline.queue.depth": "gauge",   # + .<stage> variants
    "flow.queue.depth": "gauge",          # + .<stage> variants
    "flow.queue.depth.admission": "gauge",
    "flow.queue.depth.h2d": "gauge",
    "serving.queue.depth": "gauge",
    "serving.batcher.queue_depth": "gauge",
    "models.training.examples_per_sec": "gauge",
    "training.guard.lr_scale": "gauge",
    "training.goodput.frac": "gauge",         # productive / wall, whole run
    "training.goodput.window_frac": "gauge",  # same over the last K steps
    "training.goodput.lost_s": "gauge",       # + .<kind> variants
    "training.straggler.ratio": "gauge",      # p_max/p_median at detection
    "serving.fleet.replicas": "gauge",
    "serving.fleet.healthy": "gauge",
    "fleet.pull.replicas": "gauge",       # replicas reached by last pull
    "slo.burn_rate": "gauge",             # + .<slo> variants
    "autoscale.target_replicas": "gauge",
    "device.hbm.bytes_in_use": "gauge",
    "device.hbm.peak_bytes": "gauge",
    "device.live_buffer_count": "gauge",
    "dist.membership.epoch": "gauge",     # current membership epoch
    "dist.membership.hosts": "gauge",     # live hosts in the view
}


def is_declared(name: str) -> bool:
    """Exact member of the table, or a dynamic per-entity child of one
    (``faults.injected.feed.device_put`` under ``faults.injected``)."""
    if name in DECLARED_METRICS:
        return True
    return any(name.startswith(d + ".") for d in DECLARED_METRICS)


# half-decade log spacing, 1 µs .. 1000 s: one default ladder covers
# everything timed in seconds
def default_buckets() -> Tuple[float, ...]:
    return tuple(10.0 ** (-6 + i / 2.0) for i in range(19))


# power-of-4 spacing, 64 B .. 1 GiB: the transfer-size ladder
BYTE_BUCKETS: Tuple[float, ...] = tuple(float(64 * 4 ** i) for i in range(13))

# linear 0.05 .. 1.0: the fill-fraction ladder (batch occupancy is a
# ratio, not a latency — a log ladder wastes 15 of 19 edges above 1.0)
FILL_BUCKETS: Tuple[float, ...] = tuple(i / 20.0 for i in range(1, 21))

# ---------------------------------------------------------------------------
# Named bucket families.  Every DECLARED histogram resolves to one of
# these ladders, so histograms of one name share identical `le` edges
# and merge bucket-by-bucket.
# ---------------------------------------------------------------------------
BUCKET_FAMILIES: Dict[str, Tuple[float, ...]] = {
    "latency": tuple(10.0 ** (-6 + i / 2.0) for i in range(19)),
    "bytes": BYTE_BUCKETS,
    "fill": FILL_BUCKETS,
}

# declared histogram name -> family key in BUCKET_FAMILIES
HISTOGRAM_FAMILY: Dict[str, str] = {
    "io.feed.transfer.latency": "latency",
    "io.feed.transfer.bytes": "bytes",
    "io.feed.shard.latency": "latency",
    "io.feed.shard.bytes": "bytes",
    "io.pipeline.stage.latency": "latency",
    "flow.stage.latency": "latency",
    "serving.request.latency": "latency",
    "serving.batch.fill": "fill",
    "serving.batcher.batch_fill": "fill",
    "models.training.step_latency": "latency",
    "checkpoint.verify.latency": "latency",
    "io.http.request.latency": "latency",
    "serving.fleet.request.latency": "latency",
    "serving.fleet.replica.latency": "latency",
    "fleet.scrape.latency": "latency",
    "xla.compile.latency": "latency",
    "dist.rendezvous.latency": "latency",
}


def buckets_for(name: str) -> Optional[Tuple[float, ...]]:
    """The family ladder for a declared histogram name (exact or
    per-entity child), or None when the name carries no family."""
    fam = HISTOGRAM_FAMILY.get(name)
    if fam is None:
        for decl, f in HISTOGRAM_FAMILY.items():
            if name.startswith(decl + "."):
                fam = f
                break
    return BUCKET_FAMILIES[fam] if fam is not None else None


_STRIPES = 8


class Gauge:
    """Last-written value; `inc`/`dec` for up-down counts."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0  #: guarded-by self._lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _Stripe:
    __slots__ = ("lock", "counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.lock = threading.Lock()
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0


class Histogram:
    """Fixed-boundary histogram, lock-striped across observer threads.

    `boundaries` are the bucket UPPER edges (ascending); observations
    above the last edge land in the implicit +Inf bucket.  An
    observation exactly ON an edge counts into that edge's bucket
    (Prometheus `le` semantics — bucket i holds v <= boundaries[i]).
    """

    def __init__(self, name: str,
                 boundaries: Optional[Sequence[float]] = None):
        self.name = name
        bs = tuple(boundaries) if boundaries is not None else default_buckets()
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram boundaries must be strictly "
                             f"ascending, got {bs}")
        self.boundaries: Tuple[float, ...] = bs
        self._stripes = [_Stripe(len(bs) + 1) for _ in range(_STRIPES)]

    def observe(self, value: float) -> None:
        # le semantics: first boundary >= value (bisect_left: an exact
        # edge hit stays in that edge's bucket)
        i = bisect.bisect_left(self.boundaries, value)
        s = self._stripes[threading.get_ident() % _STRIPES]
        with s.lock:
            s.counts[i] += 1
            s.sum += value
            s.count += 1

    # ---- read side -----------------------------------------------------
    def _merged(self) -> Tuple[List[int], float, int]:
        counts = [0] * (len(self.boundaries) + 1)
        total_sum, total_n = 0.0, 0
        for s in self._stripes:
            with s.lock:
                for i, c in enumerate(s.counts):
                    counts[i] += c
                total_sum += s.sum
                total_n += s.count
        return counts, total_sum, total_n

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile (q in [0, 1]); None when empty.
        Values in the +Inf bucket report the last finite edge — a
        histogram quantile can never resolve beyond its ladder."""
        counts, _s, n = self._merged()
        if n == 0:
            return None
        target = q * n
        cum = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target and c > 0:
                if i >= len(self.boundaries):
                    return self.boundaries[-1]
                lo = self.boundaries[i - 1] if i > 0 else 0.0
                hi = self.boundaries[i]
                frac = (target - (cum - c)) / c
                return lo + (hi - lo) * frac
        return self.boundaries[-1]

    def snapshot(self) -> Dict[str, object]:
        counts, total_sum, n = self._merged()
        cum, buckets = 0, []
        for i, le in enumerate(self.boundaries):
            cum += counts[i]
            buckets.append((le, cum))
        buckets.append((float("inf"), n))
        return {
            "count": n,
            "sum": total_sum,
            "buckets": buckets,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """One process-wide home for every instrument.

    Counters are a plain dict (incr / counter_values / reset_counters);
    gauges and histograms are create-on-first-touch keyed by
    (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}  #: guarded-by self._lock
        self._gauges: Dict[str, Gauge] = {}  #: guarded-by self._lock
        #: guarded-by self._lock
        self._hists: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                          Histogram] = {}
        # the bucket ladder is fixed per NAME: every labeled child of
        # one histogram family must be mergeable/comparable
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}  #: guarded-by self._lock

    # ---- counters ------------------------------------------------------
    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter_values(self, prefix: Optional[str] = None) -> Dict[str, int]:
        with self._lock:
            if prefix is None:
                return dict(self._counters)
            return {k: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def reset_counters(self, prefix: Optional[str] = None) -> None:
        with self._lock:
            if prefix is None:
                self._counters.clear()
            else:
                for k in [k for k in self._counters if k.startswith(prefix)]:
                    del self._counters[k]

    # ---- gauges --------------------------------------------------------
    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def gauge_values(self) -> Dict[str, float]:
        with self._lock:
            gauges = list(self._gauges.values())
        return {g.name: g.value for g in gauges}

    # ---- histograms ----------------------------------------------------
    def histogram(self, name: str,
                  boundaries: Optional[Sequence[float]] = None,
                  **labels: str) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                bs = self._hist_buckets.get(name)
                if bs is None:
                    fam = buckets_for(name)
                    if fam is not None:
                        # declared family names are pinned to their
                        # ladder: an explicit disagreeing `boundaries`
                        # would make merges inexact
                        if (boundaries is not None
                                and tuple(boundaries) != fam):
                            raise ValueError(
                                f"histogram {name!r} is declared with a "
                                f"bucket family; explicit boundaries "
                                f"must match it")
                        bs = fam
                    else:
                        bs = (tuple(boundaries) if boundaries is not None
                              else default_buckets())
                    self._hist_buckets[name] = bs
                h = self._hists[key] = Histogram(name, bs)
            return h

    def histograms(self) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                 Histogram]:
        with self._lock:
            return dict(self._hists)

    def reset_all(self) -> None:
        """Tests only: counters, gauges, and histograms back to empty."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._hist_buckets.clear()


REGISTRY = MetricsRegistry()
