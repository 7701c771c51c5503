"""The fleet telemetry plane: federation, stitching, SLOs, incidents.

Every process is observable on its own, and many processes serve one
workload.  This module is the pure (no-HTTP) core that turns the
per-process islands into one operable fleet:

* **federation** — :func:`merge_snapshots` folds many replicas'
  ``export_snapshot()`` dicts into one fleet view: counters summed,
  gauges kept per-replica, histograms merged bucket-by-bucket.  The
  merge is EXACT — ``_count``/``_sum`` of the merged series equal the
  sums of the parts — because every declared histogram is pinned to a
  named bucket family (metrics.BUCKET_FAMILIES, graftlint M003), so
  every replica shares identical ``le`` edges; a drifted ladder raises
  instead of producing a silently-wrong merged p99.
* **stitching** — :func:`stitch_spans` assembles one client trace id's
  spans collected from many processes (gateway + replicas) into a single
  parent→child tree; the ``serving.fleet.request`` parentage recorded by
  the gateway links the hops.
* **SLOs** — :class:`SLOEngine` evaluates declarative objectives over
  the merged view with multi-window burn-rate alerting (condition must
  hold on BOTH a fast and a slow window) and a
  pending→firing→resolved state machine.  Clock-injectable
  (`utils.faults.monotonic`) so transitions are testable under a
  VirtualClock.
* **incidents** — :class:`FlightRecorder` atomically dumps a post-mortem
  bundle (merged snapshot, stitched traces, recent records, replica
  health, alert states) to ``incidents/<ts>-<reason>/`` when an alert
  starts firing.

The HTTP half (the puller that actually fetches replica snapshots and
the ``/fleet/*`` endpoints) lives in `serving/fleet.py`; this module
never opens a socket.

A copy of the JAX package's `core/telemetry/fleet.py` for this package;
its goodput and time-series merges live beside the exports they merge
(`goodput.merge_goodput_exports`, `timeseries.merge_timeseries_exports`).
"""
from __future__ import annotations

import collections
import json
import math
import os
import re
import time
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

from ...utils.faults import monotonic as _monotonic
from ...utils.sync import make_lock
from .goodput import merge_goodput_exports
from .metrics import REGISTRY
from .exposition import sanitize_name
from .timeseries import merge_timeseries_exports

__all__ = [
    "parse_hist_key", "merge_histogram_snapshots", "merge_snapshots",
    "merge_timeseries_exports", "merge_goodput_exports",
    "federate_host_snapshots",
    "hist_total", "cum_le", "render_fleet_prometheus", "stitch_spans",
    "SLO", "SLOEngine", "default_slos", "FlightRecorder",
]


# ---------------------------------------------------------------------------
# histogram federation
# ---------------------------------------------------------------------------

_HIST_KEY = re.compile(r'^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$')
_LABEL = re.compile(r'(?P<k>[^=,]+)="(?P<v>[^"]*)"')


def parse_hist_key(key: str) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    """Inverse of exposition's snapshot key: ``name{k="v",...}`` →
    (name, sorted label pairs)."""
    m = _HIST_KEY.match(key)
    if m is None:
        return key, ()
    name = m.group("name")
    body = m.group("labels")
    if not body:
        return name, ()
    labels = tuple(sorted((lm.group("k"), lm.group("v"))
                          for lm in _LABEL.finditer(body)))
    return name, labels


def _norm_buckets(buckets: Iterable[Sequence[Any]]
                  ) -> List[Tuple[float, int]]:
    """Snapshot buckets to (le, cum) with "+Inf" (the JSON spelling)
    coerced back to float inf."""
    out: List[Tuple[float, int]] = []
    for le, cum in buckets:
        out.append((math.inf if le == "+Inf" else float(le), int(cum)))
    return out


def _percentile_from_cum(buckets: List[Tuple[float, int]], n: int,
                         q: float) -> Optional[float]:
    """Bucket-interpolated quantile over CUMULATIVE (le, cum) pairs —
    the merged-series twin of Histogram.percentile (same clamping: the
    +Inf bucket reports the last finite edge)."""
    if n <= 0:
        return None
    edges = [le for le, _ in buckets if le != math.inf]
    cums = [c for _, c in buckets]
    counts: List[int] = []
    prev = 0
    for c in cums:
        counts.append(c - prev)
        prev = c
    target = q * n
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c > 0:
            if i >= len(edges):
                return edges[-1] if edges else None
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[i]
            frac = (target - (cum - c)) / c
            return lo + (hi - lo) * frac
    return edges[-1] if edges else None


def merge_histogram_snapshots(snaps: Sequence[Mapping[str, Any]],
                              key: str = "?") -> Dict[str, Any]:
    """Exact merge of same-ladder histogram snapshots: counts, sums, and
    cumulative buckets add element-wise; percentiles are recomputed from
    the merged cumulative counts.  Mismatched ``le`` edges raise — the
    condition graftlint M003 exists to make impossible."""
    if not snaps:
        return {"count": 0, "sum": 0.0, "buckets": [],
                "p50": None, "p95": None, "p99": None}
    base = _norm_buckets(snaps[0]["buckets"])
    edges = tuple(le for le, _ in base)
    merged = [0] * len(base)
    total_n, total_sum = 0, 0.0
    for snap in snaps:
        bs = _norm_buckets(snap["buckets"])
        if tuple(le for le, _ in bs) != edges:
            raise ValueError(
                f"histogram {key!r}: bucket edges differ across replicas "
                f"— merge would be inexact (declare a bucket family)")
        for i, (_le, cum) in enumerate(bs):
            merged[i] += cum
        total_n += int(snap["count"])
        total_sum += float(snap["sum"])
    buckets = [(le, merged[i]) for i, (le, _c) in enumerate(base)]
    return {
        "count": total_n,
        "sum": total_sum,
        "buckets": buckets,
        "p50": _percentile_from_cum(buckets, total_n, 0.50),
        "p95": _percentile_from_cum(buckets, total_n, 0.95),
        "p99": _percentile_from_cum(buckets, total_n, 0.99),
    }


def merge_snapshots(sources: Mapping[str, Mapping[str, Any]],
                    versions: Optional[Mapping[str, str]] = None
                    ) -> Dict[str, Any]:
    """Fold per-process ``export_snapshot()`` dicts (keyed by replica,
    e.g. ``host:port`` or ``gateway``) into one fleet view:

    * ``counters`` — summed across sources (the fleet event ledger),
      with the per-source split under ``counters_by_replica``;
    * ``gauges`` — per-source only (``{name: {replica: value}}``):
      summing queue depths is meaningful, summing HBM peaks is not, so
      the fleet view keeps the split and lets consumers fold;
    * ``histograms`` — exact bucket-wise merge per ``name{labels}`` key,
      with the per-source snapshots under ``histograms_by_replica``.
    """
    versions = dict(versions or {})
    counters: Dict[str, int] = {}
    counters_by: Dict[str, Dict[str, int]] = {}
    gauges: Dict[str, Dict[str, float]] = {}
    hists_parts: Dict[str, List[Mapping[str, Any]]] = {}
    hists_by: Dict[str, Dict[str, Any]] = {}
    replicas: Dict[str, Dict[str, Any]] = {}
    for rkey, snap in sources.items():
        replicas[rkey] = {"version": versions.get(rkey),
                          "meta": dict(snap.get("meta") or {})}
        cs = snap.get("counters") or {}
        counters_by[rkey] = dict(cs)
        for name, v in cs.items():
            counters[name] = counters.get(name, 0) + int(v)
        for name, v in (snap.get("gauges") or {}).items():
            gauges.setdefault(name, {})[rkey] = float(v)
        hs = snap.get("histograms") or {}
        hists_by[rkey] = {k: dict(s) for k, s in hs.items()}
        for hkey, hsnap in hs.items():
            hists_parts.setdefault(hkey, []).append(hsnap)
    histograms = {hkey: merge_histogram_snapshots(parts, key=hkey)
                  for hkey, parts in sorted(hists_parts.items())}
    merged = {
        "meta": {"replica_count": len(sources),
                 "sources": sorted(sources)},
        "replicas": replicas,
        "counters": counters,
        "counters_by_replica": counters_by,
        "gauges": gauges,
        "histograms": histograms,
        "histograms_by_replica": hists_by,
    }
    # goodput-plane blocks federate whenever any source carries
    # them; sources without one simply don't contribute
    ts_sources = {rkey: snap["timeseries"] for rkey, snap in sources.items()
                  if snap.get("timeseries")}
    if ts_sources:
        merged["timeseries"] = merge_timeseries_exports(ts_sources)
    gp_sources = {rkey: snap["goodput"] for rkey, snap in sources.items()
                  if snap.get("goodput")}
    if gp_sources:
        merged["goodput"] = merge_goodput_exports(gp_sources)
    return merged


def federate_host_snapshots(paths: Mapping[str, Any],
                            versions: Optional[Mapping[str, str]] = None
                            ) -> Dict[str, Any]:
    """`merge_snapshots` over per-HOST snapshot files: ``paths`` maps a
    host id to a JSON file holding that process's ``export_snapshot()``
    dict — the payload a `parallel.distributed.HostTelemetryServer`
    serves at ``/metrics.json``, scraped to disk.
    A missing/torn file drops that host from the view (its ``replicas``
    entry records ``"unreadable": True``) rather than failing the merge:
    a dead host must not take the pod's observability down with it."""
    sources: Dict[str, Mapping[str, Any]] = {}
    unreadable: List[str] = []
    for host_id, path in paths.items():
        try:
            with open(os.fspath(path)) as f:
                sources[str(host_id)] = json.load(f)
        except (OSError, ValueError):
            unreadable.append(str(host_id))
    merged = merge_snapshots(sources, versions)
    for host_id in unreadable:
        merged["replicas"][host_id] = {"unreadable": True}
    return merged


def hist_total(merged: Mapping[str, Any], name: str) -> Dict[str, Any]:
    """One merged snapshot for every label-set of histogram `name` in a
    merged fleet view (``serving.fleet.request.latency`` is labeled per
    outcome; the SLO wants the total)."""
    parts = [snap for hkey, snap in (merged.get("histograms") or {}).items()
             if parse_hist_key(hkey)[0] == name]
    return merge_histogram_snapshots(parts, key=name)


def cum_le(snap: Mapping[str, Any], threshold: float) -> int:
    """Observations ≤ the first bucket edge ≥ `threshold` — the "good
    events" numerator of a latency SLO, resolvable exactly only on
    bucket edges (pick thresholds ON the declared ladder)."""
    for le, cum in _norm_buckets(snap.get("buckets") or ()):
        if le >= threshold:
            return int(cum)
    return int(snap.get("count") or 0)


# ---------------------------------------------------------------------------
# fleet Prometheus rendering
# ---------------------------------------------------------------------------

def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_txt(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{sanitize_name(k)}="{v}"' for k, v in pairs)
    return "{" + body + "}"


def _replica_pairs(merged: Mapping[str, Any], rkey: str
                   ) -> List[Tuple[str, str]]:
    ver = (merged.get("replicas") or {}).get(rkey, {}).get("version")
    pairs = [("replica", rkey)]
    if ver:
        pairs.append(("version", str(ver)))
    return pairs


def _hist_lines(lines: List[str], pn: str, snap: Mapping[str, Any],
                pairs: List[Tuple[str, str]]) -> None:
    for le, cum in _norm_buckets(snap.get("buckets") or ()):
        lines.append(f"{pn}_bucket"
                     f"{_labels_txt(pairs + [('le', _fmt(le))])} {cum}")
    lines.append(f"{pn}_sum{_labels_txt(pairs)} {_fmt(snap['sum'])}")
    lines.append(f"{pn}_count{_labels_txt(pairs)} {snap['count']}")


def render_fleet_prometheus(merged: Mapping[str, Any]) -> str:
    """The merged fleet view in Prometheus text format: every series
    carries ``replica``/``version`` labels for the per-replica split
    plus an unlabeled fleet aggregate (counters and histogram series sum
    exactly; gauges aggregate by sum)."""
    lines: List[str] = []
    counters_by = merged.get("counters_by_replica") or {}
    for name, total in sorted((merged.get("counters") or {}).items()):
        pn = sanitize_name(name)
        lines.append(f"# TYPE {pn} counter")
        for rkey in sorted(counters_by):
            if name in counters_by[rkey]:
                lines.append(f"{pn}{_labels_txt(_replica_pairs(merged, rkey))}"
                             f" {counters_by[rkey][name]}")
        lines.append(f"{pn} {total}")
    for name, per in sorted((merged.get("gauges") or {}).items()):
        pn = sanitize_name(name)
        lines.append(f"# TYPE {pn} gauge")
        for rkey in sorted(per):
            lines.append(f"{pn}{_labels_txt(_replica_pairs(merged, rkey))}"
                         f" {_fmt(per[rkey])}")
        lines.append(f"{pn} {_fmt(sum(per.values()))}")
    hists_by = merged.get("histograms_by_replica") or {}
    typed = set()
    for hkey, snap in sorted((merged.get("histograms") or {}).items()):
        name, labels = parse_hist_key(hkey)
        pn = sanitize_name(name)
        if pn not in typed:
            lines.append(f"# TYPE {pn} histogram")
            typed.add(pn)
        for rkey in sorted(hists_by):
            part = hists_by[rkey].get(hkey)
            if part is not None:
                _hist_lines(lines, pn, part,
                            list(labels) + _replica_pairs(merged, rkey))
        _hist_lines(lines, pn, snap, list(labels))
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# cross-replica trace stitching
# ---------------------------------------------------------------------------

def stitch_spans(trace_id: str,
                 sources: Mapping[str, Sequence[Mapping[str, Any]]]
                 ) -> Dict[str, Any]:
    """Assemble one trace id's spans collected from many processes into
    a single tree.  Spans are deduped by span_id (a replica probed twice
    reports the same records twice), tagged with their ``source``
    process, and nested exactly like spans.span_tree: a span whose
    parent lives in ANOTHER process finds it here — that is the point —
    and only spans whose parent was never recorded anywhere root."""
    seen: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for rkey in sorted(sources):
        for rec in sources[rkey]:
            if rec.get("trace_id") != trace_id:
                continue
            sid = rec.get("span_id")
            if not sid or sid in seen:
                continue
            seen[sid] = dict(rec, source=rkey)
            order.append(sid)
    flat = [seen[sid] for sid in order]
    nodes = {sid: dict(rec, children=[]) for sid, rec in seen.items()}
    roots: List[Dict[str, Any]] = []
    for node in sorted(nodes.values(), key=lambda r: r.get("t_start", 0.0)):
        parent = nodes.get(node.get("parent_id")) \
            if node.get("parent_id") else None
        if parent is not None:
            parent["children"].append(node)
        else:
            roots.append(node)
    return {"trace_id": trace_id, "sources": sorted(sources),
            "span_count": len(flat), "spans": flat, "tree": roots}


# ---------------------------------------------------------------------------
# the SLO engine
# ---------------------------------------------------------------------------

class SLO:
    """One declarative objective over the merged fleet view.

    `good_total` maps a merged snapshot to cumulative-or-instant
    ``(good_events, total_events)``; the engine turns windows of those
    into an error rate, and ``burn = error_rate / (1 - objective)`` —
    burn 1.0 exactly consumes the error budget over the window.

    * ``kind="cumulative"`` — good/total are monotonic totals (request
      counts); the window error rate is computed from the DELTAS across
      the window.
    * ``kind="instant"`` — good/total are point-in-time readings
      (healthy vs. registered replicas); the window error rate is the
      mean instantaneous ``1 - good/total``.

    The alert fires only when burn exceeds `burn_threshold` on BOTH the
    fast and the slow window (the classic multi-window guard: the fast
    window gives low detection latency, the slow window stops a
    momentary blip from paging), sustained for `for_s`.
    """

    def __init__(self, name: str, objective: float,
                 good_total: Callable[[Mapping[str, Any]],
                                      Tuple[float, float]],
                 kind: str = "cumulative",
                 fast_window_s: float = 30.0,
                 slow_window_s: float = 300.0,
                 burn_threshold: float = 10.0,
                 for_s: float = 0.0,
                 description: str = ""):
        if kind not in ("cumulative", "instant"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if slow_window_s < fast_window_s:
            raise ValueError("slow window must be >= fast window")
        self.name = name
        self.objective = float(objective)
        self.good_total = good_total
        self.kind = kind
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.for_s = float(for_s)
        self.description = description


# alert lifecycle: condition seen → pending; held for_s → firing;
# condition clears from firing → resolved; stays clear → inactive
_STATES = ("inactive", "pending", "firing", "resolved")


class SLOEngine:
    """Evaluates SLO burn over a ring of merged-snapshot samples.

    ``observe(merged)`` appends one sample per SLO, recomputes fast and
    slow burn, and advances each alert's state machine, bumping the
    declared ``slo.alert.*`` counters and ``slo.burn_rate.*`` gauges and
    invoking transition listeners (the flight recorder subscribes to
    ``→ firing``).  The clock is injectable so tests drive transitions
    with a VirtualClock."""

    def __init__(self, slos: Sequence[SLO],
                 clock: Callable[[], float] = _monotonic,
                 registry=REGISTRY,
                 max_samples: int = 4096):
        self._slos = list(slos)
        self._clock = clock
        self._registry = registry
        self._lock = make_lock("telemetry.slo.engine")
        #: guarded-by self._lock
        self._samples: Dict[str, "collections.deque"] = {
            s.name: collections.deque(maxlen=max_samples) for s in self._slos}
        self._state: Dict[str, str] = {
            s.name: "inactive" for s in self._slos}  #: guarded-by self._lock
        self._since: Dict[str, float] = {}  #: guarded-by self._lock
        self._last: Dict[str, Dict[str, Any]] = {}  #: guarded-by self._lock
        self._listeners: List[Callable[[SLO, str, str, Dict[str, Any]],
                                       None]] = []  #: guarded-by self._lock

    def on_transition(self, fn: Callable[[SLO, str, str, Dict[str, Any]],
                                         None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    @property
    def slos(self) -> List[SLO]:
        return list(self._slos)

    # ---- window math ---------------------------------------------------

    @staticmethod
    def _window_error(slo: SLO, samples: Sequence[Tuple[float, float, float]],
                      now: float, window_s: float) -> float:
        lo = now - window_s
        inside = [s for s in samples if s[0] >= lo]
        if not inside:
            return 0.0
        if slo.kind == "instant":
            rates = [max(0.0, 1.0 - g / t) for _t0, g, t in inside if t > 0]
            return sum(rates) / len(rates) if rates else 0.0
        # cumulative: delta across the window, anchored at the last
        # sample BEFORE the window when one exists (full-window delta)
        before = [s for s in samples if s[0] < lo]
        anchor = before[-1] if before else inside[0]
        _t, g1, n1 = anchor
        _t2, g2, n2 = inside[-1]
        dn = n2 - n1
        if dn <= 0:
            return 0.0
        dg = g2 - g1
        return max(0.0, 1.0 - dg / dn)

    def _burns(self, slo: SLO, now: float) -> Tuple[float, float]:
        samples = list(self._samples[slo.name])
        budget = 1.0 - slo.objective
        fast = self._window_error(slo, samples, now, slo.fast_window_s)
        slow = self._window_error(slo, samples, now, slo.slow_window_s)
        return fast / budget, slow / budget

    # ---- evaluation ----------------------------------------------------

    def observe(self, merged: Mapping[str, Any],
                now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed one merged fleet snapshot; returns the alert list."""
        now = self._clock() if now is None else float(now)
        transitions: List[Tuple[SLO, str, str, Dict[str, Any]]] = []
        with self._lock:
            for slo in self._slos:
                try:
                    good, total = slo.good_total(merged)
                except Exception:
                    continue  # a malformed snapshot must not kill the loop
                self._samples[slo.name].append(
                    (now, float(good), float(total)))
                burn_fast, burn_slow = self._burns(slo, now)
                cond = (burn_fast >= slo.burn_threshold
                        and burn_slow >= slo.burn_threshold)
                state = self._state[slo.name]
                if state == "inactive" and cond:
                    state = "pending"
                    self._since[slo.name] = now
                    transitions.append((slo, "inactive", "pending", {}))
                elif state == "pending" and not cond:
                    state = "inactive"
                    self._since.pop(slo.name, None)
                elif state == "resolved":
                    if cond:
                        state = "pending"
                        self._since[slo.name] = now
                        transitions.append((slo, "resolved", "pending", {}))
                    else:
                        state = "inactive"
                if state == "pending" and cond and \
                        now - self._since.get(slo.name, now) >= slo.for_s:
                    state = "firing"
                    transitions.append((slo, "pending", "firing", {}))
                elif state == "firing" and not cond:
                    state = "resolved"
                    self._since.pop(slo.name, None)
                    transitions.append((slo, "firing", "resolved", {}))
                self._state[slo.name] = state
                self._last[slo.name] = {
                    "slo": slo.name,
                    "state": state,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "objective": slo.objective,
                    "burn_threshold": slo.burn_threshold,
                    "fast_window_s": slo.fast_window_s,
                    "slow_window_s": slo.slow_window_s,
                    "since": self._since.get(slo.name),
                    "good": good,
                    "total": total,
                    "description": slo.description,
                }
                self._registry.gauge(
                    f"slo.burn_rate.{slo.name}").set(burn_fast)
            listeners = list(self._listeners)
            alerts = [dict(self._last[s.name]) for s in self._slos
                      if s.name in self._last]
            # snapshot per-transition detail while still under the lock;
            # listeners run outside it (they may call back into us)
            transitions = [
                (slo, old, new, dict(self._last.get(slo.name, {}), **info))
                for slo, old, new, info in transitions]
        for slo, old, new, info in transitions:
            self._registry.incr(f"slo.alert.{new}")
            self._registry.incr(f"slo.alert.{new}.{slo.name}")
            for fn in listeners:
                try:
                    fn(slo, old, new, info)
                except Exception:
                    pass  # a listener must never break evaluation
        return alerts

    def alerts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(self._last[s.name]) for s in self._slos
                    if s.name in self._last]

    def state(self, name: str) -> str:
        with self._lock:
            return self._state.get(name, "inactive")


def default_slos(latency_threshold_s: float = 0.31622776601683794,
                 fast_window_s: float = 30.0,
                 slow_window_s: float = 300.0,
                 burn_threshold: float = 10.0) -> List[SLO]:
    """The stock fleet objectives.  The latency threshold defaults to
    the 10^-0.5 s edge of the latency bucket family — latency SLOs only
    resolve exactly ON a declared edge."""

    def availability(m: Mapping[str, Any]) -> Tuple[float, float]:
        g = m.get("gauges") or {}
        healthy = sum((g.get("serving.fleet.healthy") or {}).values())
        total = sum((g.get("serving.fleet.replicas") or {}).values())
        return healthy, total

    def latency(m: Mapping[str, Any]) -> Tuple[float, float]:
        snap = hist_total(m, "serving.fleet.request.latency")
        return float(cum_le(snap, latency_threshold_s)), \
            float(snap["count"])

    def deadline(m: Mapping[str, Any]) -> Tuple[float, float]:
        c = m.get("counters") or {}
        missed = sum(v for k, v in c.items()
                     if k == "serving.fleet.deadline_expired"
                     or k == "serving.deadline_expired"
                     or k == "batcher.deadline_expired")
        snap = hist_total(m, "serving.fleet.request.latency")
        total = float(snap["count"])
        return max(0.0, total - missed), total

    return [
        SLO("availability", 0.999, availability, kind="instant",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            burn_threshold=burn_threshold,
            description="routable replicas / registered replicas"),
        SLO("latency_p99", 0.99, latency, kind="cumulative",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            burn_threshold=burn_threshold,
            description=f"fleet requests <= {latency_threshold_s:.3g}s"),
        SLO("deadline_miss", 0.999, deadline, kind="cumulative",
            fast_window_s=fast_window_s, slow_window_s=slow_window_s,
            burn_threshold=burn_threshold,
            description="requests not expired past their deadline"),
    ]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Atomic post-mortem bundles under ``<root>/incidents/``.

    ``dump()`` writes every artifact into a hidden temp directory and
    renames it into place — a crash mid-dump leaves only a ``.tmp-*``
    turd, never a half-readable incident — then prunes oldest bundles
    beyond `max_bundles` so an alert flapping all night cannot fill the
    disk."""

    def __init__(self, root: str, max_bundles: int = 16):
        self.root = os.path.join(root, "incidents")
        self.max_bundles = int(max_bundles)
        self._lock = make_lock("telemetry.flight.recorder")
        self._seq = 0  #: guarded-by self._lock

    def dump(self, reason: str,
             merged: Optional[Mapping[str, Any]] = None,
             traces: Optional[Mapping[str, Any]] = None,
             records: Optional[Sequence[Any]] = None,
             health: Optional[Mapping[str, Any]] = None,
             alerts: Optional[Sequence[Mapping[str, Any]]] = None) -> str:
        safe = sanitize_name(reason) or "incident"
        with self._lock:
            self._seq += 1
            stamp = time.strftime("%Y%m%dT%H%M%S")
            name = f"{stamp}-{self._seq:03d}-{safe}"
            final = os.path.join(self.root, name)
            tmp = os.path.join(self.root, f".tmp-{name}")
            os.makedirs(tmp, exist_ok=True)
            artifacts = {
                "snapshot.json": merged,
                "traces.json": traces,
                "records.json": list(records) if records else None,
                "health.json": health,
                "alerts.json": list(alerts) if alerts else None,
            }
            written = []
            for fname, obj in artifacts.items():
                if obj is None:
                    continue
                with open(os.path.join(tmp, fname), "w") as f:
                    json.dump(obj, f, indent=2, default=repr)
                written.append(fname)
            manifest = {"reason": reason, "created": stamp,
                        "files": sorted(written)}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f, indent=2)
            os.rename(tmp, final)
            self._registry_incr()
            self._prune_locked()
        return final

    def _registry_incr(self) -> None:
        REGISTRY.incr("fleet.incident")

    def _prune_locked(self) -> None:
        try:
            bundles = sorted(d for d in os.listdir(self.root)
                             if not d.startswith("."))
        except OSError:
            return
        for stale in bundles[:-self.max_bundles] \
                if len(bundles) > self.max_bundles else []:
            path = os.path.join(self.root, stale)
            try:
                for fn in os.listdir(path):
                    os.unlink(os.path.join(path, fn))
                os.rmdir(path)
            except OSError:
                pass

    def bundles(self) -> List[str]:
        try:
            return sorted(os.path.join(self.root, d)
                          for d in os.listdir(self.root)
                          if not d.startswith("."))
        except OSError:
            return []
