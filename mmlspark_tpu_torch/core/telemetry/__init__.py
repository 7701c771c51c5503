"""Observability for this package: verb records, counters, gauges,
histograms and spans behind one process registry.

A small copy of the JAX package's `core/telemetry`, holding what the
ported slices record: ``log_verb`` (stage verbs), ``incr`` / ``gauge`` /
``histogram`` (the feed, flow, pipeline, batcher and server
instruments), ``span`` / ``record_span`` (worker-thread spans attached
to the caller's trace), and what the serving endpoints expose
(``render_prometheus`` at ``/metrics``, ``export_snapshot`` at
``/metrics.json``, ``render_chrome_trace`` at ``/trace.json``), and the
training loop's goodput plane: the step-timeline ledger ``LEDGER``
(``goodput.py``) and the sampled series store ``STORE``
(``timeseries.py``), copies of the JAX package's modules, with their
fleet merge helpers.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from .metrics import (
    BYTE_BUCKETS,
    DECLARED_METRICS,
    Gauge,
    Histogram,
    REGISTRY,
    is_declared,
)
from .exposition import export_snapshot, render_chrome_trace, render_prometheus
from .goodput import (
    GoodputLedger,
    LEDGER,
    LOST_KINDS,
    StepTimeline,
    detect_straggler,
    merge_goodput_exports,
)
from .timeseries import (
    SAMPLED_SERIES,
    STORE,
    TimeSeriesStore,
    merge_timeseries_exports,
)
from .records import clear_records, log_verb, recent_records
from .spans import (
    clear_spans,
    current_context,
    extract_trace,
    get_trace,
    recent_spans,
    record_span,
    span,
    span_tree,
    use_trace,
)

__all__ = [
    "incr", "counters", "reset_counters", "gauge", "histogram",
    "REGISTRY", "Gauge", "Histogram", "BYTE_BUCKETS", "DECLARED_METRICS",
    "is_declared",
    "log_verb", "recent_records", "clear_records",
    "span", "record_span", "use_trace", "current_context", "get_trace",
    "extract_trace", "span_tree", "recent_spans", "clear_spans",
    "render_prometheus", "export_snapshot", "render_chrome_trace",
    "GoodputLedger", "LEDGER", "LOST_KINDS", "StepTimeline",
    "detect_straggler", "merge_goodput_exports",
    "SAMPLED_SERIES", "STORE", "TimeSeriesStore", "merge_timeseries_exports",
]


def incr(name: str, n: int = 1) -> None:
    """Bump a named event counter (dotted names: 'feed.transfer_retry')."""
    REGISTRY.incr(name, n)


def counters(prefix: Optional[str] = None) -> Dict[str, int]:
    """Snapshot the event counters, optionally filtered by name prefix."""
    return REGISTRY.counter_values(prefix)


def reset_counters(prefix: Optional[str] = None) -> None:
    """Zero the counters (tests); with `prefix`, only matching names."""
    REGISTRY.reset_counters(prefix)


def gauge(name: str) -> Gauge:
    """The process-registry gauge `name` (created on first touch)."""
    return REGISTRY.gauge(name)


def histogram(name: str, boundaries: Optional[Sequence[float]] = None,
              **labels: str) -> Histogram:
    """The process-registry histogram `name` (first touch fixes the
    bucket ladder for the whole labeled family)."""
    return REGISTRY.histogram(name, boundaries, **labels)
