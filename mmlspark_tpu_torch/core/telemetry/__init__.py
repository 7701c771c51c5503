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
fleet merge helpers; and the fleet plane that federates many processes
(``fleet.py``: ``merge_snapshots``, ``render_fleet_prometheus``,
``stitch_spans``, ``SLOEngine``, ``FlightRecorder``), with the trace
headers (``trace_headers``) that carry one trace across processes; and
the device plane (``device.py``): the compile sentry over the port's
kernel builds and watched step sites (``track_compiles`` /
``watch_compiles``), the device-memory gauges
(``sample_device_memory`` / ``start_memory_sampler``) and opt-in
``torch.profiler.record_function`` annotations on stage spans
(``enable_device_annotations``).  ``format_span_tree`` /
``format_latency_table`` render the ascii reports.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from ...utils.stopwatch import StopWatch
from .metrics import (
    BUCKET_FAMILIES,
    BYTE_BUCKETS,
    DECLARED_METRICS,
    FILL_BUCKETS,
    Gauge,
    HISTOGRAM_FAMILY,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    buckets_for,
    default_buckets,
    is_declared,
)
from .exposition import (
    export_snapshot,
    format_latency_table,
    format_span_tree,
    render_chrome_trace,
    render_prometheus,
)
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
from .records import clear_records, log_verb, logger, recent_records
from .spans import (
    SPAN_HEADER,
    TRACE_HEADER,
    clear_spans,
    current_context,
    current_trace_id,
    extract_trace,
    get_trace,
    recent_spans,
    record_span,
    span,
    span_tree,
    trace_headers,
    use_trace,
)
from .fleet import (
    FlightRecorder,
    SLO,
    SLOEngine,
    cum_le,
    default_slos,
    federate_host_snapshots,
    hist_total,
    merge_histogram_snapshots,
    merge_snapshots,
    render_fleet_prometheus,
    stitch_spans,
)
from .device import (
    SENTRY,
    CompileSentry,
    MemorySampler,
    device_annotation,
    enable_device_annotations,
    sample_device_memory,
    start_memory_sampler,
    track_compiles,
    watch_compiles,
)

__all__ = [
    "incr", "counters", "reset_counters", "gauge", "histogram",
    "REGISTRY", "MetricsRegistry", "Gauge", "Histogram", "default_buckets",
    "BYTE_BUCKETS", "FILL_BUCKETS", "BUCKET_FAMILIES", "HISTOGRAM_FAMILY",
    "buckets_for", "DECLARED_METRICS", "is_declared",
    "log_verb", "recent_records", "clear_records", "logger", "StopWatch",
    "span", "record_span", "use_trace", "current_context",
    "current_trace_id", "trace_headers", "extract_trace", "get_trace",
    "span_tree", "recent_spans", "clear_spans", "TRACE_HEADER",
    "SPAN_HEADER",
    "render_prometheus", "export_snapshot", "render_chrome_trace",
    "format_span_tree", "format_latency_table",
    "GoodputLedger", "LEDGER", "LOST_KINDS", "StepTimeline",
    "detect_straggler", "merge_goodput_exports",
    "SAMPLED_SERIES", "STORE", "TimeSeriesStore", "merge_timeseries_exports",
    # fleet plane
    "merge_histogram_snapshots", "merge_snapshots", "federate_host_snapshots",
    "hist_total", "cum_le", "render_fleet_prometheus", "stitch_spans",
    "SLO", "SLOEngine", "default_slos", "FlightRecorder",
    # device (compile sentry, memory gauges, annotations)
    "SENTRY", "CompileSentry", "track_compiles", "watch_compiles",
    "sample_device_memory", "MemorySampler", "start_memory_sampler",
    "enable_device_annotations", "device_annotation",
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
