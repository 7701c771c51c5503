"""Render the registry for consumers: Prometheus text, JSON snapshots,
Chrome trace-event JSON, and the ascii span-tree / latency tables.

A copy of the JAX package's `core/telemetry/exposition.py` for this
package; the snapshot's backend facts come from `torch.cuda`.

Prometheus exposition convention (text format 0.0.4): dotted internal
names (`serving.request.latency`) sanitize to underscore names
(`serving_request_latency`); histograms expose CUMULATIVE
`_bucket{le="..."}` series ending in `le="+Inf"`, plus `_sum`/`_count`.
"""
from __future__ import annotations

import json
import math
import os
import re
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import goodput as _goodput
from . import spans as _spans
from . import timeseries as _timeseries
from .metrics import REGISTRY, MetricsRegistry

__all__ = ["render_prometheus", "export_snapshot", "render_chrome_trace",
           "format_span_tree", "format_latency_table", "sanitize_name"]

# process uptime baseline: first telemetry import ~ process start
_T0_MONOTONIC = time.monotonic()

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_name(name: str) -> str:
    out = _NAME_BAD.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _fmt_labels(labels: Tuple[Tuple[str, str], ...],
                extra: Optional[Tuple[Tuple[str, str], ...]] = None) -> str:
    items = list(labels) + list(extra or ())
    if not items:
        return ""
    body = ",".join(f'{sanitize_name(k)}="{_escape(v)}"' for k, v in items)
    return "{" + body + "}"


def render_prometheus(registry: MetricsRegistry = REGISTRY) -> str:
    """The full registry in Prometheus text format (what `/metrics`
    serves)."""
    lines: List[str] = []
    for name, val in sorted(registry.counter_values().items()):
        pn = sanitize_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {val}")
    for name, val in sorted(registry.gauge_values().items()):
        pn = sanitize_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt_value(val)}")
    typed = set()
    for (name, labels), h in sorted(registry.histograms().items(),
                                    key=lambda kv: (kv[0][0], kv[0][1])):
        pn = sanitize_name(name)
        if pn not in typed:
            lines.append(f"# TYPE {pn} histogram")
            typed.add(pn)
        snap = h.snapshot()
        for le, cum in snap["buckets"]:
            lines.append(
                f"{pn}_bucket"
                f"{_fmt_labels(labels, (('le', _fmt_value(le)),))} {cum}")
        lines.append(f"{pn}_sum{_fmt_labels(labels)} "
                     f"{_fmt_value(snap['sum'])}")
        lines.append(f"{pn}_count{_fmt_labels(labels)} {snap['count']}")
    return "\n".join(lines) + "\n"


def _hist_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


def _json_safe(v: Any) -> Any:
    """`v` if json can carry it, else its repr() — span attrs are
    free-form and a stray tensor/dtype must degrade to a string."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError, OverflowError):
        return repr(v)


def _safe_span(rec: Dict[str, Any]) -> Dict[str, Any]:
    attrs = rec.get("attrs")
    if not attrs:
        return rec
    return dict(rec, attrs={k: _json_safe(v) for k, v in attrs.items()})


def _snapshot_meta(timestamp: Optional[str]) -> Dict[str, Any]:
    """Self-describing header for saved snapshots.  Backend facts are
    reported only when CUDA is ALREADY initialised in this process — a
    /metrics-adjacent dump must never be the thing that initialises the
    card."""
    meta: Dict[str, Any] = {
        "timestamp": timestamp,
        "pid": os.getpid(),
        "uptime_s": round(time.monotonic() - _T0_MONOTONIC, 3),
        "backend": None,
        "device_count": None,
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                meta["backend"] = "cuda"
                meta["device_count"] = torch.cuda.device_count()
        except Exception:
            pass
    return meta


def export_snapshot(registry: MetricsRegistry = REGISTRY,
                    include_spans: bool = True,
                    timestamp: Optional[str] = None) -> Dict[str, Any]:
    """One JSON-serializable dict of everything the process has observed:
    a `meta` header (caller-supplied timestamp, pid, process uptime, the
    CUDA backend and device count when CUDA is initialised),
    counters, gauges, histogram snapshots (keyed `name` or
    `name{k="v"}`), and (optionally) the recent-span ring with
    non-serializable attrs degraded to repr(), and the goodput plane's
    `timeseries` / `goodput` blocks when the process produced any."""
    hists: Dict[str, Any] = {}
    for (name, labels), h in registry.histograms().items():
        snap = h.snapshot()
        snap["buckets"] = [["+Inf" if le == math.inf else le, cum]
                           for le, cum in snap["buckets"]]
        hists[_hist_key(name, labels)] = snap
    out: Dict[str, Any] = {
        "meta": _snapshot_meta(timestamp),
        "counters": registry.counter_values(),
        "gauges": registry.gauge_values(),
        "histograms": hists,
    }
    if include_spans:
        out["spans"] = [_safe_span(r) for r in _spans.recent_spans()]
    # the goodput plane: recent history + per-step timelines, only when
    # the process actually produced any — idle servers keep the plain
    # snapshot shape
    if registry is REGISTRY:
        ts = _timeseries.STORE.export()
        if ts["series"]:
            out["timeseries"] = ts
        gp = _goodput.LEDGER.export()
        if gp["steps"] or gp["summary"]["lost"] or gp["summary"]["productive_s"]:
            out["goodput"] = gp
    return out


def render_chrome_trace(span_records: Optional[Iterable[Dict[str, Any]]]
                        = None) -> Dict[str, Any]:
    """The span ring as Chrome/Perfetto trace-event JSON: each span a
    `ph:"X"` complete event (ts/dur in microseconds, tid = the recording
    thread) with trace/span/parent ids and attrs under `args`.  Served
    at `GET /trace.json`."""
    if span_records is None:
        span_records = _spans.recent_spans()
    pid = os.getpid()
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"mmlspark_tpu_torch[{pid}]"},
    }]
    for rec in span_records:
        name = str(rec.get("name", "?"))
        args: Dict[str, Any] = {
            "trace_id": rec.get("trace_id"),
            "span_id": rec.get("span_id"),
            "parent_id": rec.get("parent_id"),
        }
        for k, v in (rec.get("attrs") or {}).items():
            args[k] = _json_safe(v)
        if rec.get("error"):
            args["error"] = rec["error"]
        events.append({
            "name": name,
            "cat": name.split(".", 1)[0],
            "ph": "X",
            "ts": round(float(rec.get("t_start", 0.0)) * 1e6, 3),
            "dur": round(max(0.0, float(rec.get("wall_s", 0.0))) * 1e6, 3),
            "pid": pid,
            "tid": int(rec.get("tid", 0)),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---- ascii report renderers ----------------------------------------------

def format_span_tree(roots: List[Dict[str, Any]], indent: str = "") -> str:
    """Ascii tree of nested span dicts (the `span_tree()` shape)."""
    lines: List[str] = []
    for i, node in enumerate(roots):
        last = i == len(roots) - 1
        branch = "└─ " if last else "├─ "
        attrs = node.get("attrs") or {}
        extra = "".join(f" {k}={v}" for k, v in sorted(attrs.items()))
        err = f" !{node['error']}" if node.get("error") else ""
        lines.append(f"{indent}{branch}{node['name']} "
                     f"[{node['wall_s'] * 1e3:.2f} ms]{err}{extra}")
        child_indent = indent + ("   " if last else "│  ")
        children = node.get("children") or []
        if children:
            lines.append(format_span_tree(children, child_indent))
    return "\n".join(lines)


def format_latency_table(histograms: Dict[str, Any]) -> str:
    """p50/p95/p99 table from export_snapshot()['histograms']."""
    rows = [("histogram", "count", "p50", "p95", "p99")]
    for key in sorted(histograms):
        snap = histograms[key]

        def fmt(v: Optional[float]) -> str:
            return "-" if v is None else f"{v:.6g}"

        rows.append((key, str(snap["count"]), fmt(snap.get("p50")),
                     fmt(snap.get("p95")), fmt(snap.get("p99"))))
    widths = [max(len(r[c]) for r in rows) for c in range(5)]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(cell.ljust(w) for cell, w in zip(r, widths))
                     .rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
