"""Dapper-style spans: trace-id / span-id / parent-id wall-time records.

A copy of the JAX package's `core/telemetry/spans.py` for this package.
Its device-annotation hook (`set_annotation_hook`) is armed by
`telemetry.device.enable_device_annotations` with
`torch.profiler.record_function`.

A **trace** is one logical request's causal tree; a **span** is one
timed operation inside it.  The current (trace_id, span_id) pair lives
in a `contextvars.ContextVar` — per-thread by construction (each thread
starts from an empty context).  Crossing an EXPLICIT thread boundary (a
serving batch loop picking up a held request, a flow worker attributing
its work to the caller's trace) re-activates the recorded pair via
`use_trace(ctx)` or records with `record_span(ctx)`; crossing a PROCESS
boundary rides the `X-Trace-Id` / `X-Span-Id` HTTP headers
(`trace_headers()` injects on the client, `extract_trace()` continues on
the server).

Finished spans land in a bounded ring (`recent_spans`) and a bounded
per-trace index (`get_trace`).  Both are capped, so always-on span
recording cannot grow host memory; the caps drop OLDEST whole traces
first.  A trace over `MAX_SPANS_PER_TRACE` keeps its first spans and
still indexes its root, which closes last (in place of the newest
non-root span); every span the index drops counts in
`telemetry.spans.dropped`, so a truncated trace tells itself from a
short one.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .metrics import REGISTRY

__all__ = ["span", "record_span", "use_trace", "current_context",
           "current_trace_id", "trace_headers", "extract_trace",
           "get_trace", "span_tree", "recent_spans", "clear_spans",
           "set_annotation_hook", "get_annotation_hook",
           "TRACE_HEADER", "SPAN_HEADER",
           "MAX_SPANS", "MAX_TRACES", "MAX_SPANS_PER_TRACE"]

MAX_SPANS = 8192          # global recent-span ring
MAX_TRACES = 512          # distinct trace ids indexed for /trace/<id>
MAX_SPANS_PER_TRACE = 2048

# (trace_id, span_id) of the CURRENT span, or None outside any trace
_CTX: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("mmlspark_tpu_torch_trace", default=None)

_LOCK = threading.Lock()
_SPANS: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=MAX_SPANS)
_TRACES: "collections.OrderedDict[str, List[Dict[str, Any]]]" = \
    collections.OrderedDict()


# Optional device-annotation hook (set by telemetry.device): a factory of
# context managers (torch.profiler.record_function) plus the span-name
# prefixes it applies to.  When armed, span() additionally enters an
# annotation for matching names so a profiler capture carries our span
# names.  Kept here (not in device.py) so span() stays import-light: the
# factory is injected, never looked up.
_ANNOTATION_FACTORY = None
_ANNOTATION_PREFIXES: Tuple[str, ...] = ()


def set_annotation_hook(factory, prefixes: Tuple[str, ...] = ()) -> None:
    """Arm (or with factory=None disarm) the device-annotation hook."""
    global _ANNOTATION_FACTORY, _ANNOTATION_PREFIXES
    _ANNOTATION_FACTORY = factory
    _ANNOTATION_PREFIXES = tuple(prefixes)


def get_annotation_hook():
    return _ANNOTATION_FACTORY, _ANNOTATION_PREFIXES


def _annotation_for(name: str):
    if _ANNOTATION_FACTORY is None or not _ANNOTATION_PREFIXES:
        return None
    if not name.startswith(_ANNOTATION_PREFIXES):
        return None
    try:
        return _ANNOTATION_FACTORY(name)
    except Exception:
        return None


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


def current_context() -> Optional[Tuple[str, str]]:
    """The active (trace_id, span_id), or None."""
    return _CTX.get()


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx[0] if ctx is not None else None


def _store(rec: Dict[str, Any]) -> None:
    dropped = False
    with _LOCK:
        _SPANS.append(rec)
        tid = rec["trace_id"]
        spans = _TRACES.get(tid)
        if spans is None:
            while len(_TRACES) >= MAX_TRACES:
                _TRACES.popitem(last=False)
            spans = _TRACES[tid] = []
        if len(spans) < MAX_SPANS_PER_TRACE:
            spans.append(rec)
        else:
            dropped = True
            if rec["parent_id"] is None:
                # the root closes last: it takes the newest non-root's place
                for i in range(len(spans) - 1, -1, -1):
                    if spans[i]["parent_id"] is not None:
                        spans[i] = rec
                        break
    if dropped:
        REGISTRY.incr("telemetry.spans.dropped")


class _Span:
    """Handle yielded by span(): ids plus a mutable attr dict the body
    can annotate (outcome, sizes) before the record is stored."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "attrs")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs


@contextlib.contextmanager
def span(name: str, parent_ctx: Optional[Tuple[str, str]] = None,
         **attrs: Any):
    """Open a span: child of the current context (or of `parent_ctx`,
    e.g. one extracted from request headers); a fresh trace root when
    neither exists.  Wall time and a raised exception's type are
    captured; the exception propagates."""
    parent = parent_ctx if parent_ctx is not None else _CTX.get()
    trace_id = parent[0] if parent else _new_id()
    span_id = _new_id()
    sp = _Span(name, trace_id, span_id,
               parent[1] if parent else None, dict(attrs))
    annotation = _annotation_for(name)
    token = _CTX.set((trace_id, span_id))
    t_start = time.time()
    t0 = time.perf_counter()
    err: Optional[str] = None
    try:
        if annotation is not None:
            with annotation:
                yield sp
        else:
            yield sp
    except BaseException as e:  # noqa: BLE001 — recorded, then re-raised
        err = type(e).__name__
        raise
    finally:
        _CTX.reset(token)
        rec: Dict[str, Any] = {
            "name": name,
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": sp.parent_id,
            "t_start": t_start,
            "wall_s": round(time.perf_counter() - t0, 6),
            "tid": threading.get_ident(),
        }
        if err:
            rec["error"] = err
        if sp.attrs:
            rec["attrs"] = sp.attrs
        _store(rec)


def record_span(name: str, ctx: Optional[Tuple[str, str]], wall_s: float,
                t_start: Optional[float] = None, **attrs: Any
                ) -> Dict[str, Any]:
    """Record an already-measured span as a child of `ctx` — the
    cross-thread shape (a batch loop attributing queue wait to the
    handler thread's request span) where a context manager can't wrap
    the producer.  With ctx=None the span roots a fresh trace.  The span
    ends now unless `t_start` (seconds on `time.time()`'s clock) places
    it — an interval measured elsewhere, such as on the device."""
    rec: Dict[str, Any] = {
        "name": name,
        "trace_id": ctx[0] if ctx is not None else _new_id(),
        "span_id": _new_id(),
        "parent_id": ctx[1] if ctx is not None else None,
        "t_start": time.time() - wall_s if t_start is None else t_start,
        "wall_s": round(float(wall_s), 6),
        "tid": threading.get_ident(),
    }
    if attrs:
        rec["attrs"] = dict(attrs)
    _store(rec)
    return rec


@contextlib.contextmanager
def use_trace(ctx: Optional[Tuple[str, str]]):
    """Re-activate a recorded (trace_id, span_id) on THIS thread (the
    explicit thread-hop propagation).  None is a no-op, so call sites
    can pass a maybe-absent context unconditionally."""
    if ctx is None:
        yield
        return
    token = _CTX.set((ctx[0], ctx[1]))
    try:
        yield
    finally:
        _CTX.reset(token)


# ---- HTTP propagation ----------------------------------------------------

TRACE_HEADER = "X-Trace-Id"
SPAN_HEADER = "X-Span-Id"


def trace_headers(headers: Optional[Dict[str, str]] = None
                  ) -> Dict[str, str]:
    """Copy of `headers` with the current trace context injected (the
    client half of propagation).  Outside any trace, or when the caller
    already set the headers, the copy is returned unchanged."""
    out = dict(headers or {})
    ctx = _CTX.get()
    if ctx is not None:
        out.setdefault(TRACE_HEADER, ctx[0])
        out.setdefault(SPAN_HEADER, ctx[1])
    return out


def extract_trace(headers) -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) from request headers (`X-Trace-Id`,
    `X-Span-Id`), case-insensitively (the server half).  A trace id
    without a span id is continued with an empty parent — the upstream
    did not tell us which span sent it."""
    tid = sid = None
    for k in headers.keys():
        lk = k.lower()
        if lk == "x-trace-id":
            tid = str(headers[k])
        elif lk == "x-span-id":
            sid = str(headers[k])
    if not tid:
        return None
    return (tid, sid or "")


# ---- read side -----------------------------------------------------------

def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """Every recorded span of one trace, in completion order."""
    with _LOCK:
        return list(_TRACES.get(trace_id, ()))


def span_tree(trace_id: str) -> List[Dict[str, Any]]:
    """The trace's spans nested parent->children (roots returned; a span
    whose parent was sent by a remote upstream roots locally)."""
    spans = get_trace(trace_id)
    nodes = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: List[Dict[str, Any]] = []
    # children finish before parents: sort siblings by start time
    for s in sorted(nodes.values(), key=lambda r: r["t_start"]):
        parent = nodes.get(s["parent_id"]) if s["parent_id"] else None
        if parent is not None:
            parent["children"].append(s)
        else:
            roots.append(s)
    return roots


def recent_spans(n: Optional[int] = None) -> List[Dict[str, Any]]:
    with _LOCK:
        out = list(_SPANS)
    return out if n is None else out[-n:]


def clear_spans() -> None:
    with _LOCK:
        _SPANS.clear()
        _TRACES.clear()
