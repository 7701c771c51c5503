"""One run of one cell: set-up, the closed-loop window, the traced window,
the check of what the window produced, and the result line.

A driver (`drivers/<name>.py`) provides `CALL` (the name of its unit of
work) and `setup(ctx)`, which builds the system under test from the seed,
warms up every shape the mix uses and returns a cell with:

    call() -> dict       one unit of the closed loop, finished when it
                         returns; `rows`, and for training `steps`, count
                         its work, `ok` says whether its output was whole
    counters() -> dict   the program's own counters (nested numbers)
    release()            frees the program's state on the device
    verify() -> list     (name, value, limit) of each number compared with
                         the plain reference, after the window

The window calls `call()` back to back until `--seconds` have passed and
the call in flight has returned; its calls give the end-to-end metrics.
With `--trace 1` the same window runs, then `traced_calls` more calls
(the mix says how many) run under the profiler, and the per-layer
metrics are reported instead.
"""
from __future__ import annotations

import json
import math
import sys
import time
from typing import Any, Dict, List, Optional

from . import device, isolation, spec
from .trace import TraceSummary, capture

__all__ = ["Context", "Call", "View", "run_cell", "delta"]


class Context:
    """What a driver gets: the cell's configuration, mix, limits, seed and
    device, and whether this run is traced."""

    def __init__(self, workload: dict, config: dict, mix: dict,
                 limits: dict, seed: int, device_name: str, trace: bool):
        self.workload = workload
        self.config = config
        self.mix = mix
        self.limits = limits
        self.seed = int(seed)
        self.device = device_name
        self.trace = bool(trace)


class Call:
    def __init__(self, start: float, end: float, rec: Dict[str, Any]):
        self.start = start
        self.end = end
        self.rec = rec

    @property
    def seconds(self) -> float:
        return self.end - self.start


class View:
    """What a metric's reader gets.  `calls` are the untraced window's
    calls (times on the host clock from the window's start) and
    `window_s` its length; `counters` the program's counters over that
    window; `trace` the traced window's summary and `traced` its calls'
    records (None and [] without `--trace 1`); `family` the plain
    reference module of the configuration (its `forward_macs`)."""

    def __init__(self, ctx: Context, calls: List[Call],
                 counters: Dict[str, Any], trace: Optional[TraceSummary],
                 traced: List[Dict[str, Any]]):
        self.workload = ctx.workload["name"]
        self.config = ctx.config
        self.mix = ctx.mix
        self.calls = calls
        self.window_s = calls[-1].end if calls else 0.0
        self.counters = counters
        self.trace = trace
        self.traced = traced
        self.family = spec.family_module(ctx.config)


def delta(after: Any, before: Any) -> Any:
    """after - before over nested dicts of numbers (keys new in `after`
    count from 0)."""
    if isinstance(after, dict):
        before = before if isinstance(before, dict) else {}
        return {k: delta(v, before.get(k, 0)) for k, v in after.items()}
    if isinstance(after, (int, float)):
        return after - (before if isinstance(before, (int, float)) else 0)
    return after


def window(cell, seconds: float) -> List[Call]:
    calls: List[Call] = []
    t0 = time.perf_counter()
    while True:
        s = time.perf_counter()
        rec = cell.call()
        e = time.perf_counter()
        calls.append(Call(s - t0, e - t0, rec))
        if e - t0 >= seconds:
            return calls


def traced_window(cell, n: int, call_name: str):
    from torch.profiler import record_function

    def calls():
        out = []
        for _ in range(n):
            with record_function("perfbench." + call_name):
                out.append(cell.call())
        return out

    return capture(calls)


def _metrics(bench: dict, section: str, view: View, base: str) -> dict:
    out = {}
    for entry in spec.metrics_for(bench, section, view.workload):
        if entry["name"] == "setup_s":  # the runner's own clock
            continue
        value = spec.metric_reader(entry["name"], base).read(view)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run_cell(bench: dict, ctx: Context, t_start: float, seconds: float,
             base: str = spec.BENCH_DIR) -> int:
    """Runs the cell and prints its result line; returns the exit code."""
    drv = spec.driver(ctx.mix["driver"], base)
    cell = drv.setup(ctx)
    setup_s = time.perf_counter() - t_start
    before = cell.counters()
    calls = window(cell, seconds)
    counters = delta(cell.counters(), before)
    trace, traced = None, []
    if ctx.trace:
        traced, trace = traced_window(cell, int(ctx.mix["traced_calls"]),
                                      drv.CALL)
    dev = device.describe(int(ctx.workload["chips"]))
    cell.release()
    checks = cell.verify()

    found = isolation.forbidden_modules()
    if found:
        device.log("perfbench: the process loaded " + ", ".join(found))
        return 4

    view = View(ctx, calls, counters, trace, traced)
    if ctx.trace:
        metrics = _metrics(bench, "per_layer", view, base)
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        metrics.update(_metrics(bench, "end_to_end", view, base))
    runs = calls + [Call(0.0, 0.0, r) for r in traced]
    failed = sum(1 for c in runs if not c.rec.get("ok", True))
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for _n, v, lim in checks)
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": len(runs), "failed": failed,
        "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        device.log(f"check {n} {v!r} limit {lim!r}")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
