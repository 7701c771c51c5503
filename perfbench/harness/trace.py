"""The traced window: one `torch.profiler` capture, reduced to what the
per-layer readers and the result's `device` and `breakdown` need.

`busy_s` is the union of the intervals in which any device operation
(kernel, copy, memset) ran inside the window, `window_s` the window's
length, both on the profiler's clock; the ranges that the profiler draws
on the device timeline for host spans (`record_function`) are not
operations and are left out.  Kernel time by name sums the device
operations whose name holds a given string.  The idle gaps are the
stretches of the window with nothing on the device, each named by what
the host was doing at its middle: the innermost event (an operator, a
runtime call or a span) of the thread that runs the window, else of any
thread, else "host: none".
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["WINDOW_SPAN", "TraceSummary", "capture", "summarize"]

WINDOW_SPAN = "perfbench.window"
TOP = 10
NAME_CHARS = 120


class TraceSummary:
    def __init__(self, window_s: float, busy_s: float,
                 kernels: Dict[str, Tuple[float, int]],
                 idle_gaps: List[Tuple[str, float]]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels          # device op name -> (seconds, count)
        self.idle_gaps = idle_gaps      # (host activity, seconds), longest first

    def kernel_seconds(self, substrings: Sequence[str]) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        any of `substrings`."""
        s = n = 0
        for name, (sec, count) in self.kernels.items():
            if any(k in name for k in substrings):
                s += sec
                n += count
        return s, n

    def device_ops(self) -> List[List[object]]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [[name[:NAME_CHARS], sec] for name, (sec, _n) in top]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(),
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:TOP]]}


def capture(fn: Callable[[], object]):
    """(fn's result, TraceSummary) of one fn() under torch.profiler.  The
    profiler idles half a second before the window: it can miss the
    first kernels launched through ctypes right after it starts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    sync()
    with profile(activities=activities) as prof:
        time.sleep(0.5)
        sync()
        with record_function(WINDOW_SPAN):
            result = fn()
            sync()
    return result, summarize(prof.events())


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted disjoint intervals covering the [start, end] rows."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def summarize(events) -> TraceSummary:
    from torch.autograd import DeviceType

    window = next((e for e in events if e.name == WINDOW_SPAN), None)
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window.time_range.start, window.time_range.end
    spans = {e.name for e in events if e.device_type != DeviceType.CUDA
             and getattr(e, "is_user_annotation", False)}
    dev, kernels = [], defaultdict(lambda: [0.0, 0])
    cpu = []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in spans:
                continue
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                kernels[e.name][0] += (t - s) * 1e-6
                kernels[e.name][1] += 1
        elif e.name != WINDOW_SPAN and t > w0 and s < w1:
            cpu.append((s, t, e.thread == window.thread, e.name))
    busy = _union(np.asarray(dev, dtype=np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return TraceSummary((w1 - w0) * 1e-6, busy_s,
                        {k: (v[0], v[1]) for k, v in kernels.items()},
                        _name_gaps(gaps, cpu))


def _name_gaps(gaps: np.ndarray, cpu: list, most: int = 400
               ) -> List[Tuple[str, float]]:
    """The idle seconds by host activity, most first, over the `most`
    longest gaps (shorter gaps are launch latency between kernels)."""
    if len(gaps) == 0:
        return []
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:most]
    if cpu:
        starts = np.array([c[0] for c in cpu], dtype=np.float64)
        ends = np.array([c[1] for c in cpu], dtype=np.float64)
        main = np.array([c[2] for c in cpu])
        length = ends - starts
    by_name: Dict[str, float] = defaultdict(float)
    for s, t in longest:
        name = "host: none"
        if cpu:
            mid = 0.5 * (s + t)
            cover = (starts <= mid) & (ends >= mid)
            for pick in (cover & main, cover):
                if pick.any():
                    i = np.flatnonzero(pick)[np.argmin(length[pick])]
                    name = cpu[i][3]
                    break
        by_name[name[:NAME_CHARS]] += (t - s) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])
