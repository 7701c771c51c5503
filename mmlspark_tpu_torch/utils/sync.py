"""Named lock construction.

A copy of the JAX package's `utils/sync.py` for this package, without its
sanitizer hook: concurrency-bearing modules (core/flow.py, io/feed.py,
io/pipeline.py) build their locks through `make_lock("layer.component")`
so each lock carries the name of what it guards.
"""
from __future__ import annotations

import threading

__all__ = ["make_lock"]


def make_lock(name: str) -> "threading.Lock":
    """A plain `threading.Lock()`; `name` documents what it guards."""
    del name
    return threading.Lock()
