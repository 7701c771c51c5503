"""Named lock construction.

A copy of the JAX package's `utils/sync.py` for this package, without its
sanitizer hook: concurrency-bearing modules (core/flow.py, io/feed.py,
io/pipeline.py, serving/batcher.py, serving/server.py) build their locks
through `make_lock("layer.component")` / `make_rlock(...)` so each lock
carries the name of what it guards.
"""
from __future__ import annotations

import threading

__all__ = ["make_lock", "make_rlock"]


def make_lock(name: str) -> "threading.Lock":
    """A plain `threading.Lock()`; `name` documents what it guards."""
    del name
    return threading.Lock()


def make_rlock(name: str) -> "threading.RLock":
    """A plain `threading.RLock()`; `name` documents what it guards."""
    del name
    return threading.RLock()
