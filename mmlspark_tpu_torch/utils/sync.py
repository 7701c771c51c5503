"""Named lock construction, hookable by a runtime sanitizer.

A copy of the JAX package's `utils/sync.py` for this package:
concurrency-bearing modules (core/flow.py, io/feed.py, io/pipeline.py,
serving/batcher.py, serving/server.py, parallel/distributed.py) build
their locks through `make_lock("layer.component")` /
`make_rlock(...)`.  With nothing installed this is a zero-cost alias —
the returned object IS a `threading.Lock`/`RLock` — but a sanitizer that
installs a factory pair (`set_lock_factory`) gets instrumented locks
that carry the given name, so its race and lock-order reports name
`serving.batcher.submit` instead of an anonymous lock.
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = ["make_lock", "make_rlock", "set_lock_factory", "lock_factory"]

# (lock_factory, rlock_factory) installed by a sanitizer; None = the
# zero-cost default path.  Plain attribute read + None check per
# *construction* (not per acquire), so the disabled path costs nothing
# on lock operations at all.
_FACTORY: Optional[tuple] = None


def set_lock_factory(factory: Optional[tuple]) -> None:
    """Install `(lock_factory, rlock_factory)` callables taking a
    `name=` kwarg, or None to restore the plain threading path."""
    global _FACTORY
    _FACTORY = factory


def make_lock(name: str) -> "threading.Lock":
    """A mutex named for sanitizer reports; plain `threading.Lock()`
    unless a sanitizer factory is installed."""
    f = _FACTORY
    if f is not None:
        return f[0](name=name)
    return threading.Lock()


def make_rlock(name: str) -> "threading.RLock":
    """A reentrant mutex named for sanitizer reports; plain
    `threading.RLock()` unless a sanitizer factory is installed."""
    f = _FACTORY
    if f is not None:
        return f[1](name=name)
    return threading.RLock()


def lock_factory() -> Optional[tuple]:
    """The currently installed factory pair (None when disabled) — a
    sanitizer's own idempotence check reads this."""
    return _FACTORY
