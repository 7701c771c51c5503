"""Process-wide lazily-constructed singletons.

Reference: core io/http/SharedVariable.scala:18 (SharedVariable) and :37
(SharedSingleton) — one instance per executor JVM, keyed by constructor.
Here: one instance per Python process, used for HTTP clients, loaded
models, and rate-limited resources.

A copy of the JAX package's `core/shared.py` for this package.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Generic, Hashable, Optional, TypeVar

T = TypeVar("T")

_LOCK = threading.Lock()
_SINGLETONS: Dict[Hashable, Any] = {}


class SharedVariable(Generic[T]):
    """Lazily constructed, process-shared value."""

    def __init__(self, ctor: Callable[[], T], key: Optional[Hashable] = None):
        self._ctor = ctor
        self._key = key if key is not None else id(ctor)

    def get(self) -> T:
        with _LOCK:
            if self._key not in _SINGLETONS:
                _SINGLETONS[self._key] = self._ctor()
            return _SINGLETONS[self._key]

    @property
    def value(self) -> T:
        return self.get()


def shared_singleton(key: Hashable, ctor: Callable[[], T]) -> T:
    """Get-or-create a process-wide singleton by explicit key."""
    with _LOCK:
        if key not in _SINGLETONS:
            _SINGLETONS[key] = ctor()
        return _SINGLETONS[key]


def reset_singletons() -> None:
    with _LOCK:
        _SINGLETONS.clear()
