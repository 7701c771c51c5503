"""The benchmark's own spans around the program's layers, for the traced
window only: each wrapped call runs inside a `record_function` of the
given name, so the trace's idle gaps name the layer the host was in.
They wrap the call and change nothing it does; `undo()` restores the
originals.  (Spans inside the program itself are a later change.)"""
from __future__ import annotations

import functools
from typing import Callable, List

__all__ = ["Spans"]


def _timed(fn: Callable, name, generator: bool) -> Callable:
    """`fn` inside a span; `name` is a string, or a function of the
    call's arguments that gives it."""
    from torch.profiler import record_function

    def span(a, k):
        return record_function(name(*a, **k) if callable(name) else name)

    if generator:
        @functools.wraps(fn)
        def gen(*a, **k):
            with span(a, k):
                yield from fn(*a, **k)
        return gen

    @functools.wraps(fn)
    def call(*a, **k):
        with span(a, k):
            return fn(*a, **k)
    return call


class Spans:
    def __init__(self):
        self._undo: List[Callable[[], None]] = []

    def wrap(self, owner, attr: str, name, generator: bool = False) -> None:
        """Wrap `owner.attr` (a module's function, or a class's method,
        static method or class method)."""
        raw = owner.__dict__[attr]
        if isinstance(raw, classmethod):
            new = classmethod(_timed(raw.__func__, name, generator))
        elif isinstance(raw, staticmethod):
            new = staticmethod(_timed(raw.__func__, name, generator))
        else:
            new = _timed(raw, name, generator)
        setattr(owner, attr, new)
        self._undo.append(lambda: setattr(owner, attr, raw))

    def undo(self) -> None:
        while self._undo:
            self._undo.pop()()
