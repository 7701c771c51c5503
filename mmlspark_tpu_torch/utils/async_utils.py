"""Bounded-concurrency parallel map with ordered results.

Reference: core/utils/AsyncUtils.scala:10 and io/http/Clients.scala:48-120
(AsyncClient): a sliding window of in-flight Futures whose results are
yielded in input order.  A copy of the JAX package's
`utils/async_utils.py` for this package.
"""
from __future__ import annotations

import collections
import concurrent.futures
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def bounded_parallel_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    concurrency: int = 8,
) -> Iterator[R]:
    """Apply `fn` to items with at most `concurrency` in flight; yield results
    in input order as they become available."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=concurrency) as ex:
        window: "collections.deque" = collections.deque()
        it = iter(items)
        try:
            for _ in range(concurrency):
                window.append(ex.submit(fn, next(it)))
        except StopIteration:
            pass
        while window:
            yield window.popleft().result()
            try:
                window.append(ex.submit(fn, next(it)))
            except StopIteration:
                continue
