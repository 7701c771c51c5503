"""Generic retry with timeout / exponential backoff, and the load-shedding
error.

A copy of `retry_with_timeout`, `retry_with_backoff` and `Overloaded`
from the JAX package's `utils/fault_tolerance.py` for this package (the
model zoo's sha-verified load retries through the second; the batcher's
bounded intake raises the third).  Reference:
core/utils/FaultToleranceUtils.scala:9 and the retry idioms in
io/http/HTTPClients.scala:74-121.
"""
from __future__ import annotations

import concurrent.futures
import random
from typing import Callable, Optional, Tuple, Type, TypeVar

from .faults import sleep as _clock_sleep

T = TypeVar("T")

__all__ = ["retry_with_timeout", "retry_with_backoff", "Overloaded"]


class Overloaded(RuntimeError):
    """Raised by bounded intake paths (ContinuousBatcher.submit) when load
    shedding rejects a request; the serving layer maps it to 503 +
    Retry-After."""


def retry_with_timeout(fn: Callable[[], T], timeout_sec: float,
                       retries: int = 3,
                       retryable: Tuple[Type[BaseException], ...] = (Exception,),
                       ) -> T:
    """Run `fn` with a wall-clock timeout, retrying on failure/timeout.

    The timeout is enforced at the caller: on expiry the attempt is abandoned
    (its daemon thread may still run to completion in the background — Python
    cannot kill threads) and the next retry starts immediately.  Only safe for
    idempotent operations, same as the reference's retryWithTimeout.

    Timeouts always retry; other exceptions retry only when they match
    `retryable` (everything else propagates immediately, like the sibling
    retry_with_backoff).
    """
    if retries < 1:
        # a bare `raise last` with last=None was a TypeError here; make the
        # contract explicit instead
        raise ValueError(f"retries must be >= 1, got {retries}")
    last: Optional[BaseException] = None
    for _ in range(retries):
        ex = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="retry_with_timeout"
        )
        fut = ex.submit(fn)
        try:
            return fut.result(timeout=timeout_sec)
        except concurrent.futures.TimeoutError as e:
            last = e
        except retryable as e:
            last = e
        finally:
            ex.shutdown(wait=False)
    assert last is not None
    raise last


def retry_with_backoff(
    fn: Callable[[], T],
    retries: int = 5,
    initial_delay_sec: float = 0.1,
    max_delay_sec: float = 30.0,
    backoff: float = 2.0,
    retryable: Tuple[Type[BaseException], ...] = (Exception,),
    jitter: bool = True,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    rng: Optional[random.Random] = None,
) -> T:
    """Exponential backoff with full jitter.

    `jitter=True` draws each sleep uniformly from [0, delay] (the AWS
    "full jitter" scheme) so a thundering herd of failed clients doesn't
    re-synchronize on the retry schedule; pass `rng` for a deterministic
    draw in tests.  `on_retry(attempt, exc, sleep_s)` is called before
    each sleep — the hook used for retry telemetry and test probes.
    """
    if retries < 1:
        raise ValueError(f"retries must be >= 1, got {retries}")
    draw = (rng or random).uniform
    delay = initial_delay_sec
    last: Optional[BaseException] = None
    for attempt in range(retries):
        try:
            return fn()
        except retryable as e:
            last = e
            if attempt == retries - 1:
                break
            sleep_s = draw(0.0, delay) if jitter else delay
            if on_retry is not None:
                on_retry(attempt, e, sleep_s)
            # through the injectable clock (utils/faults.py): chaos tests
            # swap in a VirtualClock so backoff ladders cost no wall time
            _clock_sleep(sleep_s)
            delay = min(delay * backoff, max_delay_sec)
    assert last is not None
    raise last
