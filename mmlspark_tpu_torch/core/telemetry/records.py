"""Usage telemetry: every stage verb logs a structured JSON record.

A copy of the JAX package's `core/telemetry/records.py` for this package.
Reference: core logging/BasicLogging.scala:25-71 — logClass/logFit/
logTransform emit `{uid, className, method, buildVersion}`.  Here: a
process-local ring buffer + stdlib logging, cheap enough to stay
always-on, with wall-time capture.

The ring is a `deque(maxlen=4096)` guarded by a lock: `recent_records()`
snapshots and `clear_records()` must not interleave with a concurrent
append mid-iteration, so all three paths take `_RECORDS_LOCK`.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import threading
import time
from typing import Any, Deque, Dict

from ... import version

__all__ = ["log_verb", "recent_records", "clear_records", "RECORDS_MAXLEN",
           "logger"]

logger = logging.getLogger("mmlspark_tpu_torch.telemetry")

RECORDS_MAXLEN = 4096

_RECORDS: Deque[Dict[str, Any]] = collections.deque(maxlen=RECORDS_MAXLEN)
_RECORDS_LOCK = threading.Lock()


def recent_records():
    with _RECORDS_LOCK:
        return list(_RECORDS)


def clear_records():
    with _RECORDS_LOCK:
        _RECORDS.clear()


@contextlib.contextmanager
def log_verb(stage, method: str, **extra):
    """Extra keyword fields are merged into the record verbatim (callers
    pass JSON-safe values); they never override the core fields."""
    t0 = time.perf_counter()
    err = None
    try:
        yield
    except Exception as e:  # noqa: BLE001 — record then re-raise
        err = type(e).__name__
        raise
    finally:
        rec = dict(extra)
        rec.update({
            "uid": getattr(stage, "uid", "?"),
            "className": type(stage).__name__,
            "method": method,
            "buildVersion": version.__version__,
            "wallTimeSec": round(time.perf_counter() - t0, 6),
        })
        if err:
            rec["error"] = err
        with _RECORDS_LOCK:
            _RECORDS.append(rec)
        logger.debug("%s", json.dumps(rec))
