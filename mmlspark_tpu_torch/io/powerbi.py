"""PowerBIWriter: batched row push to a PowerBI streaming-dataset REST URL.

Reference: io/powerbi/PowerBIWriter.scala:27 (batched POST of row groups
through the HTTP retry stack).

A copy of the JAX package's `io/powerbi.py` for this package.
"""
from __future__ import annotations

import json
import numpy as np

from ..core.schema import Table
from .http.clients import HandlingUtils
from .http.schema import HTTPRequestData

__all__ = ["write_to_power_bi"]


def write_to_power_bi(table: Table, url: str, batch_size: int = 100,
                      timeout: float = 60.0) -> int:
    """POST rows as JSON arrays in batches; returns rows written.

    Raises RuntimeError on a non-retryable failure (after the standard
    backoff policy, incl. 429 Retry-After handling).
    """
    def jsonable(v):
        if isinstance(v, np.ndarray):
            v = v.tolist()
        if isinstance(v, (list, tuple)):
            return [jsonable(x) for x in v]
        if isinstance(v, dict):
            return {k: jsonable(x) for k, x in v.items()}
        if isinstance(v, np.generic):
            v = v.item()
        # bare NaN/Infinity are invalid JSON — the endpoint would 400
        if isinstance(v, float) and not np.isfinite(v):
            return None
        return v

    rows = []
    for row in table.rows():
        rows.append({k: jsonable(v) for k, v in row.items()})
    written = 0
    for lo in range(0, len(rows), batch_size):
        batch = rows[lo: lo + batch_size]
        resp = HandlingUtils.advanced(HTTPRequestData(
            url=url, method="POST",
            headers={"Content-Type": "application/json"},
            entity=json.dumps(batch).encode(),
        ), timeout=timeout)
        if not resp.ok:
            raise RuntimeError(
                f"PowerBI push failed at batch {lo // batch_size}: "
                f"{resp.status_code} {resp.reason}"
            )
        written += len(batch)
    return written
