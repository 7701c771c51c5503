"""HTTP request/response as typed row values.

Reference: core io/http/HTTPSchema.scala:36-348 — full HTTP request/response
StructTypes with SparkBindings codecs (`HTTPRequestData`, `HTTPResponseData`,
entity/headers/status) and the `to_http_request` SQL helpers.

Here the codecs are dataclasses <-> plain dicts; Table columns hold the
dataclass instances (object columns), mirroring the reference's struct rows.
A copy of the JAX package's `io/http/schema.py` for this package.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = ["HTTPRequestData", "HTTPResponseData", "to_http_request"]


@dataclass
class HTTPRequestData:
    url: str
    method: str = "POST"
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None

    def to_dict(self) -> dict:
        return {
            "url": self.url,
            "method": self.method,
            "headers": dict(self.headers),
            "entity": self.entity.decode("utf-8", "replace")
            if self.entity is not None else None,
        }

    @staticmethod
    def from_dict(d: dict) -> "HTTPRequestData":
        e = d.get("entity")
        return HTTPRequestData(
            url=d["url"], method=d.get("method", "POST"),
            headers=dict(d.get("headers") or {}),
            entity=e.encode() if isinstance(e, str) else e,
        )


@dataclass
class HTTPResponseData:
    status_code: int
    reason: str = ""
    headers: Dict[str, str] = field(default_factory=dict)
    entity: Optional[bytes] = None

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300

    def json(self) -> Any:
        return json.loads(self.entity or b"null")

    def text(self) -> str:
        return (self.entity or b"").decode("utf-8", "replace")

    def to_dict(self) -> dict:
        return {
            "status_code": self.status_code,
            "reason": self.reason,
            "headers": dict(self.headers),
            "entity": self.entity.decode("utf-8", "replace")
            if self.entity is not None else None,
        }


def to_http_request(url: str, payload: Any, method: str = "POST",
                    headers: Optional[Dict[str, str]] = None) -> HTTPRequestData:
    """JSON-encode a payload into a request row (HTTPSchema.scala
    to_http_request analog)."""
    hdrs = {"Content-Type": "application/json"}
    if headers:
        hdrs.update(headers)
    return HTTPRequestData(
        url=url, method=method, headers=hdrs,
        entity=json.dumps(payload).encode("utf-8"),
    )
