"""Cognitive service base: config-driven HTTP transformer stages.

Reference: cognitive/CognitiveServiceBase.scala:29-322 — `ServiceParam`
scalar-or-column params, URL/entity preparation, subscription-key header,
`getInternalTransformer` = Lambda -> SimpleHTTPTransformer -> DropColumns;
plus BasicAsyncReply (ComputerVision.scala) — async polling on the
Operation-Location header until status succeeded/failed.

A copy of the JAX package's `cognitive/base.py` for this package.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.params import Param, ServiceParam, TypeConverters
from ..core.pipeline import Transformer
from ..core.schema import Table
from ..io.http.clients import (AsyncHTTPClient, CircuitBreaker,
                               HandlingUtils, get_breaker, get_shared_client)
from ..io.http.schema import HTTPRequestData, HTTPResponseData

__all__ = ["CognitiveServicesBase", "BasicAsyncReply"]


class CognitiveServicesBase(Transformer):
    """One service = one subclass declaring `_path` + payload preparation.

    Every service accepts constant params or per-row columns (ServiceParam),
    posts JSON (or binary) to `url`, and emits parsed JSON + an error column.
    """

    subscription_key = ServiceParam("service API key", default=None)
    url = Param("full endpoint URL (overrides location routing)", default="")
    location = Param("azure region used to build the default URL",
                     default="eastus")
    output_col = Param("parsed response column", default="output")
    error_col = Param("error column", default="errors")
    concurrency = Param("max in-flight requests", default=4,
                        converter=TypeConverters.to_int)
    timeout = Param("per-request timeout (s)", default=60.0,
                    converter=TypeConverters.to_float)
    breaker_threshold = Param(
        "circuit breaker: consecutive retryable failures before the "
        "endpoint's shared circuit opens (0 disables — the default)",
        default=0, converter=TypeConverters.to_int)
    breaker_reset_s = Param(
        "circuit breaker: seconds an open circuit waits before admitting "
        "a half-open probe", default=30.0,
        converter=TypeConverters.to_float)

    _path = ""  # subclass: service URL path
    _domain = "api.cognitive.microsoft.com"

    def _base_url(self) -> str:
        if self.url:
            return self.url
        return f"https://{self.location}.{self._domain}{self._path}"

    # ---- subclass surface -------------------------------------------------
    def _prepare_entity(self, table: Table, i: int) -> Optional[bytes]:
        """JSON body for row i (None -> skip the row: null output)."""
        raise NotImplementedError

    def _prepare_url(self, table: Table, i: int) -> str:
        return self._base_url()

    def _prepare_method(self) -> str:
        return "POST"

    def _headers(self, table: Table, i: int) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        key = self.resolve("subscription_key", table, i)
        if key:
            h["Ocp-Apim-Subscription-Key"] = str(key)
        return h

    def _postprocess(self, resp: HTTPResponseData) -> Any:
        try:
            return resp.json()
        except (ValueError, json.JSONDecodeError):
            return None

    # ---- driver -----------------------------------------------------------
    def _client(self) -> AsyncHTTPClient:
        return get_shared_client(int(self.concurrency), float(self.timeout))

    def _breaker(self) -> Optional[CircuitBreaker]:
        """Per-HOST shared breaker (all stages hitting the same endpoint
        pool their failure budget), or None when disabled."""
        if int(self.breaker_threshold) <= 0:
            return None
        from urllib.parse import urlsplit

        host = urlsplit(self._base_url()).netloc or self._base_url()
        return get_breaker(host, int(self.breaker_threshold),
                           float(self.breaker_reset_s))

    def _transform(self, table: Table) -> Table:
        n = len(table)
        reqs: List[Optional[HTTPRequestData]] = []
        for i in range(n):
            entity = self._prepare_entity(table, i)
            if entity is None:
                reqs.append(None)
                continue
            reqs.append(HTTPRequestData(
                url=self._prepare_url(table, i),
                method=self._prepare_method(),
                headers=self._headers(table, i),
                entity=entity,
            ))
        client = self._client()
        resps = client.send_all(reqs, breaker=self._breaker())
        # post-handling (e.g. async-operation polling) runs through the same
        # bounded pool: rows poll concurrently, not one-after-another
        resps = list(client._pool.map(
            lambda pair: self._handle_response(pair[1], table, pair[0]),
            enumerate(resps),
        ))
        out = np.empty(n, dtype=object)
        errs = np.empty(n, dtype=object)
        for i, r in enumerate(resps):
            if r is None:
                out[i] = None
                errs[i] = None
            elif r.ok:
                out[i] = self._postprocess(r)
                errs[i] = None
            else:
                out[i] = None
                errs[i] = f"{r.status_code} {r.reason}"
        result = table.with_column(self.output_col, out)
        if self.error_col:
            result = result.with_column(self.error_col, errs)
        return result

    def _handle_response(self, resp, table, i):
        return resp


class BasicAsyncReply(CognitiveServicesBase):
    """Async-operation services: the first POST returns 202 + an
    Operation-Location URL polled until success (ComputerVision.scala
    BasicAsyncReply)."""

    polling_interval_ms = Param("poll interval", default=300,
                                converter=TypeConverters.to_int)
    max_polls = Param("max polls before giving up", default=100,
                      converter=TypeConverters.to_int)

    def _handle_response(self, resp, table, i):
        if resp is None or resp.status_code not in (200, 201, 202):
            return resp
        loc = resp.headers.get("Operation-Location") or resp.headers.get(
            "operation-location"
        )
        if not loc:
            return resp
        poll_req = HTTPRequestData(url=loc, method="GET",
                                   headers=self._headers(table, i))
        breaker = self._breaker()
        for attempt in range(int(self.max_polls)):
            if attempt:  # first status check is immediate
                time.sleep(float(self.polling_interval_ms) / 1000.0)
            poll = HandlingUtils.advanced(poll_req, timeout=float(self.timeout),
                                          breaker=breaker)
            if not poll.ok:
                return poll
            try:
                status = str(poll.json().get("status", "")).lower()
            except (ValueError, json.JSONDecodeError):
                return poll
            if status in ("succeeded", "failed", "partiallycompleted",
                          "cancelled", "validationfailed"):
                return poll
        return HTTPResponseData(408, "async operation polling exhausted")
