"""HTTP-on-tables: the request/response schema the serving layer holds.

A part of the JAX package's `io/http`; its clients and HTTP transformer
stages are not ported yet (ROADMAP A15).
"""
from .schema import HTTPRequestData, HTTPResponseData, to_http_request

__all__ = ["HTTPRequestData", "HTTPResponseData", "to_http_request"]
