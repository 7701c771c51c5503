"""HTTP-on-tables: request/response schema, clients, transformer stages.

Counterpart of the JAX package's `io/http`.  Reference: core io/http
(~2.8k LoC: HTTPSchema.scala, Clients.scala, HTTPClients.scala,
HTTPTransformer.scala, SimpleHTTPTransformer.scala, Parsers.scala,
SharedVariable.scala).
"""
from .clients import AsyncHTTPClient, HandlingUtils, send_request
from .schema import HTTPRequestData, HTTPResponseData, to_http_request
from .transformers import (
    CustomInputParser,
    CustomOutputParser,
    HTTPTransformer,
    JSONInputParser,
    JSONOutputParser,
    SimpleHTTPTransformer,
    StringOutputParser,
)

__all__ = [
    "HTTPRequestData",
    "HTTPResponseData",
    "to_http_request",
    "send_request",
    "HandlingUtils",
    "AsyncHTTPClient",
    "HTTPTransformer",
    "SimpleHTTPTransformer",
    "JSONInputParser",
    "CustomInputParser",
    "JSONOutputParser",
    "StringOutputParser",
    "CustomOutputParser",
]
