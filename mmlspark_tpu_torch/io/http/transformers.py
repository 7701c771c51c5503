"""HTTP transformer stages: request columns -> async HTTP -> response columns.

Reference: core io/http/HTTPTransformer.scala:86-141 (mapPartitions +
SharedVariable client), SimpleHTTPTransformer.scala:64 (InputParser ->
HTTPTransformer -> OutputParser pipeline with optional error column), and
Parsers.scala:26-231 (JSONInputParser, CustomInputParser, JSONOutputParser,
StringOutputParser, CustomOutputParser).

A copy of the JAX package's `io/http/transformers.py` for this package:
the same stage names, Params and output columns.
"""
from __future__ import annotations

import json
import numpy as np

from ...core.params import ComplexParam, Param, TypeConverters
from ...core.pipeline import Transformer
from ...core.registry import register_stage
from ...core.schema import Table, find_unused_column_name
from .clients import AsyncHTTPClient, get_shared_client
from .schema import HTTPRequestData, HTTPResponseData

__all__ = [
    "HTTPTransformer",
    "SimpleHTTPTransformer",
    "JSONInputParser",
    "CustomInputParser",
    "JSONOutputParser",
    "StringOutputParser",
    "CustomOutputParser",
]


@register_stage
class HTTPTransformer(Transformer):
    """Column of HTTPRequestData -> column of HTTPResponseData, sent through
    the process-shared bounded-concurrency client."""

    input_col = Param("request column", default="request")
    output_col = Param("response column", default="response")
    concurrency = Param("max in-flight requests", default=8,
                        converter=TypeConverters.to_int)
    timeout = Param("per-request timeout (s)", default=60.0,
                    converter=TypeConverters.to_float)

    def _client(self) -> AsyncHTTPClient:
        return get_shared_client(int(self.concurrency), float(self.timeout))

    def _transform(self, table: Table) -> Table:
        reqs = [
            r if isinstance(r, (HTTPRequestData, type(None)))
            else HTTPRequestData.from_dict(r)
            for r in table[self.input_col]
        ]
        resps = self._client().send_all(reqs)
        out = np.empty(len(table), dtype=object)
        for i, r in enumerate(resps):
            out[i] = r
        return table.with_column(self.output_col, out)


@register_stage
class JSONInputParser(Transformer):
    """Rows -> JSON POST requests (Parsers.scala JSONInputParser)."""

    input_cols = Param("columns to serialize into the JSON body", default=None,
                       converter=TypeConverters.to_list_str)
    output_col = Param("request column", default="request")
    url = Param("target URL", default="")
    method = Param("HTTP method", default="POST")
    headers = ComplexParam("extra headers dict", default=None)

    def _transform(self, table: Table) -> Table:
        cols = self.get_or_default("input_cols") or table.column_names
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(self.get_or_default("headers") or {})
        out = np.empty(len(table), dtype=object)
        data = {c: table[c] for c in cols}
        for i in range(len(table)):
            payload = {
                c: (v.tolist() if isinstance(v := data[c][i], np.ndarray) else
                    v.item() if isinstance(v, np.generic) else v)
                for c in cols
            }
            out[i] = HTTPRequestData(
                url=self.url, method=self.method, headers=dict(hdrs),
                entity=json.dumps(payload).encode("utf-8"),
            )
        return table.with_column(self.output_col, out)


@register_stage
class CustomInputParser(Transformer):
    """row dict -> HTTPRequestData via a user function."""

    input_cols = Param("columns passed to the udf", default=None,
                       converter=TypeConverters.to_list_str)
    output_col = Param("request column", default="request")
    udf = ComplexParam("callable(row_dict) -> HTTPRequestData")

    def _transform(self, table: Table) -> Table:
        cols = self.get_or_default("input_cols") or table.column_names
        fn = self.udf
        out = np.empty(len(table), dtype=object)
        data = {c: table[c] for c in cols}
        for i in range(len(table)):
            out[i] = fn({c: data[c][i] for c in cols})
        return table.with_column(self.output_col, out)


@register_stage
class JSONOutputParser(Transformer):
    """HTTPResponseData -> parsed JSON value column (Parsers.scala
    JSONOutputParser); non-2xx or bad JSON -> None."""

    input_col = Param("response column", default="response")
    output_col = Param("parsed output column", default="output")

    def _transform(self, table: Table) -> Table:
        out = np.empty(len(table), dtype=object)
        for i, r in enumerate(table[self.input_col]):
            if isinstance(r, HTTPResponseData) and r.ok:
                try:
                    out[i] = r.json()
                except (ValueError, json.JSONDecodeError):
                    out[i] = None
            else:
                out[i] = None
        return table.with_column(self.output_col, out)


@register_stage
class StringOutputParser(Transformer):
    input_col = Param("response column", default="response")
    output_col = Param("text output column", default="output")

    def _transform(self, table: Table) -> Table:
        out = np.empty(len(table), dtype=object)
        for i, r in enumerate(table[self.input_col]):
            out[i] = r.text() if isinstance(r, HTTPResponseData) else None
        return table.with_column(self.output_col, out)


@register_stage
class CustomOutputParser(Transformer):
    input_col = Param("response column", default="response")
    output_col = Param("parsed output column", default="output")
    udf = ComplexParam("callable(HTTPResponseData) -> value")

    def _transform(self, table: Table) -> Table:
        fn = self.udf
        out = np.empty(len(table), dtype=object)
        for i, r in enumerate(table[self.input_col]):
            out[i] = fn(r) if r is not None else None
        return table.with_column(self.output_col, out)


@register_stage
class SimpleHTTPTransformer(Transformer):
    """input parser -> HTTPTransformer -> output parser, with an optional
    error column for failed exchanges (SimpleHTTPTransformer.scala:64)."""

    input_parser = ComplexParam("input parser Transformer", default=None)
    output_parser = ComplexParam("output parser Transformer", default=None)
    input_cols = Param("columns for the default JSON input parser",
                       default=None, converter=TypeConverters.to_list_str)
    output_col = Param("parsed output column", default="output")
    url = Param("target URL (default JSON parser)", default="")
    error_col = Param("error detail column ('' = raise-free null outputs)",
                      default="errors")
    concurrency = Param("max in-flight requests", default=8,
                        converter=TypeConverters.to_int)
    timeout = Param("per-request timeout (s)", default=60.0,
                    converter=TypeConverters.to_float)

    def _transform(self, table: Table) -> Table:
        req_col = find_unused_column_name("request", table.column_names)
        resp_col = find_unused_column_name("response", table.column_names)
        in_parser = self.get_or_default("input_parser") or JSONInputParser(
            input_cols=self.get_or_default("input_cols"), url=self.url,
        )
        in_parser = in_parser.copy({"output_col": req_col})
        out_parser = self.get_or_default("output_parser") or JSONOutputParser()
        out_parser = out_parser.copy(
            {"input_col": resp_col, "output_col": self.output_col}
        )
        http = HTTPTransformer(
            input_col=req_col, output_col=resp_col,
            concurrency=int(self.concurrency), timeout=float(self.timeout),
        )
        t = http.transform(in_parser.transform(table))
        result = out_parser.transform(t)
        err_col = self.error_col
        if err_col:
            errs = np.empty(len(table), dtype=object)
            for i, r in enumerate(t[resp_col]):
                if isinstance(r, HTTPResponseData) and not r.ok:
                    errs[i] = f"{r.status_code} {r.reason}"
                else:
                    errs[i] = None
            result = result.with_column(err_col, errs)
        return result.drop(req_col, resp_col)
