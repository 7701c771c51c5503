"""Speech, anomaly detection, translation, form recognizer, Bing search.

Reference: cognitive/SpeechToText.scala (131 LoC), AnomalyDetection.scala
(249 LoC), TextTranslator.scala (406 LoC), FormRecognizer.scala (353 LoC),
BingImageSearch.scala (309 LoC).

A copy of the JAX package's `cognitive/services.py` for this package.
"""
from __future__ import annotations

import json
from typing import Dict, List
from urllib.parse import urlencode

from ..core.params import Param, ServiceParam, TypeConverters
from ..core.registry import register_stage
from ..core.schema import Table
from ..io.http.schema import HTTPRequestData
from .base import BasicAsyncReply, CognitiveServicesBase
from .vision import HasImageInput

__all__ = [
    "SpeechToText",
    "DetectLastAnomaly",
    "DetectAnomalies",
    "SimpleDetectAnomalies",
    "Translate",
    "Detect",
    "BreakSentence",
    "Transliterate",
    "DictionaryLookup",
    "DictionaryExamples",
    "AnalyzeLayout",
    "AnalyzeInvoices",
    "AnalyzeReceipts",
    "AnalyzeBusinessCards",
    "AnalyzeIDDocuments",
    "AnalyzeCustomModel",
    "GetCustomModel",
    "ListCustomModels",
    "DocumentTranslator",
    "BingImageSearch",
]


@register_stage
class SpeechToText(CognitiveServicesBase):
    """REST speech recognition (SpeechToText.scala — the SDK streaming
    variant is host-side audio plumbing with the same output schema)."""

    _domain = "stt.speech.microsoft.com"
    _path = "/speech/recognition/conversation/cognitiveservices/v1"
    audio_col = Param("column of audio bytes (wav)", default="audio")
    language = ServiceParam("recognition language", default="en-US")
    format = Param("simple|detailed", default="simple")

    def _prepare_url(self, table, i):
        q = urlencode({"language": self.resolve("language", table, i),
                       "format": self.format})
        return f"{self._base_url()}?{q}"

    def _headers(self, table, i):
        h = super()._headers(table, i)
        h["Content-Type"] = "audio/wav; codecs=audio/pcm; samplerate=16000"
        return h

    def _prepare_entity(self, table, i):
        a = table[self.audio_col][i]
        return bytes(a) if a is not None else None


class _AnomalyBase(CognitiveServicesBase):
    """Series payload from columns of timestamps+values
    (AnomalyDetection.scala)."""

    timestamps_col = Param("column of per-row timestamp lists", default="timestamps")
    values_col = Param("column of per-row value lists", default="values")
    granularity = ServiceParam("series granularity", default="daily")
    sensitivity = ServiceParam("sensitivity 0-99", default=None)

    def _prepare_entity(self, table, i):
        ts = table[self.timestamps_col][i]
        vals = table[self.values_col][i]
        if ts is None or vals is None:
            return None
        series = [{"timestamp": str(t), "value": float(v)}
                  for t, v in zip(ts, vals)]
        body = {"series": series,
                "granularity": self.resolve("granularity", table, i)}
        sens = self.resolve("sensitivity", table, i)
        if sens is not None:
            body["sensitivity"] = int(sens)
        return json.dumps(body).encode()


@register_stage
class DetectLastAnomaly(_AnomalyBase):
    _path = "/anomalydetector/v1.0/timeseries/last/detect"


@register_stage
class DetectAnomalies(_AnomalyBase):
    _path = "/anomalydetector/v1.0/timeseries/entire/detect"


@register_stage
class SimpleDetectAnomalies(CognitiveServicesBase):
    """Row-wise anomaly detection with grouping (AnomalyDetection.scala:249
    SimpleDetectAnomalies): rows carry (timestamp, value, group); each group
    becomes ONE entire-series request sorted by timestamp, and the per-point
    verdict joins back onto its row."""

    _path = "/anomalydetector/v1.0/timeseries/entire/detect"
    timestamp_col = Param("per-row timestamp column", default="timestamp")
    value_col = Param("per-row value column", default="value")
    group_col = Param("series grouping column", default="group")
    granularity = ServiceParam("series granularity", default="daily")
    sensitivity = ServiceParam("sensitivity 0-99", default=None)

    def _prepare_entity(self, table, i):  # driven by the grouped _transform
        raise NotImplementedError

    @staticmethod
    def _ts_key(v):
        """Chronological sort key: numerics numerically, ISO-8601 via
        datetime parsing (lexicographic order misorders epoch ints and
        non-zero-padded dates; the service 400s on unsorted series)."""
        import datetime as _dt

        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return (0, float(v), "")
        s = str(v)
        try:
            return (0, float(s), "")
        except ValueError:
            pass
        try:
            return (0, _dt.datetime.fromisoformat(
                s.replace("Z", "+00:00")).timestamp(), "")
        except ValueError:
            return (1, 0.0, s)

    def _transform(self, table: Table) -> Table:
        import math

        import numpy as np

        n = len(table)
        groups = table[self.group_col]
        ts = table[self.timestamp_col]
        vals = table[self.value_col]
        skipped = np.zeros(n, bool)
        order_of: Dict[object, List[int]] = {}
        for i in range(n):
            v = vals[i]
            # base-class contract: a null row is skipped (null output), not
            # a crash — and it must not poison its whole group's series
            if ts[i] is None or v is None or (
                    isinstance(v, float) and math.isnan(v)):
                skipped[i] = True
                continue
            order_of.setdefault(groups[i], []).append(i)

        reqs, row_maps = [], []
        for g, rows in order_of.items():
            rows = sorted(rows, key=lambda r: self._ts_key(ts[r]))
            series = [{"timestamp": str(ts[r]), "value": float(vals[r])}
                      for r in rows]
            body = {"series": series,
                    "granularity": self.resolve("granularity", table, rows[0])}
            sens = self.resolve("sensitivity", table, rows[0])
            if sens is not None:
                body["sensitivity"] = int(sens)
            reqs.append(HTTPRequestData(
                url=self._prepare_url(table, rows[0]), method="POST",
                headers=self._headers(table, rows[0]),
                entity=json.dumps(body).encode()))
            row_maps.append(rows)

        resps = self._client().send_all(reqs)
        out = np.empty(n, dtype=object)
        errs = np.empty(n, dtype=object)
        errs[:] = None
        for rows, resp in zip(row_maps, resps):
            if resp is None or not resp.ok:
                msg = None if resp is None else f"{resp.status_code} {resp.reason}"
                for r in rows:
                    errs[r] = msg
                continue
            payload = self._postprocess(resp) or {}
            for k, r in enumerate(rows):
                out[r] = {key: (v[k] if isinstance(v, list) and k < len(v)
                                else v)
                          for key, v in payload.items()}
        result = table.with_column(self.output_col, out)
        if self.error_col:
            result = result.with_column(self.error_col, errs)
        return result


class _TranslatorBase(CognitiveServicesBase):
    _domain = "cognitive.microsofttranslator.com"
    text_col = Param("input text column", default="text")

    def _base_url(self) -> str:
        if self.url:
            return self.url
        return f"https://api.{self._domain}{self._path}"

    def _prepare_entity(self, table, i):
        t = table[self.text_col][i]
        return None if t is None else json.dumps([{"Text": str(t)}]).encode()


@register_stage
class Translate(_TranslatorBase):
    _path = "/translate"
    to_language = ServiceParam("target language(s), comma-joined", default="en")

    def _prepare_url(self, table, i):
        to = str(self.resolve("to_language", table, i))
        q = [("api-version", "3.0")] + [("to", x) for x in to.split(",")]
        return f"{self._base_url()}?{urlencode(q)}"


@register_stage
class Detect(_TranslatorBase):
    _path = "/detect"

    def _prepare_url(self, table, i):
        return f"{self._base_url()}?api-version=3.0"


@register_stage
class BreakSentence(_TranslatorBase):
    _path = "/breaksentence"

    def _prepare_url(self, table, i):
        return f"{self._base_url()}?api-version=3.0"


@register_stage
class DictionaryLookup(_TranslatorBase):
    """Alternative translations for a word/phrase (TextTranslator.scala
    DictionaryLookup)."""

    _path = "/dictionary/lookup"
    from_language = ServiceParam("source language", default="en")
    to_language = ServiceParam("target language", default="es")

    def _prepare_url(self, table, i):
        q = urlencode({"api-version": "3.0",
                       "from": self.resolve("from_language", table, i),
                       "to": self.resolve("to_language", table, i)})
        return f"{self._base_url()}?{q}"


@register_stage
class DictionaryExamples(_TranslatorBase):
    """Usage examples for a (text, translation) pair (TextTranslator.scala
    DictionaryExamples); the input column holds (text, translation) pairs."""

    _path = "/dictionary/examples"
    text_and_translation_col = Param(
        "column of (text, translation) pairs", default="textAndTranslation")
    from_language = ServiceParam("source language", default="en")
    to_language = ServiceParam("target language", default="es")

    def _prepare_url(self, table, i):
        q = urlencode({"api-version": "3.0",
                       "from": self.resolve("from_language", table, i),
                       "to": self.resolve("to_language", table, i)})
        return f"{self._base_url()}?{q}"

    def _prepare_entity(self, table, i):
        v = table[self.text_and_translation_col][i]
        if v is None:
            return None
        text, translation = v
        return json.dumps(
            [{"Text": str(text), "Translation": str(translation)}]).encode()


@register_stage
class Transliterate(_TranslatorBase):
    _path = "/transliterate"
    language = ServiceParam("source language", default="ja")
    from_script = ServiceParam("source script", default="Jpan")
    to_script = ServiceParam("target script", default="Latn")

    def _prepare_url(self, table, i):
        q = urlencode({
            "api-version": "3.0",
            "language": self.resolve("language", table, i),
            "fromScript": self.resolve("from_script", table, i),
            "toScript": self.resolve("to_script", table, i),
        })
        return f"{self._base_url()}?{q}"


class _FormRecognizerBase(HasImageInput, BasicAsyncReply):
    """Async layout/invoice analysis (FormRecognizer.scala); URL-mode bodies
    use the form-recognizer 'source' field."""

    _url_key = "source"


class _HasModelsBase:
    """Shared custom-models endpoint construction (normalized trailing /)."""

    def _models_base(self) -> str:
        base = self.url or (f"https://{self.location}.{self._domain}"
                            "/formrecognizer/v2.1/custom/models")
        return base.rstrip("/")


@register_stage
class AnalyzeLayout(_FormRecognizerBase):
    _path = "/formrecognizer/v2.1/layout/analyze"


@register_stage
class AnalyzeInvoices(_FormRecognizerBase):
    _path = "/formrecognizer/v2.1/prebuilt/invoice/analyze"


@register_stage
class AnalyzeReceipts(_FormRecognizerBase):
    """FormRecognizer.scala AnalyzeReceipts."""

    _path = "/formrecognizer/v2.1/prebuilt/receipt/analyze"


@register_stage
class AnalyzeBusinessCards(_FormRecognizerBase):
    """FormRecognizer.scala AnalyzeBusinessCards."""

    _path = "/formrecognizer/v2.1/prebuilt/businessCard/analyze"


@register_stage
class AnalyzeIDDocuments(_FormRecognizerBase):
    """FormRecognizer.scala AnalyzeIDDocuments."""

    _path = "/formrecognizer/v2.1/prebuilt/idDocument/analyze"


@register_stage
class AnalyzeCustomModel(_HasModelsBase, _FormRecognizerBase):
    """Analysis against a trained custom model (FormRecognizer.scala
    AnalyzeCustomModel): the model id routes the request."""

    model_id = ServiceParam("trained custom model id", default=None)

    def _prepare_url(self, table, i):
        mid = self.resolve("model_id", table, i)
        if not mid:
            raise ValueError("AnalyzeCustomModel requires model_id")
        return f"{self._models_base()}/{mid}/analyze"


@register_stage
class GetCustomModel(_HasModelsBase, CognitiveServicesBase):
    """Fetch one custom model's metadata (FormRecognizer.scala
    GetCustomModel): a GET per row, keyed by the model-id value-or-column."""

    model_id = ServiceParam("custom model id", default=None)
    include_keys = Param("include extracted keys", default=False,
                         converter=TypeConverters.to_bool)

    def _prepare_method(self):
        return "GET"

    def _prepare_entity(self, table, i):
        return b""  # GET: non-None marks the row active

    def _prepare_url(self, table, i):
        mid = self.resolve("model_id", table, i)
        if not mid:
            raise ValueError("GetCustomModel requires model_id")
        url = f"{self._models_base()}/{mid}"
        return url + ("?includeKeys=true" if self.include_keys else "")


@register_stage
class ListCustomModels(_HasModelsBase, CognitiveServicesBase):
    """List the resource's custom models (FormRecognizer.scala
    ListCustomModels); `op` selects full vs summary listings."""

    op = Param("full|summary", default="full")

    def _prepare_method(self):
        return "GET"

    def _prepare_entity(self, table, i):
        return b""

    def _prepare_url(self, table, i):
        return f"{self._models_base()}?{urlencode({'op': self.op})}"


@register_stage
class DocumentTranslator(BasicAsyncReply):
    """Batch document translation: POST a batches spec, poll the operation
    (reference cognitive/DocumentTranslator.scala, 151 LoC)."""

    _path = "/translator/text/batch/v1.0/batches"
    service_name = Param("translator resource name", default="")
    inputs_col = Param("column of batch-input dicts "
                       "(sourceUrl/targets per the service spec)",
                       default="batches")

    def _base_url(self) -> str:
        if self.url:
            return self.url
        return (f"https://{self.service_name}.cognitiveservices.azure.com"
                f"{self._path}")

    def _prepare_entity(self, table, i):
        v = table[self.inputs_col][i]
        return None if v is None else json.dumps({"inputs": v}).encode()


@register_stage
class BingImageSearch(CognitiveServicesBase):
    """Bing image search (BingImageSearch.scala): GET with query params."""

    _domain = "api.bing.microsoft.com"
    _path = "/v7.0/images/search"
    query_col = Param("search query column", default="query")
    count = Param("results per query", default=10,
                  converter=TypeConverters.to_int)
    offset_col = Param("optional per-row offset column", default="")

    def _base_url(self) -> str:
        return self.url or f"https://{self._domain}{self._path}"

    def _prepare_method(self):
        return "GET"

    def _prepare_entity(self, table, i):
        q = table[self.query_col][i]
        return b"" if q is not None else None

    def _prepare_url(self, table, i):
        params = {"q": str(table[self.query_col][i]),
                  "count": int(self.count)}
        if self.offset_col:
            params["offset"] = int(table[self.offset_col][i])
        return f"{self._base_url()}?{urlencode(params)}"

    @staticmethod
    def get_urls(table: Table, output_col: str = "output",
                 url_col: str = "imageUrl") -> Table:
        """Flatten contentUrls out of search responses
        (BingImageSearch.getUrlTransformer)."""
        import numpy as np

        urls = []
        for r in table[output_col]:
            for v in (r or {}).get("value", []):
                if "contentUrl" in v:
                    urls.append(v["contentUrl"])
        arr = np.empty(len(urls), dtype=object)
        for i, u in enumerate(urls):
            arr[i] = u
        return Table({url_col: arr})
