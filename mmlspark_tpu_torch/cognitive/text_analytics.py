"""Text Analytics services (sentiment/language/entities/keyphrases/NER/PII).

Reference: cognitive/TextAnalytics.scala (320 LoC) — all services POST a
`{"documents": [{id, text, language?}]}` batch and parse per-document results.

A copy of the JAX package's `cognitive/text_analytics.py` for this package.
"""
from __future__ import annotations

import json
from typing import Optional

from ..core.params import Param, ServiceParam
from ..core.registry import register_stage
from ..core.schema import Table
from .base import CognitiveServicesBase

__all__ = [
    "TextAnalyticsBase",
    "TextSentiment",
    "LanguageDetector",
    "EntityDetector",
    "KeyPhraseExtractor",
    "NER",
    "PII",
]


class TextAnalyticsBase(CognitiveServicesBase):
    text_col = Param("input text column", default="text")
    language = ServiceParam("document language", default="en")

    def _prepare_entity(self, table: Table, i: int) -> Optional[bytes]:
        text = table[self.text_col][i]
        if text is None:
            return None
        doc = {"id": "0", "text": str(text)}
        lang = self.resolve("language", table, i)
        if lang and self._include_language:
            doc["language"] = str(lang)
        return json.dumps({"documents": [doc]}).encode("utf-8")

    _include_language = True

    def _postprocess(self, resp):
        try:
            body = resp.json()
        except (ValueError, json.JSONDecodeError):
            return None
        docs = body.get("documents") or []
        return docs[0] if docs else body


@register_stage
class TextSentiment(TextAnalyticsBase):
    _path = "/text/analytics/v3.0/sentiment"


@register_stage
class LanguageDetector(TextAnalyticsBase):
    _path = "/text/analytics/v3.0/languages"
    _include_language = False


@register_stage
class EntityDetector(TextAnalyticsBase):
    _path = "/text/analytics/v3.0/entities/linking"


@register_stage
class KeyPhraseExtractor(TextAnalyticsBase):
    _path = "/text/analytics/v3.0/keyPhrases"


@register_stage
class NER(TextAnalyticsBase):
    _path = "/text/analytics/v3.0/entities/recognition/general"


@register_stage
class PII(TextAnalyticsBase):
    _path = "/text/analytics/v3.0/entities/recognition/pii"
