"""Text plumbing stages: trie-based mapping + unicode normalization.

Reference: core stages/TextPreprocessor.scala:17 (Trie + TextPreprocessor),
stages/UnicodeNormalize.scala.  A copy of the JAX package's
`stages/text.py` for this package.
"""
from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table

__all__ = ["Trie", "TextPreprocessor", "UnicodeNormalize"]


class Trie:
    """Longest-match string-mapping trie (TextPreprocessor.scala:17)."""

    def __init__(self, mapping: Optional[Dict[str, str]] = None):
        self.children: Dict[str, "Trie"] = {}
        self.value: Optional[str] = None
        for k, v in (mapping or {}).items():
            self.put(k, v)

    def put(self, key: str, value: str) -> None:
        node = self
        for ch in key:
            node = node.children.setdefault(ch, Trie())
        node.value = value

    def map_text(self, text: str) -> str:
        out: List[str] = []
        i = 0
        n = len(text)
        while i < n:
            node = self
            best_val, best_len = None, 0
            j = i
            while j < n and text[j] in node.children:
                node = node.children[text[j]]
                j += 1
                if node.value is not None:
                    best_val, best_len = node.value, j - i
            if best_val is not None:
                out.append(best_val)
                i += best_len
            else:
                out.append(text[i])
                i += 1
        return "".join(out)


@register_stage
class TextPreprocessor(Transformer):
    input_col = Param("input text column")
    output_col = Param("output text column")
    map = ComplexParam("substring -> replacement dict")
    normalize_func = Param("optional: lower|upper|NFC|NFKC", default=None)

    def _transform(self, table: Table) -> Table:
        trie = Trie(self.map or {})
        norm = self.normalize_func
        out = []
        for s in table[self.input_col]:
            s = str(s)
            if norm in ("NFC", "NFKC", "NFD", "NFKD"):
                s = unicodedata.normalize(norm, s)
            elif norm == "lower":
                s = s.lower()
            elif norm == "upper":
                s = s.upper()
            out.append(trie.map_text(s))
        return table.with_column(self.output_col, out)


@register_stage
class UnicodeNormalize(Transformer):
    input_col = Param("input text column")
    output_col = Param("output text column")
    form = Param("NFC|NFD|NFKC|NFKD", default="NFKD")
    lower = Param("casefold output", default=True, converter=TypeConverters.to_bool)

    def _transform(self, table: Table) -> Table:
        out = []
        for s in table[self.input_col]:
            s = unicodedata.normalize(self.form, str(s))
            out.append(s.lower() if self.lower else s)
        return table.with_column(self.output_col, out)
