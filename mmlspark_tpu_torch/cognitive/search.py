"""AzureSearchWriter: index creation + batched document push with backoff.

Reference: cognitive/AzureSearch.scala (348 LoC) + AzureSearchAPI.scala
(199 LoC) — ensure the index exists, then POST documents in batches; on
throttling/partial failure split the batch and retry with exponential
backoff.

A copy of the JAX package's `cognitive/search.py` for this package.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.schema import Table
from ..io.http.clients import send_request
from ..io.http.schema import HTTPRequestData

__all__ = ["AzureSearchWriter"]


class AzureSearchWriter:
    API_VERSION = "2019-05-06"

    def __init__(self, service_name: str = "", index_name: str = "",
                 key: str = "", index_definition: Optional[dict] = None,
                 batch_size: int = 100, base_url: Optional[str] = None,
                 max_retries: int = 4):
        self.index_name = index_name or (index_definition or {}).get("name", "")
        self.key = key
        self.index_definition = index_definition
        self.batch_size = int(batch_size)
        self.max_retries = int(max_retries)
        self.base_url = (base_url or
                         f"https://{service_name}.search.windows.net")

    def _headers(self) -> Dict[str, str]:
        return {"Content-Type": "application/json", "api-key": self.key}

    def ensure_index(self) -> bool:
        """Create the index if a definition was given (createIndexIfNotExists,
        AzureSearchAPI.scala)."""
        if not self.index_definition:
            return True
        url = (f"{self.base_url}/indexes/{self.index_name}"
               f"?api-version={self.API_VERSION}")
        resp = send_request(HTTPRequestData(
            url=url, method="PUT", headers=self._headers(),
            entity=json.dumps(self.index_definition).encode(),
        ))
        return resp.ok or resp.status_code == 409  # already exists

    def _push(self, docs: List[dict]) -> int:
        url = (f"{self.base_url}/indexes/{self.index_name}/docs/index"
               f"?api-version={self.API_VERSION}")
        resp = send_request(HTTPRequestData(
            url=url, method="POST", headers=self._headers(),
            entity=json.dumps({"value": docs}).encode(),
        ))
        return resp.status_code

    def write(self, table: Table, action: str = "upload") -> int:
        """Push every row as a document; returns documents written.

        Batches split + exponential backoff on 207/429/503 (the reference's
        retryWithBackoff over batch bisection)."""
        if not self.ensure_index():
            raise RuntimeError("index creation failed")
        docs = []
        for row in table.rows():
            doc = {}
            for k, v in row.items():
                if isinstance(v, np.ndarray):
                    v = v.tolist()
                elif isinstance(v, np.generic):
                    v = v.item()
                doc[k] = v
            doc["@search.action"] = action
            docs.append(doc)

        written = 0
        stack: List[tuple] = [(docs[i: i + self.batch_size], 0)
                              for i in range(0, len(docs), self.batch_size)]
        while stack:
            batch, attempt = stack.pop()
            if not batch:
                continue
            status = self._push(batch)
            if status in (200, 201):
                written += len(batch)
            elif status in (207, 429, 503) and attempt < self.max_retries:
                time.sleep(0.05 * (2 ** attempt))
                if len(batch) > 1:
                    mid = len(batch) // 2
                    stack.append((batch[:mid], attempt + 1))
                    stack.append((batch[mid:], attempt + 1))
                else:
                    stack.append((batch, attempt + 1))
            else:
                raise RuntimeError(
                    f"azure search push failed with status {status}"
                )
        return written
