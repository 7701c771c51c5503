"""Computer Vision + Face services.

Reference: cognitive/ComputerVision.scala (573 LoC: OCR, AnalyzeImage,
ReadImage w/ async polling, GenerateThumbnails, TagImage, DescribeImage,
RecognizeDomainSpecificContent) and Face.scala (351 LoC).

A copy of the JAX package's `cognitive/vision.py` for this package.
"""
from __future__ import annotations

import json
from typing import Dict, Optional
from urllib.parse import urlencode

from ..core.params import Param, ServiceParam, TypeConverters
from ..core.registry import register_stage
from ..core.schema import Table
from .base import BasicAsyncReply, CognitiveServicesBase

__all__ = [
    "HasImageInput",
    "OCR",
    "AnalyzeImage",
    "ReadImage",
    "GenerateThumbnails",
    "TagImage",
    "DescribeImage",
    "RecognizeDomainSpecificContent",
    "DetectFace",
    "FindSimilarFace",
    "GroupFaces",
    "IdentifyFaces",
    "VerifyFaces",
]


class HasImageInput:
    """image url-or-bytes duality (ComputerVision.scala HasImageInput).
    `_url_key` is the JSON field for URL mode ('url' for vision/face,
    'source' for form recognizer)."""

    image_url_col = Param("column of image URLs", default="")
    image_bytes_col = Param("column of raw image bytes", default="")
    _url_key = "url"

    def _prepare_entity(self, table: Table, i: int) -> Optional[bytes]:
        if self.image_url_col:
            u = table[self.image_url_col][i]
            if u is None:
                return None
            return json.dumps({self._url_key: str(u)}).encode()
        data = table[self.image_bytes_col][i]
        return bytes(data) if data is not None else None

    def _headers(self, table: Table, i: int) -> Dict[str, str]:
        h = super()._headers(table, i)
        if not self.image_url_col:
            h["Content-Type"] = "application/octet-stream"
        return h


@register_stage
class OCR(HasImageInput, CognitiveServicesBase):
    _path = "/vision/v2.0/ocr"
    detect_orientation = Param("detect text orientation", default=True,
                               converter=TypeConverters.to_bool)

    def _prepare_url(self, table, i):
        q = urlencode({"detectOrientation": str(bool(self.detect_orientation)).lower()})
        return f"{self._base_url()}?{q}"


@register_stage
class AnalyzeImage(HasImageInput, CognitiveServicesBase):
    _path = "/vision/v2.0/analyze"
    visual_features = Param("comma-joined feature list",
                            default="Categories,Tags,Description")

    def _prepare_url(self, table, i):
        return f"{self._base_url()}?{urlencode({'visualFeatures': self.visual_features})}"


@register_stage
class ReadImage(HasImageInput, BasicAsyncReply):
    """Async read API (ComputerVision.scala ReadImage + BasicAsyncReply)."""

    _path = "/vision/v3.1/read/analyze"


@register_stage
class GenerateThumbnails(HasImageInput, CognitiveServicesBase):
    _path = "/vision/v2.0/generateThumbnail"
    width = Param("thumb width", default=32, converter=TypeConverters.to_int)
    height = Param("thumb height", default=32, converter=TypeConverters.to_int)
    smart_cropping = Param("smart crop", default=True,
                           converter=TypeConverters.to_bool)

    def _prepare_url(self, table, i):
        q = urlencode({"width": int(self.width), "height": int(self.height),
                       "smartCropping": str(bool(self.smart_cropping)).lower()})
        return f"{self._base_url()}?{q}"

    def _postprocess(self, resp):
        return resp.entity  # binary thumbnail


@register_stage
class TagImage(HasImageInput, CognitiveServicesBase):
    _path = "/vision/v2.0/tag"


@register_stage
class DescribeImage(HasImageInput, CognitiveServicesBase):
    _path = "/vision/v2.0/describe"
    max_candidates = Param("caption candidates", default=1,
                           converter=TypeConverters.to_int)

    def _prepare_url(self, table, i):
        return f"{self._base_url()}?{urlencode({'maxCandidates': int(self.max_candidates)})}"


@register_stage
class RecognizeDomainSpecificContent(HasImageInput, CognitiveServicesBase):
    model = Param("domain model (celebrities|landmarks)", default="celebrities")

    def _prepare_url(self, table, i):
        base = self.url or (
            f"https://{self.location}.{self._domain}"
            f"/vision/v2.0/models/{self.model}/analyze"
        )
        return base


# ------------------------------------------------------------------- Face
@register_stage
class DetectFace(HasImageInput, CognitiveServicesBase):
    _path = "/face/v1.0/detect"
    return_face_attributes = Param("comma-joined attribute list", default="")

    def _prepare_url(self, table, i):
        q = {"returnFaceId": "true"}
        if self.return_face_attributes:
            q["returnFaceAttributes"] = self.return_face_attributes
        return f"{self._base_url()}?{urlencode(q)}"


class _JsonBodyService(CognitiveServicesBase):
    """Services whose body is built from ServiceParam columns."""

    _body_params: tuple = ()

    def _prepare_entity(self, table: Table, i: int) -> Optional[bytes]:
        body = {}
        for name, key in self._body_params:
            v = self.resolve(name, table, i)
            if v is not None:
                if hasattr(v, "tolist"):
                    v = v.tolist()
                body[key] = v
        return json.dumps(body).encode()


@register_stage
class FindSimilarFace(_JsonBodyService):
    _path = "/face/v1.0/findsimilars"
    face_id = ServiceParam("query face id", default=None)
    face_ids = ServiceParam("candidate face ids", default=None)
    _body_params = (("face_id", "faceId"), ("face_ids", "faceIds"))


@register_stage
class GroupFaces(_JsonBodyService):
    _path = "/face/v1.0/group"
    face_ids = ServiceParam("face ids to cluster", default=None)
    _body_params = (("face_ids", "faceIds"),)


@register_stage
class IdentifyFaces(_JsonBodyService):
    _path = "/face/v1.0/identify"
    face_ids = ServiceParam("face ids", default=None)
    person_group_id = ServiceParam("person group", default=None)
    _body_params = (("face_ids", "faceIds"),
                    ("person_group_id", "personGroupId"))


@register_stage
class VerifyFaces(_JsonBodyService):
    _path = "/face/v1.0/verify"
    face_id1 = ServiceParam("first face id", default=None)
    face_id2 = ServiceParam("second face id", default=None)
    _body_params = (("face_id1", "faceId1"), ("face_id2", "faceId2"))
