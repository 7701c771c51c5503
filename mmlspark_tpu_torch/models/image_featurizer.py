"""ImageFeaturizer: transfer-learning featurization on the card.

Counterpart of the JAX package's `models/image_featurizer.py`.
Reference: deep-learning/.../ImageFeaturizer.scala:40-197 — picks the
output node as `layerNames(cutOutputLayers)`, auto-resizes inputs to the
model's input shape, drops NA rows, delegates to CNTKModel.  Here the
host decodes, and per shape group the device runs the fused
resize+normalize kernel and the backbone forward (ImagePreprocess +
TorchModel), fed as uint8.

The JAX package's JPEG-bytes fast path (native libjpeg decode into chunk
buffers) is not ported yet: a mostly-JPEG bytes column raises
NotImplementedError.  Image rows and uint8 arrays take the general path.
The JAX package's `use_pallas` Param has no counterpart: every CUDA
batch goes through the kernel, every CPU batch through its plain version.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table, find_unused_column_name
from ..device import resolve_device
from ..io.image import decode_cells, image_row_to_array
from .bundle import TorchBundle
from .torch_model import ImagePreprocess, TorchModel

__all__ = ["ImageFeaturizer", "IMAGENET_MEAN_BGR", "IMAGENET_STD_BGR"]

# ImageNet BGR mean/std in 0-255 scale (images arrive BGR uint8)
IMAGENET_MEAN_BGR = [103.53, 116.28, 123.675]
IMAGENET_STD_BGR = [57.375, 57.12, 58.395]


@register_stage
class ImageFeaturizer(Transformer):
    bundle = ComplexParam("TorchBundle backbone", default=None)
    model_name = Param("zoo model name (used when bundle unset)", default="resnet50")
    input_col = Param("image column (image rows or arrays)", default="image")
    output_col = Param("feature column", default="features")
    cut_output_layers = Param(
        "how many output layers to cut: 0 = logits, 1 = pooled features "
        "(ImageFeaturizer.scala cutOutputLayers)",
        default=1, converter=TypeConverters.to_int)
    drop_na = Param("drop undecodable rows", default=True, converter=TypeConverters.to_bool)
    batch_size = Param("device minibatch size", default=64, converter=TypeConverters.to_int)
    normalize = Param("apply ImageNet mean/std normalization", default=True,
                      converter=TypeConverters.to_bool)
    pad_to_batch = Param(
        "pad every device chunk to the full batch_size (one chunk shape "
        "forever — the serving setting; see TorchModel.pad_to_batch)",
        default=False, converter=TypeConverters.to_bool)
    feed_depth = Param(
        "host->device pipeline depth (chunks in flight; see "
        "TorchModel.feed_depth)",
        default=2, converter=TypeConverters.to_int)
    device = Param("'cuda' (default) or 'cpu'; without CUDA only an explicit "
                   "'cpu' runs", default=None)

    def __init__(self, bundle: Optional[TorchBundle] = None, **kw):
        super().__init__(**kw)
        if bundle is not None:
            self.set(bundle=bundle)

    def _get_bundle(self) -> TorchBundle:
        b = self.bundle
        if b is None:
            from .zoo import get_or_create_resnet

            b = get_or_create_resnet(self.model_name)
            self.set(bundle=b)
        return b

    def _model_for(self, bundle: TorchBundle, input_col: str) -> TorchModel:
        h, w, _c = bundle.input_shape
        pre = ImagePreprocess(
            h, w,
            mean=IMAGENET_MEAN_BGR if self.normalize else None,
            std=IMAGENET_STD_BGR if self.normalize else None,
        )
        return TorchModel(
            bundle=bundle,
            input_col=input_col,
            output_col=self.output_col,
            fetch_node=bundle.layer_names[self.cut_output_layers],
            batch_size=self.batch_size,
            preprocess=pre,
            group_by_shape=True,
            feed_dtype="uint8",
            pad_to_batch=self.pad_to_batch,
            feed_depth=self.feed_depth,
            device=self.device,
        )

    def _transform(self, table: Table) -> Table:
        resolve_device(self.device)  # fail before any decode work
        bundle = self._get_bundle()
        if bundle.input_shape is None:
            raise ValueError("ImageFeaturizer: bundle must declare input_shape")
        h, w, _c = bundle.input_shape

        col = table[self.input_col]
        if len(col) and all(v is None or isinstance(v, (bytes, bytearray))
                            for v in col):
            n_jpeg = sum(1 for v in col
                         if v is not None and bytes(v[:3]) == b"\xff\xd8\xff")
            n_other = sum(1 for v in col if v is not None) - n_jpeg
            if n_jpeg and n_jpeg >= n_other:
                # where the JAX package takes its native JPEG fast path
                raise NotImplementedError(
                    "ImageFeaturizer: mostly-JPEG bytes columns (the native "
                    "decode fast path) are not ported yet; decode to image "
                    "rows or uint8 arrays")
        # general path: host decodes, then per shape group the device runs
        # the channel fix, the fused resize+normalize kernel and the
        # backbone forward, fed as uint8 (ImagePreprocess + TorchModel)
        cells = decode_cells(col)
        keep = np.array([c is not None for c in cells])
        if self.drop_na:
            table = table.filter(keep)
            cells = [c for c in cells if c is not None]
        elif not keep.all():
            raise ValueError("ImageFeaturizer: undecodable rows and drop_na=False")

        arrays = [image_row_to_array(r) for r in cells]
        tmp_feed = find_unused_column_name("__feed__", table.column_names)
        feed = table.with_column(
            tmp_feed, arrays if arrays else np.zeros((0, h, w, _c), np.uint8))
        model = self._model_for(bundle, tmp_feed)
        out = model.transform(feed)
        return out.drop(tmp_feed)

    def transform_schema(self, columns: List[str]) -> List[str]:
        if self.input_col not in columns:
            raise ValueError(f"ImageFeaturizer: missing input column '{self.input_col}'")
        return columns + [self.output_col]
