"""ImageFeaturizer: transfer-learning featurization on the card.

Counterpart of the JAX package's `models/image_featurizer.py`.
Reference: deep-learning/.../ImageFeaturizer.scala:40-197 — picks the
output node as `layerNames(cutOutputLayers)`, auto-resizes inputs to the
model's input shape, drops NA rows, delegates to CNTKModel.  Here the
host decodes, and per shape group the device runs the fused
resize+normalize kernel and the backbone forward (ImagePreprocess +
TorchModel), fed as uint8.  Any bundle with image taps serves as the
backbone: a ResNet, or a ViT, whose attention runs the flash-attention
kernel on the card; the output node is the bundle's
`layer_names[cut_output_layers]`, taken from its module.

A mostly-JPEG bytes column takes the JAX package's fast path where the
port's native decoder builds (`mmlspark_tpu_torch.native`): header-only
shape probe, shape groups, each row decoded straight into its chunk
buffer on the HostPipeline workers.  Image rows, uint8 arrays, other
codecs and machines without a decoder take the general path.  The JAX
package's `use_pallas` Param has no counterpart: every CUDA batch goes
through the kernel, every CPU batch through its plain version.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table, find_unused_column_name
from ..device import resolve_device
from ..io.image import decode_cells, image_row_to_array, safe_read
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
    input_col = Param("image column (image rows or encoded bytes)",
                      default="image")
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

        # Fast path for mostly-JPEG encoded-bytes columns: native JPEG decode
        # straight into chunk buffers on the HostPipeline workers,
        # overlapped with the device forward — the host never materializes
        # per-image arrays or re-stacks them.  Columns dominated by other
        # codecs keep the general path (thread-pooled PIL decode).
        col = table[self.input_col]
        if len(col) and all(v is None or isinstance(v, (bytes, bytearray))
                            for v in col):
            from .. import native

            n_jpeg = sum(1 for v in col
                         if v is not None and bytes(v[:3]) == b"\xff\xd8\xff")
            n_other = sum(1 for v in col if v is not None) - n_jpeg
            if n_jpeg and n_jpeg >= n_other and native.jpeg_available():
                return self._transform_bytes_streaming(table, bundle)
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

    def _transform_bytes_streaming(self, table: Table,
                                   bundle: TorchBundle) -> Table:
        """JPEG-bytes fast path: header-only shape probe -> shape groups ->
        native decode straight into [bs, H, W, C] chunk buffers on the
        HostPipeline workers -> the device feed (TorchModel.run_grouped).
        The full ImageFeaturizer.scala:137-184 stack with no intermediate
        host copies."""
        from .. import native

        col = table[self.input_col]
        n = len(col)
        shapes: List[Any] = [None] * n
        decoded: dict = {}  # idx -> ndarray for non-JPEG (PIL-decoded) rows
        others: List[int] = []  # PNG/BMP/corrupt-header rows
        for i, v in enumerate(col):
            if v is None:
                continue
            b = bytes(v)
            if b[:3] == b"\xff\xd8\xff":
                shapes[i] = native.jpeg_probe(b)
            if shapes[i] is None:
                others.append(i)
        if others:  # tolerant decode of the non-JPEG minority, thread-pooled
            for i, row in zip(others,
                              decode_cells(np.asarray(
                                  [col[i] for i in others], dtype=object))):
                if row is not None:
                    arr = image_row_to_array(row)
                    decoded[i] = arr
                    shapes[i] = arr.shape

        groups: "dict[tuple, List[int]]" = {}
        for i, s in enumerate(shapes):
            if s is not None:
                groups.setdefault(tuple(s), []).append(i)

        if not self.drop_na and any(s is None for s in shapes):
            # fail before any decode/compute, like the general path does
            raise ValueError(
                "ImageFeaturizer: undecodable rows and drop_na=False")

        device = resolve_device(self.device)
        model = self._model_for(bundle, self.input_col)
        _module, forward = model._executor(
            bundle, model._fetch_name(bundle), device)
        # `failed` is appended by the decode workers (list.append is
        # atomic) and read only after run_grouped returns
        failed: List[int] = []  # rows whose pixel decode failed every way

        def build_chunk(shape, sel):
            gh, gw, gc = shape
            buf = np.zeros((len(sel), gh, gw, gc), np.uint8)
            for j, i in enumerate(sel):
                if i in decoded:
                    buf[j] = decoded[i]
                elif not native.decode_jpeg_bgr_into(bytes(col[i]), buf[j]):
                    # the native decoder rejected it (CMYK/YCCK,
                    # truncation): PIL fallback like decode_image before
                    # dropping
                    row = safe_read(bytes(col[i]))
                    arr = (image_row_to_array(row)
                           if row is not None else None)
                    if arr is not None and arr.shape == (gh, gw, gc):
                        buf[j] = arr
                    else:
                        failed.append(i)
            return buf

        feed_order, out_rows = model.run_grouped(
            groups, build_chunk, forward, device)
        results: List[Any] = [None] * n
        for i, y in zip(feed_order, out_rows):
            results[i] = np.asarray(y).reshape(-1)

        bad = {i for i, s in enumerate(shapes) if s is None} | set(failed)
        if bad:
            if not self.drop_na:
                raise ValueError(
                    f"ImageFeaturizer: {len(bad)} undecodable rows and "
                    "drop_na=False")
            keep = np.array([i not in bad for i in range(n)])
            table = table.filter(keep)
            results = [r for i, r in enumerate(results) if i not in bad]
        out = (np.stack(results) if results
               else np.zeros((0,), np.float32))  # same empty shape as TorchModel
        return table.with_column(self.output_col, out)

    def transform_schema(self, columns: List[str]) -> List[str]:
        if self.input_col not in columns:
            raise ValueError(f"ImageFeaturizer: missing input column '{self.input_col}'")
        return columns + [self.output_col]
