"""Image pipeline stages: the opencv-module + core/image equivalents.

Counterpart of the JAX package's `ops/image_stages.py`.  Reference:
  - ImageTransformer (opencv/.../ImageTransformer.scala:282-400): a list of
    named ops (resize/crop/colorFormat/flip/blur/threshold/gaussianKernel)
    applied per row via OpenCV Mats.
  - ResizeImageTransformer (core/image/ResizeImageTransformer.scala)
  - UnrollImage / UnrollBinaryImage (core/image/UnrollImage.scala:30-232)
  - ImageSetAugmenter (opencv/.../ImageSetAugmenter.scala)

The host decodes the column and groups the rows by shape; each group
moves to the device as uint8 in one copy and runs there as one batch:
  - `ImageTransformer` folds a separable-linear op chain into one
    AffinePlan and runs it as ONE launch of kernel B1
    (`ops.image_kernels.affine_resample`, which casts the uint8 batch
    itself); other chains run as the plain composition of
    `ops/image.py`'s ops over the f32 batch.  `fuse=None` takes the
    kernel on the card and the plain composition on the CPU;
    `fuse=True` takes the plan on either (B1's plain version on the
    CPU); `fuse=False` always the composition.
  - `UnrollImage` runs kernel B2 (`ops.image_kernels.fused_normalize_unroll`)
    over the f32 batch.
The device is each stage's `device` Param: ``cuda`` unless the caller
passes ``"cpu"`` (device.py).  uint8 output rows are clipped to [0, 255]
and truncated, as the reference's `np.clip(a, 0, 255).astype(np.uint8)`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core import telemetry as core_telemetry
from ..core.params import Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table
from ..device import resolve_device
from ..io.image import array_to_image_row, decode_cells, image_row_to_array
from . import image as I
from . import image_kernels as K

__all__ = [
    "ImageTransformer",
    "ResizeImageTransformer",
    "UnrollImage",
    "UnrollBinaryImage",
    "ImageSetAugmenter",
]

_DEVICE_DOC = ("'cuda' (default) or 'cpu'; without CUDA only an explicit "
               "'cpu' runs")


class _BatchedImageStage(Transformer):
    """Shared machinery: gather image rows -> same-shape uint8 batches on
    the device -> the stage's batch function -> scatter back (cells that
    do not decode stay None)."""

    input_col = Param("image column", default="image")
    output_col = Param("output column", default=None)
    device = Param(_DEVICE_DOC, default=None)

    def _pipeline_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        raise NotImplementedError

    def _float_output(self) -> bool:
        """When True, emit float arrays instead of uint8 image rows (e.g. a
        pipeline ending in normalize would be destroyed by uint8 clipping)."""
        return False

    def _emit(self, out_batch: torch.Tensor, src_rows: List[dict]) -> List[Any]:
        if self._float_output():
            return list(out_batch.to(torch.float32).cpu().numpy())
        # clamp + cast truncates like np.clip(a, 0, 255).astype(np.uint8)
        pixels = out_batch.clamp(0, 255).to(torch.uint8).cpu().numpy()
        return [array_to_image_row(a, origin=r.get("origin", ""))
                for a, r in zip(pixels, src_rows)]

    def _run_group(self, batch: torch.Tensor) -> torch.Tensor:
        """One same-shape uint8 batch on the device -> output batch: the
        plain op composition over its f32 cast (exact for uint8)."""
        return self._pipeline_fn()(batch.to(torch.float32))

    def _watched_group(self):
        """`_run_group` behind the compile sentry, cached per stage
        instance and current param values (a new batch shape in steady
        state is flagged as `xla.compile.hot_path.image_stages.<Stage>`)."""
        token = repr(sorted(self.simple_param_values().items()))
        cached = self.__dict__.get("_watched_run_group")
        if cached is None or cached[0] != token:
            cached = (token, core_telemetry.watch_compiles(
                self._run_group, name=f"image_stages.{type(self).__name__}"))
            self.__dict__["_watched_run_group"] = cached
        return cached[1]

    def _transform(self, table: Table) -> Table:
        device = resolve_device(self.device)
        out_col = self.output_col or self.input_col
        cells = decode_cells(table[self.input_col])
        result: List[Any] = [None] * table.num_rows
        groups: Dict[Tuple[int, int, int], List[int]] = {}
        for i, c in enumerate(cells):
            if c is not None:
                groups.setdefault(
                    (c["height"], c["width"], c["nChannels"]), []).append(i)
        for members in groups.values():
            rows = [cells[i] for i in members]
            batch = torch.from_numpy(
                np.stack([image_row_to_array(r) for r in rows])).to(device)
            out = self._watched_group()(batch)
            for r_out, i in zip(self._emit(out, rows), members):
                result[i] = r_out
        return table.with_column(out_col, result)


@register_stage
class ImageTransformer(_BatchedImageStage):
    """Op-list image preprocessing — the OpenCV ImageTransformer equivalent
    (ImageTransformer.scala:282-400).  Ops are (name, kwargs) pairs added
    fluently; a separable-linear list runs as one kernel launch per shape
    group.
    """

    stages = Param("list of [op_name, kwargs] pairs", default=None)
    fuse = Param(
        "fold the whole op list into ONE resample-kernel launch when every "
        "op is separable-linear (crop/resize/flip/blur/color/normalize): "
        "None = auto (the kernel on the card, the plain composition on "
        "the CPU), True = the plan on either device, False = always the "
        "plain composition",
        default=None)

    _OPS = {
        "resize": lambda b, height, width, method="linear": I.resize(b, height, width, method),
        "crop": lambda b, x, y, width, height: I.crop(b, x, y, width, height),
        "centerCrop": lambda b, height, width: I.center_crop(b, height, width),
        "colorFormat": lambda b, format: I.color_convert(b, format),
        "flip": lambda b, flipLeftRight=True, flipUpDown=False: I.flip(b, flipLeftRight, flipUpDown),
        "blur": lambda b, height, width: I.box_blur(b, int(height), int(width)),
        "gaussianKernel": lambda b, apertureSize, sigma: I.gaussian_blur(b, int(apertureSize), sigma),
        "threshold": lambda b, threshold, maxVal, thresholdType="binary": I.threshold(
            b, threshold, maxVal, thresholdType),
        "normalize": lambda b, mean, std, scale=1.0: I.normalize(b, mean, std, scale),
    }

    # ---- fluent builders (mirroring the reference's setter API) -------
    def _add(self, name: str, **kwargs) -> "ImageTransformer":
        ops = list(self.stages or [])
        ops.append([name, kwargs])
        self.set(stages=ops)
        return self

    def resize(self, height: int, width: int, method: str = "linear"):
        return self._add("resize", height=height, width=width, method=method)

    def crop(self, x: int, y: int, width: int, height: int):
        return self._add("crop", x=x, y=y, width=width, height=height)

    def center_crop(self, height: int, width: int):
        return self._add("centerCrop", height=height, width=width)

    def color_format(self, format: str):
        return self._add("colorFormat", format=format)

    def flip(self, flip_left_right: bool = True, flip_up_down: bool = False):
        return self._add("flip", flipLeftRight=flip_left_right, flipUpDown=flip_up_down)

    def blur(self, height: float, width: float):
        return self._add("blur", height=height, width=width)

    def gaussian_kernel(self, aperture_size: int, sigma: float):
        return self._add("gaussianKernel", apertureSize=aperture_size, sigma=sigma)

    def threshold(self, threshold: float, max_val: float, threshold_type: str = "binary"):
        return self._add("threshold", threshold=threshold, maxVal=max_val,
                         thresholdType=threshold_type)

    def normalize(self, mean, std, scale: float = 1.0):
        return self._add("normalize", mean=mean, std=std, scale=scale)

    def _float_output(self) -> bool:
        # a normalize (or sub-1 threshold) tail produces float-scale values;
        # clipping those to uint8 would zero them out
        for name, kwargs in self.stages or []:
            if name == "normalize":
                return True
            if name == "threshold" and kwargs.get("maxVal", 255) <= 1.0:
                return True
        return False

    def _pipeline_fn(self):
        ops = [(self._OPS[name], dict(kwargs)) for name, kwargs in (self.stages or [])]

        def run(batch):
            for fn, kwargs in ops:
                batch = fn(batch, **kwargs)
            return batch

        return run

    def _run_group(self, batch: torch.Tensor) -> torch.Tensor:
        fuse = self.fuse
        if fuse is None:
            fuse = batch.device.type == "cuda"
        if fuse:
            # keyed by the op list as it is now: a param mutation takes
            # another plan
            plan = K.affine_plan(K.freeze_stages(self.stages),
                                 *batch.shape[1:])
            if plan is not None:
                return K.fused_affine_apply(batch, plan)
        return super()._run_group(batch)


@register_stage
class ResizeImageTransformer(_BatchedImageStage):
    """Resize-only stage (core/image/ResizeImageTransformer.scala)."""

    height = Param("target height", converter=TypeConverters.to_int)
    width = Param("target width", converter=TypeConverters.to_int)
    method = Param("linear|nearest|cubic", default="linear")

    def _pipeline_fn(self):
        h, w, m = self.height, self.width, self.method
        return lambda b: I.resize(b, h, w, m)


@register_stage
class UnrollImage(_BatchedImageStage):
    """Image rows -> flat CHW float vector column
    (core/image/UnrollImage.scala:30-55: unsigned-byte fix + c*h*w layout).

    The unroll (+ optional per-channel normalize) is kernel B2
    (`ops.image_kernels.fused_normalize_unroll`) on the card — one read
    and one write per element."""

    input_col = Param("image column", default="image")
    output_col = Param("vector column", default="unrolled")
    mean = Param("per-channel mean to subtract", default=None,
                 converter=TypeConverters.to_list_float)
    std = Param("per-channel std to divide", default=None,
                converter=TypeConverters.to_list_float)

    def _pipeline_fn(self):
        mean = self.get_or_default("mean") or (0.0,)
        std = self.get_or_default("std") or (1.0,)
        return lambda batch: K.fused_normalize_unroll(batch, mean, std)

    def _emit(self, out_batch, src_rows):
        return [np.asarray(v, dtype=np.float64) for v in out_batch.cpu().numpy()]


@register_stage
class UnrollBinaryImage(_BatchedImageStage):
    """Raw encoded bytes -> (optional resize) -> flat CHW vector
    (UnrollImage.scala:161-232, UnrollBinaryImage)."""

    input_col = Param("binary column", default="bytes")
    output_col = Param("vector column", default="unrolled")
    height = Param("optional resize height", default=None)
    width = Param("optional resize width", default=None)

    def _pipeline_fn(self):
        h, w = self.height, self.width

        def run(batch):
            if h is not None and w is not None:
                batch = I.resize(batch, int(h), int(w))
            return I.hwc_to_chw_flat(batch)

        return run

    def _emit(self, out_batch, src_rows):
        return [np.asarray(v, dtype=np.float64) for v in out_batch.cpu().numpy()]


@register_stage
class ImageSetAugmenter(Transformer):
    """Train-time augmentation: emit original + flipped copies
    (opencv/.../ImageSetAugmenter.scala:77)."""

    input_col = Param("image column", default="image")
    output_col = Param("output column", default="image")
    flip_left_right = Param("emit LR-flipped copy", default=True,
                            converter=TypeConverters.to_bool)
    flip_up_down = Param("emit UD-flipped copy", default=False,
                         converter=TypeConverters.to_bool)
    device = Param(_DEVICE_DOC, default=None)

    def _transform(self, table: Table) -> Table:
        parts = [table.with_column(self.output_col, table[self.input_col])]
        flips = []
        if self.flip_left_right:
            flips.append((True, False))
        if self.flip_up_down:
            flips.append((False, True))
        for lr, ud in flips:
            t = ImageTransformer(input_col=self.input_col,
                                 output_col=self.output_col,
                                 device=self.device)
            t.flip(flip_left_right=lr, flip_up_down=ud)
            parts.append(t.transform(table))
        return Table.concat(parts)
