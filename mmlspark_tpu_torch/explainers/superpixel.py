"""SLIC-style superpixel clustering + SuperpixelTransformer stage.

Reference: core lime/Superpixel.scala:148-334 (SLIC-like region growing used by
ImageLIME/ImageSHAP), lime/SuperpixelTransformer.scala.

A copy of the JAX package's `explainers/superpixel.py` for this package:
host numpy, label maps equal element for element.

Output representation is a dense (H, W) int32 label map per row — a
mask basis: masking a sample is `image * mask_lut[labels]` (vs. the
reference's per-cluster pixel lists walked on the JVM heap).
"""
from __future__ import annotations

import numpy as np

from ..core.params import Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.registry import register_stage
from ..core.schema import Table, find_unused_column_name

__all__ = ["slic_segments", "segments_for_image", "SuperpixelTransformer",
           "masked_image"]


def slic_segments(
    image: np.ndarray,
    n_segments: int = 50,
    compactness: float = 10.0,
    iters: int = 10,
) -> np.ndarray:
    """SLIC superpixels: localized k-means in (color, xy) space.

    image: (H, W, C) float or uint8.  Returns (H, W) int32 labels in
    [0, n_clusters).  Distance D^2 = d_color^2 + (d_xy / S)^2 * m^2 with grid
    interval S and compactness m, searched over 2S x 2S windows.
    """
    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    H, W, C = img.shape
    S = max(int(np.sqrt(H * W / max(n_segments, 1))), 1)

    ys = np.arange(S // 2, H, S)
    xs = np.arange(S // 2, W, S)
    centers = np.array([[y, x] for y in ys for x in xs], dtype=np.float32)
    k = len(centers)
    center_color = img[centers[:, 0].astype(int), centers[:, 1].astype(int)]

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    labels = np.zeros((H, W), np.int32)
    dist = np.full((H, W), np.inf, np.float32)
    m2_s2 = (compactness / S) ** 2

    for _ in range(iters):
        dist[:] = np.inf
        for ci in range(k):
            cy, cx = centers[ci]
            y0, y1 = max(int(cy) - S, 0), min(int(cy) + S + 1, H)
            x0, x1 = max(int(cx) - S, 0), min(int(cx) + S + 1, W)
            patch = img[y0:y1, x0:x1]
            dc = np.sum((patch - center_color[ci]) ** 2, axis=-1)
            ds = (yy[y0:y1, x0:x1] - cy) ** 2 + (xx[y0:y1, x0:x1] - cx) ** 2
            d = dc + ds * m2_s2
            win = dist[y0:y1, x0:x1]
            better = d < win
            win[better] = d[better]
            labels[y0:y1, x0:x1][better] = ci
        # update centers
        for ci in range(k):
            mask = labels == ci
            if not mask.any():
                continue
            centers[ci] = (yy[mask].mean(), xx[mask].mean())
            center_color[ci] = img[mask].mean(axis=0)

    # compact label ids (drop empty clusters)
    uniq, relabeled = np.unique(labels, return_inverse=True)
    return relabeled.reshape(H, W).astype(np.int32)


def masked_image(
    image: np.ndarray,
    labels: np.ndarray,
    keep: np.ndarray,
    background: float = 0.0,
) -> np.ndarray:
    """Apply a superpixel on/off vector: pixels of dropped clusters -> background."""
    lut = np.asarray(keep, dtype=np.float32)
    mask = lut[labels]  # (H, W)
    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 3:
        mask = mask[:, :, None]
    return img * mask + background * (1.0 - mask)


def segments_for_image(image: np.ndarray, cell_size: float,
                       modifier: float) -> np.ndarray:
    """The one cell_size/modifier -> SLIC argument mapping, shared by
    SuperpixelTransformer and the image explainers."""
    img = np.asarray(image)
    n_seg = max((img.shape[0] * img.shape[1]) // int(cell_size) ** 2, 4)
    return slic_segments(img, n_segments=n_seg, compactness=modifier / 10.0)


@register_stage
class SuperpixelTransformer(Transformer):
    """Adds a (H, W) superpixel label-map column for an image column.

    Reference: lime/SuperpixelTransformer.scala.
    """

    input_col = Param("image column", default="image")
    output_col = Param("superpixel label-map column", default=None)
    cell_size = Param("approx superpixel cell size (px)", default=16.0,
                      converter=TypeConverters.to_float)
    modifier = Param("compactness modifier", default=130.0,
                     converter=TypeConverters.to_float)

    def __init__(self, **kw):
        super().__init__(**kw)

    def _out_col(self, table: Table) -> str:
        return self.get_or_default("output_col") or find_unused_column_name(
            "superpixels", table.column_names
        )

    def _transform(self, table: Table) -> Table:
        col = table[self.input_col]
        out = np.empty(len(table), dtype=object)
        for i in range(len(table)):
            out[i] = segments_for_image(col[i], float(self.cell_size),
                                        float(self.modifier))
        return table.with_column(self._out_col(table), out)
