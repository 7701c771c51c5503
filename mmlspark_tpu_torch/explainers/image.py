"""Image LIME / KernelSHAP via superpixel masking.

Reference: explainers/ImageLIME.scala:38 (superpixel bernoulli masks x
numSamples), explainers/ImageSHAP.scala (coalitions over superpixels), legacy
lime/ImageLIME.scala.  Masked samples are built as `image * lut[labels]`
(superpixel.masked_image) so the whole perturbation batch feeds the wrapped
model (e.g. ImageFeaturizer -> full SURVEY §3.1 stack) in one batched call.

A copy of the JAX package's `explainers/image.py` for this package.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.params import Param, TypeConverters
from ..core.registry import register_stage
from ..core.schema import Table
from .base import KernelSHAPBase, LIMEBase, pad_ragged_states
from .superpixel import masked_image, segments_for_image

__all__ = ["ImageLIME", "ImageSHAP"]


class _ImageSamplerMixin:
    input_col = Param("image column (H,W,C arrays)", default="image")
    superpixel_col = Param(
        "precomputed superpixel label-map column (optional)", default=None
    )
    cell_size = Param("approx superpixel cell size (px)", default=16.0,
                      converter=TypeConverters.to_float)
    modifier = Param("SLIC compactness modifier", default=130.0,
                     converter=TypeConverters.to_float)
    background = Param("fill value for dropped superpixels", default=0.0,
                       converter=TypeConverters.to_float)

    def _segments(self, table: Table) -> List[np.ndarray]:
        sp_col = self.get_or_default("superpixel_col")
        if sp_col:
            return [np.asarray(v) for v in table[sp_col]]
        return [
            segments_for_image(img, float(self.cell_size), float(self.modifier))
            for img in table[self.input_col]
        ]

    def _emit(self, table: Table, states_per_row: List[np.ndarray],
              segments: List[np.ndarray]) -> Table:
        """states_per_row[i]: (s, k_i) binary.  Masked images stacked into the
        samples table; ragged k_i padded in the caller's design matrix."""
        n = len(table)
        s = states_per_row[0].shape[0]
        imgs = table[self.input_col]
        bg = float(self.background)
        sample_imgs = np.empty(n * s, dtype=object)
        for i in range(n):
            img = np.asarray(imgs[i])
            labels = segments[i]
            for j in range(s):
                sample_imgs[i * s + j] = masked_image(
                    img, labels, states_per_row[i][j], background=bg
                )
        out = table.take(np.repeat(np.arange(n), s))
        return out.with_column(self.input_col, sample_imgs)


@register_stage
class ImageLIME(LIMEBase, _ImageSamplerMixin):
    """LIME over superpixels: bernoulli keep-masks, exponential kernel on the
    fraction of dropped superpixels (reference ImageLIME.scala:38)."""

    sampling_fraction = Param("P(keep superpixel)", default=0.7,
                              converter=TypeConverters.to_float)

    def _build_samples(self, table: Table):
        rng = np.random.default_rng(int(self.seed))
        segments = self._segments(table)
        self._num_segments = [int(seg.max()) + 1 for seg in segments]
        self._true_dims = self._num_segments
        s = int(self.num_samples)
        p = float(self.sampling_fraction)
        states = []
        for k in self._num_segments:
            st = (rng.random((s, k)) < p).astype(np.float32)
            st[0] = 1.0  # unmasked instance
            states.append(st)
        samples = self._emit(table, states, segments)
        return samples, pad_ragged_states(states)


@register_stage
class ImageSHAP(KernelSHAPBase, _ImageSamplerMixin):
    """KernelSHAP over superpixels (reference ImageSHAP.scala)."""

    def _build_samples(self, table: Table):
        rng = np.random.default_rng(int(self.seed))
        segments = self._segments(table)
        self._num_segments = [int(seg.max()) + 1 for seg in segments]
        self._true_dims = self._num_segments
        states = [self._coalitions(k, rng) for k in self._num_segments]
        samples = self._emit(table, states, segments)
        return samples, pad_ragged_states(states)
