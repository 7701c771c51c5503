"""Tabular and vector LIME / KernelSHAP explainers.

Reference: explainers/TabularLIME.scala, TabularSHAP.scala, VectorLIME.scala,
VectorSHAP.scala (sampling in Sampler.scala: gaussian perturbation from
feature-wise background statistics; SHAP: coalition replacement with
background values).

A copy of the JAX package's `explainers/tabular.py` for this package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.registry import register_stage
from ..core.schema import Table, features_matrix
from .base import KernelSHAPBase, LIMEBase

__all__ = ["TabularLIME", "TabularSHAP", "VectorLIME", "VectorSHAP"]


class _TabularDataMixin:
    """Shared feature-matrix extraction + background statistics."""

    background_data = ComplexParam("background Table for sampling statistics",
                                   default=None)

    def _matrix(self, table: Table) -> np.ndarray:
        cols = self.get_or_default("input_cols")
        if cols:
            return np.stack(
                [np.asarray(table[c], np.float32) for c in cols], axis=1
            )
        return features_matrix(table[self.input_col])

    def _background_stats(self, table: Table) -> Tuple[np.ndarray, np.ndarray]:
        bg = self.get_or_default("background_data")
        mat = self._matrix(bg if bg is not None else table)
        return mat.mean(axis=0), mat.std(axis=0) + 1e-8

    def _emit_samples(self, table: Table, per_row_values: np.ndarray) -> Table:
        """Replicate table rows and overwrite the feature columns with
        per_row_values (n, s, d)."""
        n, s, d = per_row_values.shape
        idx = np.repeat(np.arange(n), s)
        out = table.take(idx)
        flat = per_row_values.reshape(n * s, d)
        cols = self.get_or_default("input_cols")
        if cols:
            for j, c in enumerate(cols):
                out = out.with_column(c, flat[:, j])
        else:
            out = out.with_column(self.input_col, flat)
        return out


@register_stage
class TabularLIME(LIMEBase, _TabularDataMixin):
    """LIME over scalar feature columns (or a single vector column).

    Samples gaussian perturbations around each instance scaled by background
    feature std; regresses raw sampled values -> model score with exponential
    kernel weights over standardized distance.
    """

    input_cols = Param("scalar feature columns", default=None,
                       converter=TypeConverters.to_list_str)
    input_col = Param("vector feature column (if input_cols unset)",
                      default="features")

    def _build_samples(self, table: Table):
        rng = np.random.default_rng(int(self.seed))
        x = self._matrix(table)  # (n, d)
        mean, std = self._background_stats(table)
        n, d = x.shape
        s = int(self.num_samples)
        noise = rng.normal(size=(n, s, d)).astype(np.float32)
        samples = x[:, None, :] + noise * std[None, None, :]
        samples[:, 0, :] = x  # first sample = the instance itself
        self._std = std
        self._instance = x
        return self._emit_samples(table, samples), samples

    def _distances(self, states: np.ndarray) -> np.ndarray:
        z = (states - self._instance[:, None, :]) / self._std[None, None, :]
        return np.sqrt((z ** 2).mean(axis=-1))


@register_stage
class VectorLIME(TabularLIME):
    """LIME over a dense vector column (reference VectorLIME.scala)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.set(input_cols=None)


class _TabularSHAP(KernelSHAPBase, _TabularDataMixin):
    def _build_samples(self, table: Table):
        rng = np.random.default_rng(int(self.seed))
        x = self._matrix(table)
        mean, _ = self._background_stats(table)
        n, d = x.shape
        states = np.stack([self._coalitions(d, rng) for _ in range(n)])  # (n,s,d)
        samples = states * x[:, None, :] + (1.0 - states) * mean[None, None, :]
        return self._emit_samples(table, samples), states


@register_stage
class TabularSHAP(_TabularSHAP):
    """KernelSHAP over scalar feature columns: off-coalition features are
    replaced by the background mean (reference TabularSHAP.scala)."""

    input_cols = Param("scalar feature columns", default=None,
                       converter=TypeConverters.to_list_str)
    input_col = Param("vector feature column (if input_cols unset)",
                      default="features")


@register_stage
class VectorSHAP(_TabularSHAP):
    """KernelSHAP over a dense vector column (reference VectorSHAP.scala)."""

    input_cols = Param("scalar feature columns", default=None,
                       converter=TypeConverters.to_list_str)
    input_col = Param("vector feature column", default="features")
