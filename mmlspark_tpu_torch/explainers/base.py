"""Local explainer framework: LIME + KernelSHAP bases.

Reference: core explainers/LocalExplainer.scala:16, LIMEBase.scala:49-145,
KernelSHAPBase.scala:36-138, Sampler.scala, KernelSHAPSampler.scala.

A copy of the JAX package's `explainers/base.py` for this package.  The
reference samples per-row, scores through the model, then solves a
per-row Breeze regression inside `groupByKey.mapGroups`.  Here all rows'
perturbation samples are materialized into ONE samples Table so the wrapped
model runs a single large batched transform, and every per-row /
per-target LIME regression is solved in one batched call on the stage's
`device` (regression.batch_lasso / batch_weighted_least_squares: the card
unless the caller passes ``device="cpu"``).  KernelSHAP keeps the JAX
package's host f64 solve and has no `device` Param.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from ..core.schema import Table, find_unused_column_name
from ..device import DEVICE_DOC, resolve_device
from .regression import (
    batch_lasso,
    batch_weighted_least_squares,
    np_batch_weighted_least_squares,
)

__all__ = ["LocalExplainer", "LIMEBase", "KernelSHAPBase", "pad_ragged_states"]


def pad_ragged_states(states: List[np.ndarray]) -> np.ndarray:
    """Pad per-row (s, k_i) binary designs to (n, s, k_max).  Padded dims are
    constant-on: weightless in the centered regressions, and excluded from
    kernel weights via the subclass's `_true_dims`."""
    kmax = max(st.shape[1] for st in states)
    n, s = len(states), states[0].shape[0]
    out = np.ones((n, s, kmax), np.float32)
    for i, st in enumerate(states):
        out[i, :, : st.shape[1]] = st
    return out


class LocalExplainer(Transformer):
    """Common contract: wrap a fitted model, add a column of local importances.

    The output column holds, per input row, a (num_targets, dim) float array —
    `dim` = number of interpretable features (columns / superpixels / tokens).
    """

    model = ComplexParam("the model to explain (a fitted Transformer)")
    target_col = Param("model output column with scores", default="scores")
    target_classes = Param("class indices to explain", default=None,
                           converter=TypeConverters.to_list_int)
    output_col = Param("explanation output column", default="explanation")
    num_samples = Param("perturbation samples per row", default=128,
                        converter=TypeConverters.to_int)
    seed = Param("sampling seed", default=0, converter=TypeConverters.to_int)

    # ---- subclass surface -------------------------------------------------
    def _build_samples(self, table: Table) -> Tuple[Table, np.ndarray]:
        """Return (samples_table, states) where samples_table stacks
        num_samples perturbed copies of every row (row-major: all samples of
        row 0, then row 1, ...) and states is the binary/continuous design
        (n_rows, num_samples, dim)."""
        raise NotImplementedError

    def _sample_weights(self, states: np.ndarray) -> np.ndarray:
        """(n_rows, num_samples) regression weights for the design."""
        raise NotImplementedError

    def _solve(self, states, weights, targets):
        """(coefs (n, t, d), intercepts (n, t)) from the scored samples."""
        raise NotImplementedError

    # ---- shared driver ----------------------------------------------------
    def _target_scores(self, scored: Table) -> np.ndarray:
        """Extract (n_samples_total, n_targets) from the model output column."""
        col = scored[self.target_col]
        if col.dtype == object:
            mat = np.stack([np.atleast_1d(np.asarray(v, np.float32)) for v in col])
        else:
            mat = np.asarray(col, np.float32)
            if mat.ndim == 1:
                mat = mat[:, None]
        classes = self.get_or_default("target_classes")
        if classes:
            mat = mat[:, np.asarray(classes, int)]
        return mat

    def _transform(self, table: Table) -> Table:
        model: Transformer = self.model
        n = len(table)
        s = int(self.num_samples)
        samples, states = self._build_samples(table)
        scored = model.transform(samples)
        targets = self._target_scores(scored)  # (n*s, t)
        t = targets.shape[1]
        targets = targets.reshape(n, s, t)
        weights = self._sample_weights(states)
        coefs, intercepts = self._solve(
            np.asarray(states, np.float32), np.asarray(weights, np.float32), targets
        )
        coefs = np.asarray(coefs)  # (n, t, d)
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = coefs[i]
        out_col = self.get_or_default("output_col") or find_unused_column_name(
            "explanation", table.column_names
        )
        result = table.with_column(out_col, out)
        if getattr(self, "_emit_r2", False):
            r2 = self._fit_r2(states, weights, targets, coefs, np.asarray(intercepts))
            result = result.with_column(out_col + "_r2", r2)
        return result

    _emit_r2 = False

    @staticmethod
    def _fit_r2(states, weights, targets, coefs, intercepts) -> np.ndarray:
        """Goodness-of-fit of the surrogate per (row, target): (n, t) array."""
        n, s, d = states.shape
        preds = np.einsum("nsd,ntd->nst", states, coefs) + intercepts[:, None, :]
        w = weights / (weights.sum(axis=1, keepdims=True) + 1e-12)
        ybar = np.einsum("ns,nst->nt", w, targets)[:, None, :]
        ss_res = np.einsum("ns,nst->nt", w, (targets - preds) ** 2)
        ss_tot = np.einsum("ns,nst->nt", w, (targets - ybar) ** 2)
        return 1.0 - ss_res / (ss_tot + 1e-12)


class LIMEBase(LocalExplainer):
    """LIME: locally-weighted sparse linear surrogate.

    Reference: explainers/LIMEBase.scala:49-145 — sample, score, exponential
    kernel weights over sample distance, per-row weighted lasso.
    """

    kernel_width = Param("exponential kernel width", default=0.75,
                         converter=TypeConverters.to_float)
    regularization = Param("lasso l1 strength (0 -> plain WLS)", default=0.0,
                           converter=TypeConverters.to_float)
    device = Param(DEVICE_DOC, default=None)
    _emit_r2 = True

    #: set by ragged subclasses (image/text) to each row's true feature count,
    #: so padded design columns never leak into the kernel weights
    _true_dims = None

    def _distances(self, states: np.ndarray) -> np.ndarray:
        """Default: fraction of dropped interpretable features relative to the
        all-ones (original) state; continuous subclasses override."""
        dims = self._true_dims
        if dims is None:
            return 1.0 - states.mean(axis=-1)
        out = np.empty(states.shape[:2], np.float32)
        for i, k in enumerate(dims):
            out[i] = 1.0 - states[i, :, :k].mean(axis=-1)
        return out

    def _sample_weights(self, states: np.ndarray) -> np.ndarray:
        dist = self._distances(states)
        kw = float(self.kernel_width)
        return np.exp(-(dist ** 2) / (kw ** 2)).astype(np.float32)

    def _transform(self, table: Table) -> Table:
        resolve_device(self.device)  # no card: raise before the sampling
        return super()._transform(table)

    def _solve(self, states, weights, targets):
        alpha = float(self.regularization)
        if alpha > 0:
            coefs, intercepts = batch_lasso(states, targets, weights, alpha,
                                            device=self.device)
        else:
            coefs, intercepts = batch_weighted_least_squares(
                states, targets, weights, device=self.device)
        return coefs.cpu().numpy(), intercepts.cpu().numpy()


def shapley_kernel_weights(num_on: np.ndarray, dim: int) -> np.ndarray:
    """Regression weights given that coalitions were SAMPLED with
    P(|z|) proportional to the Shapley kernel mass (KernelSHAPBase._coalitions):
    interior coalitions get uniform weight (the sampling already encodes the
    kernel — weighting again would square it), while the full and null
    coalitions get a large anchor weight (the reference treats them as hard
    constraints — KernelSHAPBase.scala:36-138)."""
    k = np.asarray(num_on, int)
    w = np.ones(k.shape, np.float64)
    interior = (k > 0) & (k < dim)
    w[~interior] = 1e6
    return w.astype(np.float32)


class KernelSHAPBase(LocalExplainer):
    """KernelSHAP: Shapley values by weighted least squares over coalitions.

    Reference: explainers/KernelSHAPBase.scala:36-138, KernelSHAPSampler.scala.
    Coalition sampling: always include the null and full coalitions, then draw
    subsets with P(|z|) proportional to the Shapley kernel mass of size |z|.
    """

    _emit_r2 = True
    #: ragged subclasses (image/text) set this to each row's true dim
    _true_dims = None

    def _coalitions(self, dim: int, rng: np.random.Generator) -> np.ndarray:
        """(num_samples, dim) binary coalition matrix."""
        s = int(self.num_samples)
        out = np.zeros((s, dim), np.float32)
        out[0] = 1.0  # full
        # out[1] stays null
        if dim <= 1:
            return out
        sizes = np.arange(1, dim)
        mass = (dim - 1) / (sizes * (dim - sizes))
        mass = mass / mass.sum()
        counts = rng.choice(sizes, size=max(s - 2, 0), p=mass)
        for i, c in enumerate(counts):
            idx = rng.choice(dim, size=int(c), replace=False)
            out[i + 2, idx] = 1.0
        return out

    def _sample_weights(self, states: np.ndarray) -> np.ndarray:
        dims = self._true_dims
        if dims is None:
            dims = [states.shape[-1]] * states.shape[0]
        out = []
        for i, k in enumerate(dims):
            num_on = states[i, :, :k].sum(axis=-1)
            out.append(shapley_kernel_weights(num_on, k))
        return np.stack(out)

    def _solve(self, states, weights, targets):
        # float64 host solve: the 1e6 anchor weights on the full/null
        # coalitions are beyond f32 dynamic range (see regression.py).
        return np_batch_weighted_least_squares(states, targets, weights)
