"""The linear learners on the device: the default classifier and regressor.

Counterpart of the JAX package's `models/linear.py`.  The reference wraps
SparkML learners inside TrainClassifier/TrainRegressor
(train/TrainClassifier.scala:49); the defaults here are full-batch
learners on the card — multinomial logistic regression (Adam over the
mean softmax cross-entropy plus an L2 term, from zero weights) and
closed-form ridge linear regression (solved in f64) — sharing the
(features_col, label_col, prediction_col) contract every learner
implements.  The products are plain `torch.matmul` / `torch.linalg.solve`:
the JAX package computes them in XLA, outside any Pallas kernel.

Each stage has a `device` Param, resolved by `device.resolve_device`:
the card unless the caller passes ``device="cpu"``, and without a card
only that runs.  Weights are numpy dicts (`{"w": [D, C], "b": [C]}` and
`{"w": [D], "b": [1]}`), so a JAX model's `weights` build this package's
model as they are.

Precision: the f32 products run at full f32 precision whatever the
process's TF32 setting is.  Each fit and transform runs under
`_full_f32()`, which sets `torch.backends.cuda.matmul.fp32_precision` to
"ieee" (cuBLAS's TF32 off) while any learner is inside it and then puts
back the value it read, so a process that set TF32 with either of
PyTorch's two APIs (that attribute, or the older `allow_tf32`) finds it
as it left it.  Concurrent fits and transforms share one depth count
under a lock: the first to enter saves the setting, the last to leave
restores it, so no learner's products fall back to TF32 while another
leaves.  The setting is process-wide: a product another thread runs
meanwhile also runs in full f32.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Estimator, Model
from ..core.registry import register_stage
from ..core.schema import Table, features_matrix as _features_matrix
from ..device import resolve_device

__all__ = [
    "LogisticRegression",
    "LogisticRegressionModel",
    "LinearRegression",
    "LinearRegressionModel",
    "fit_logistic",
    "solve_ridge",
]

_DEVICE_DOC = "'cuda' (default) or 'cpu'; without CUDA only an explicit 'cpu' runs"


def _tensor(a, dtype, device) -> torch.Tensor:
    """`a` as a tensor of numpy `dtype` on `device` (a read-only array,
    such as a loaded model's weights, is copied first)."""
    return torch.as_tensor(np.require(a, dtype, "W"), device=device)


_PRECISION_LOCK = threading.Lock()
_precision_depth = 0
_precision_before: Optional[str] = None


@contextlib.contextmanager
def _full_f32():
    """cuBLAS f32 matmuls at full precision (no TF32) inside the block,
    and for as long as any other thread is inside one.  Only the newer
    API is read and written: `torch.get_float32_matmul_precision()` and
    `allow_tf32` raise once a process has set the two APIs in turn."""
    global _precision_depth, _precision_before
    matmul = torch.backends.cuda.matmul
    with _PRECISION_LOCK:
        if _precision_depth == 0:
            _precision_before = matmul.fp32_precision
            matmul.fp32_precision = "ieee"
        _precision_depth += 1
    try:
        yield
    finally:
        with _PRECISION_LOCK:
            _precision_depth -= 1
            if _precision_depth == 0:
                matmul.fp32_precision = _precision_before


def fit_logistic(x: torch.Tensor, y: torch.Tensor, n_classes: int,
                 reg: float, steps: int, lr: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[float]]:
    """(w [D, C], b [C], last loss) after `steps` Adam steps (β 0.9 /
    0.999, ε 1e-8: optax.adam's arithmetic) from zero weights on the mean
    softmax cross-entropy plus `reg`·Σw², on x's device.  x: [N, D] f32,
    y: [N] int64 class ids."""
    w = torch.zeros(x.shape[1], n_classes, dtype=torch.float32,
                    device=x.device, requires_grad=True)
    b = torch.zeros(n_classes, dtype=torch.float32, device=x.device,
                    requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    loss = None
    with _full_f32():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(x @ w + b, y) + reg * torch.sum(w * w)
            loss.backward()
            opt.step()
    return (w.detach(), b.detach(),
            float(loss.detach()) if loss is not None else None)


def solve_ridge(x: torch.Tensor, y: torch.Tensor, reg: float
                ) -> torch.Tensor:
    """The closed-form ridge (X̃ᵀX̃ + λI)⁻¹X̃ᵀy in f64 on x's device, X̃ being
    x with a column of ones (the intercept) appended; [D + 1]."""
    xb = torch.cat([x.double(), torch.ones(x.shape[0], 1, dtype=torch.float64,
                                           device=x.device)], dim=1)
    gram = xb.T @ xb
    gram.diagonal().add_(reg)
    return torch.linalg.solve(gram, xb.T @ y.double())


@register_stage
class LogisticRegression(Estimator):
    features_col = Param("features column", default="features")
    label_col = Param("label column", default="label")
    prediction_col = Param("prediction column", default="prediction")
    probability_col = Param("probability column", default="scores")
    reg_param = Param("L2 strength", default=1e-4, converter=TypeConverters.to_float)
    max_iter = Param("gradient steps", default=200, converter=TypeConverters.to_int)
    learning_rate = Param("adam lr", default=0.1, converter=TypeConverters.to_float)
    device = Param(_DEVICE_DOC, default=None)

    def _fit(self, table: Table) -> "LogisticRegressionModel":
        dev = resolve_device(self.device)
        x = _tensor(_features_matrix(table[self.features_col]), np.float32,
                    dev)
        y_np = np.asarray(table[self.label_col]).astype(np.int32)
        n_classes = int(y_np.max()) + 1 if len(y_np) else 2
        y = _tensor(y_np, np.int64, dev)
        w, b, _ = fit_logistic(x, y, n_classes, self.reg_param,
                               self.max_iter, self.learning_rate)
        return LogisticRegressionModel(
            features_col=self.features_col,
            prediction_col=self.prediction_col,
            probability_col=self.probability_col,
            weights={"w": w.cpu().numpy(), "b": b.cpu().numpy()},
            device=self.device,
        )


@register_stage
class LogisticRegressionModel(Model):
    features_col = Param("features column", default="features")
    prediction_col = Param("prediction column", default="prediction")
    probability_col = Param("probability column", default="scores")
    weights = ComplexParam("dict with w [D,C] and b [C]")
    device = Param(_DEVICE_DOC, default=None)

    @property
    def num_classes(self) -> int:
        return int(self.weights["b"].shape[0])

    def _transform(self, table: Table) -> Table:
        dev = resolve_device(self.device)
        x = _tensor(_features_matrix(table[self.features_col]), np.float32,
                    dev)
        w = _tensor(self.weights["w"], np.float32, dev)
        b = _tensor(self.weights["b"], np.float32, dev)
        with _full_f32():
            probs = torch.softmax(x @ w + b, dim=-1).cpu().numpy()
        preds = probs.argmax(axis=-1).astype(np.float64)
        out = table.with_column(self.probability_col, probs)
        return out.with_column(self.prediction_col, preds)


@register_stage
class LinearRegression(Estimator):
    features_col = Param("features column", default="features")
    label_col = Param("label column", default="label")
    prediction_col = Param("prediction column", default="prediction")
    reg_param = Param("L2 (ridge) strength", default=1e-6,
                      converter=TypeConverters.to_float)
    device = Param(_DEVICE_DOC, default=None)

    def _fit(self, table: Table) -> "LinearRegressionModel":
        dev = resolve_device(self.device)
        x = _tensor(_features_matrix(table[self.features_col]), np.float64,
                    dev)
        y = _tensor(table[self.label_col], np.float64, dev)
        wb = solve_ridge(x, y, self.reg_param).cpu().numpy()
        return LinearRegressionModel(
            features_col=self.features_col,
            prediction_col=self.prediction_col,
            weights={"w": wb[:-1], "b": wb[-1:]},
            device=self.device,
        )


@register_stage
class LinearRegressionModel(Model):
    features_col = Param("features column", default="features")
    prediction_col = Param("prediction column", default="prediction")
    weights = ComplexParam("dict with w [D] and b [1]")
    device = Param(_DEVICE_DOC, default=None)

    def _transform(self, table: Table) -> Table:
        dev = resolve_device(self.device)
        x = _tensor(_features_matrix(table[self.features_col]), np.float64,
                    dev)
        w = _tensor(self.weights["w"], np.float64, dev)
        b = float(np.asarray(self.weights["b"], np.float64)[0])
        preds = (x @ w + b).cpu().numpy()
        return table.with_column(self.prediction_col, preds)
