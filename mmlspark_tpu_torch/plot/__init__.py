"""Plot helpers: confusion matrix + feature importance figures.

Reference: core/src/main/python/mmlspark/plot/ (~150 LoC Py).  Matplotlib is
optional — every helper also returns the underlying arrays.  A copy of
the JAX package's `plot/` for this package; `confusion_matrix_data`
counts through the port's `models/statistics.confusion_matrix`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["confusion_matrix_data", "plot_confusion_matrix",
           "plot_feature_importances"]


def confusion_matrix_data(y_true, y_pred):
    """(matrix, class labels): factorize labels, then delegate accumulation
    to the one implementation in models/statistics.py."""
    from ..models.statistics import confusion_matrix

    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    classes = np.unique(np.concatenate([y_true, y_pred]))
    index = {v: i for i, v in enumerate(classes.tolist())}
    t = np.array([index[v] for v in y_true.tolist()], np.float64)
    p = np.array([index[v] for v in y_pred.tolist()], np.float64)
    return confusion_matrix(t, p, len(classes)).astype(np.int64), classes


def plot_confusion_matrix(y_true, y_pred, labels: Optional[Sequence] = None,
                          ax=None, normalize: bool = False):
    """Render a confusion matrix; returns (matrix, classes, ax or None)."""
    cm, classes = confusion_matrix_data(y_true, y_pred)
    shown = cm.astype(np.float64)
    if normalize:
        shown = shown / np.maximum(shown.sum(axis=1, keepdims=True), 1)
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return cm, classes, None
    if ax is None:
        _, ax = plt.subplots()
    ax.imshow(shown, cmap="Blues")
    ticks = labels if labels is not None else classes
    ax.set_xticks(range(len(classes)), ticks)
    ax.set_yticks(range(len(classes)), ticks)
    ax.set_xlabel("predicted")
    ax.set_ylabel("actual")
    for i in range(len(classes)):
        for j in range(len(classes)):
            ax.text(j, i, f"{shown[i, j]:.2f}" if normalize else int(cm[i, j]),
                    ha="center", va="center", fontsize=8)
    return cm, classes, ax


def plot_feature_importances(importances, feature_names=None, top_k=20,
                             ax=None):
    """Horizontal bar chart of importances; returns (order, ax or None)."""
    imp = np.asarray(importances, np.float64)
    order = np.argsort(imp)[::-1][:top_k]
    names = (
        [feature_names[i] for i in order]
        if feature_names is not None else [f"f{i}" for i in order]
    )
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return order, None
    if ax is None:
        _, ax = plt.subplots()
    ax.barh(range(len(order))[::-1], imp[order])
    ax.set_yticks(range(len(order))[::-1], names)
    ax.set_xlabel("importance")
    return order, ax
