"""Nearest-neighbor package: BallTree structures + KNN estimators.

Reference: core nn/ — BallTree.scala:31-271 (serializable BallTree /
ConditionalBallTree with label filtering), KNN.scala:48-126,
ConditionalKNN.scala:31-120 (estimators broadcasting the tree).

The port of the JAX package's `nn/`: the ball trees are a host copy; the
KNN stages score on the card (`knn.py`).
"""
from .ball_tree import BallTree, ConditionalBallTree
from .knn import KNN, KNNModel, ConditionalKNN, ConditionalKNNModel

__all__ = [
    "BallTree",
    "ConditionalBallTree",
    "KNN",
    "KNNModel",
    "ConditionalKNN",
    "ConditionalKNNModel",
]
