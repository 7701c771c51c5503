"""Isolation forest anomaly detection (native re-implementation of the
reference's external LinkedIn engine — SURVEY §2.9 item 5)."""
from .iforest import IsolationForest, IsolationForestModel

__all__ = ["IsolationForest", "IsolationForestModel"]
