"""Training delegate: user hooks around GBDT iterations.

Reference: lightgbm/LightGBMDelegate.scala (61 LoC) — callbacks before/after
training batches and iterations, including per-iteration eval results and
dynamic learning-rate control.
"""
from __future__ import annotations

from typing import List, Optional

__all__ = ["GBDTDelegate", "LearningRateSchedule"]


class GBDTDelegate:
    """Override any subset; default is a no-op.

    `get_learning_rate` returning a float overrides the config's rate for
    that iteration; `should_stop` returning True ends training after the
    iteration (on top of built-in early stopping).
    """

    def before_training(self, booster) -> None:
        pass

    def after_training(self, booster) -> None:
        pass

    def before_iteration(self, booster, iteration: int) -> None:
        pass

    def after_iteration(self, booster, iteration: int,
                        eval_records: List) -> None:
        pass

    def get_learning_rate(self, booster, iteration: int) -> Optional[float]:
        return None

    def should_stop(self, booster, iteration: int) -> bool:
        return False


class LearningRateSchedule(GBDTDelegate):
    """Delegate applying a schedule fn(iteration) -> learning rate
    (the reference's dynamic-learning-rate delegate use case)."""

    def __init__(self, schedule):
        self.schedule = schedule
        self.applied: List[float] = []

    def get_learning_rate(self, booster, iteration: int) -> float:
        lr = float(self.schedule(iteration))
        self.applied.append(lr)
        return lr
