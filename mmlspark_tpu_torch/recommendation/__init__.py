"""Recommendation: SAR collaborative filtering + ranking evaluation/tuning.

Reference: core recommendation/ (~1.3k LoC, SAR.scala:36-260, SARModel.scala,
RecommendationIndexer.scala, RankingAdapter.scala, RankingEvaluator.scala,
RankingTrainValidationSplit.scala).

The port of the JAX package's `recommendation/`: the indexer, ranking
and train-validation split are host copies; SAR's products and top-k run
on the card (`sar.py`).
"""
from .indexer import RecommendationIndexer, RecommendationIndexerModel
from .ranking import (
    RankingAdapter,
    RankingAdapterModel,
    RankingEvaluator,
    map_at_k,
    ndcg_at_k,
    precision_at_k,
    recall_at_k,
)
from .sar import SAR, SARModel
from .tvs import (
    RankingTrainValidationSplit,
    RankingTrainValidationSplitModel,
    per_user_split,
)

__all__ = [
    "SAR",
    "SARModel",
    "RecommendationIndexer",
    "RecommendationIndexerModel",
    "RankingAdapter",
    "RankingAdapterModel",
    "RankingEvaluator",
    "RankingTrainValidationSplit",
    "RankingTrainValidationSplitModel",
    "per_user_split",
    "ndcg_at_k",
    "map_at_k",
    "precision_at_k",
    "recall_at_k",
]
