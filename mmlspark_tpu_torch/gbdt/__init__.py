"""Histogram gradient-boosted decision trees on the device.

The counterpart of the JAX package's `gbdt/` (itself the counterpart of
the reference's LightGBM module, ~4.4k LoC Scala over the SWIG'd C++
engine):

  - features are quantile-binned once on the host (`BinMapper`) into
    uint8 codes, which live on the device;
  - per-node histograms are PyTorch scatter-adds (`index_add_`) on the
    device and the split search one fused cumsum + argmax a node, of
    which the host pulls 32 bytes; the leaf-wise grower and the boosting
    loop are host code (reference lightgbm/booster +
    LGBM_BoosterUpdateOneIter);
  - high-dimensional hashed features train through a sparse CSR dataset
    path (`CSRMatrix` + COO histograms with implicit-zero fix-up) — the
    dense/sparse duality of dataset/DatasetAggregator.scala:69-515;
  - per-host "single dataset mode" aggregation: concurrent feeders append
    chunked rows and one elected worker trains (SharedState.scala:16-106);
  - distributed: the data- and voting-parallel learners shard rows over
    a mesh's data axis, one block a rank, and all-reduce the ranks' f64
    histograms (`torch.distributed`; the reference's shard_map + psum).
"""
from .aggregator import ChunkedArray, DatasetAggregator
from .binning import BinMapper
from .boosting import Booster, TrainConfig
from .sparse import CSRMatrix, SparseBinMapper
from .estimators import (
    GBDTClassificationModel,
    GBDTClassifier,
    GBDTRanker,
    GBDTRankerModel,
    GBDTRegressionModel,
    GBDTRegressor,
    LightGBMClassifier,
    LightGBMRanker,
    LightGBMRegressor,
)
from .tree import Tree

__all__ = [
    "BinMapper",
    "ChunkedArray",
    "DatasetAggregator",
    "Booster",
    "CSRMatrix",
    "SparseBinMapper",
    "TrainConfig",
    "Tree",
    "GBDTClassifier",
    "GBDTClassificationModel",
    "GBDTRegressor",
    "GBDTRegressionModel",
    "GBDTRanker",
    "GBDTRankerModel",
    "LightGBMClassifier",
    "LightGBMRegressor",
    "LightGBMRanker",
]
