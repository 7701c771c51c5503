"""CyberML: collaborative-filtering access-anomaly detection + feature prep.

Reference: core/src/main/python/mmlspark/cyber/ (~1.7k LoC Py:
anomaly/collaborative_filtering.py AccessAnomaly, complement_access.py,
feature/ partitioned scalers and indexers).  Counterpart of the JAX
package's `cyber/`: the host stages are copies, and AccessAnomaly's ALS
sweeps run on the card unless the caller passes ``device="cpu"``.
"""
from .dataset import DataFactory
from .access_anomaly import (
    AccessAnomaly,
    AccessAnomalyModel,
    ComplementAccessTransformer,
)
from .feature import (
    IdIndexer,
    IdIndexerModel,
    PartitionedMinMaxScaler,
    PartitionedScalerModel,
    PartitionedStandardScaler,
)

__all__ = [
    "DataFactory",
    "AccessAnomaly",
    "AccessAnomalyModel",
    "ComplementAccessTransformer",
    "IdIndexer",
    "IdIndexerModel",
    "PartitionedStandardScaler",
    "PartitionedMinMaxScaler",
    "PartitionedScalerModel",
]
