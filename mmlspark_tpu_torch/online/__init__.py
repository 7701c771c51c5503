"""Online learning: hashed sparse featurization + adaptive SGD learners.

The port of the JAX package's `online/` (reference vw module, ~2.5k LoC,
vw/VowpalWabbitBase.scala family): murmur-hashed namespaces on the host,
and the learners' and the contextual bandit's AdaGrad passes on the card,
one launch of kernel K1 a pass (`ops/online_pass.py`).  The reference's
spanning-tree AllReduce (`use_all_reduce`) is a `torch.distributed`
all-reduce of the weights at the end of every pass over a data mesh.
"""
from .contextual_bandit import (
    ContextualBanditMetrics,
    VowpalWabbitContextualBandit,
    VowpalWabbitContextualBanditModel,
)
from .featurizer import (
    VectorZipper,
    VowpalWabbitFeaturizer,
    VowpalWabbitInteractions,
    sparse_to_padded,
)
from .hashing import FeatureHasher, murmurhash3_32
from .learners import (
    VowpalWabbitClassificationModel,
    VowpalWabbitClassifier,
    VowpalWabbitRegressionModel,
    VowpalWabbitRegressor,
)

__all__ = [
    "murmurhash3_32",
    "FeatureHasher",
    "VowpalWabbitFeaturizer",
    "VowpalWabbitInteractions",
    "VectorZipper",
    "sparse_to_padded",
    "VowpalWabbitClassifier",
    "VowpalWabbitClassificationModel",
    "VowpalWabbitRegressor",
    "VowpalWabbitRegressionModel",
    "VowpalWabbitContextualBandit",
    "VowpalWabbitContextualBanditModel",
    "ContextualBanditMetrics",
]
