"""Online learning's hashed sparse featurization (host).

The counterpart of the featurizer half of the JAX package's `online/`
(reference vw module, vw/VowpalWabbitBase.scala family): murmur-hashed
namespaces on the host, whose `(indices, values)` rows feed the GBDT's
CSR path.  The adaptive SGD learners and the contextual bandit are not
ported yet (ROADMAP A17).
"""
from .featurizer import (
    VectorZipper,
    VowpalWabbitFeaturizer,
    VowpalWabbitInteractions,
    sparse_to_padded,
)
from .hashing import FeatureHasher, murmurhash3_32

__all__ = [
    "murmurhash3_32",
    "FeatureHasher",
    "VowpalWabbitFeaturizer",
    "VowpalWabbitInteractions",
    "VectorZipper",
    "sparse_to_padded",
]
