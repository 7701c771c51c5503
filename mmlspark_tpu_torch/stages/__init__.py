"""The plumbing stages, a copy of the JAX package's `stages/` for this
package."""
from .basic import (
    Cacher,
    ClassBalancer,
    ClassBalancerModel,
    DropColumns,
    EnsembleByKey,
    Explode,
    MultiColumnAdapter,
    PartitionConsolidator,
    RenameColumn,
    Repartition,
    SelectColumns,
    StratifiedRepartition,
    SummarizeData,
    Timer,
    TimerModel,
    UDFTransformer,
)
from .batching import (
    DynamicMiniBatchTransformer,
    FixedMiniBatchTransformer,
    FlattenBatch,
    HasMiniBatcher,
    TimeIntervalMiniBatchTransformer,
)
from .text import TextPreprocessor, Trie, UnicodeNormalize
