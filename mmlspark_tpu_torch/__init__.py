"""mmlspark_tpu_torch — the PyTorch/CUDA port of mmlspark_tpu.

The same Estimator/Transformer pipelines over columnar tables, stage
names, Params, taps and output columns as the JAX package, written in
PyTorch for an NVIDIA H100: plain tensor code is PyTorch, and every
kernel the JAX package wrote in Pallas becomes a hand-written Hopper
kernel (csrc/).  This package imports nothing of JAX or of
`mmlspark_tpu`; the host modules it shares in spirit are its own copies.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(device.py).
"""
from .version import __version__
from .core.schema import Table, CategoricalMap, find_unused_column_name
from .core.params import Param, ComplexParam, ServiceParam, Params, TypeConverters
from .core.pipeline import (
    PipelineStage,
    Transformer,
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    LambdaTransformer,
    ml_transform,
)
from .core import registry

__all__ = [
    "__version__",
    "Table",
    "CategoricalMap",
    "find_unused_column_name",
    "Param",
    "ComplexParam",
    "ServiceParam",
    "Params",
    "TypeConverters",
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Model",
    "Pipeline",
    "PipelineModel",
    "LambdaTransformer",
    "ml_transform",
    "registry",
]
