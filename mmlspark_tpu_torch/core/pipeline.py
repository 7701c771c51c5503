"""Estimator / Transformer / Pipeline: the stage graph.

A copy of the JAX package's `core/pipeline.py` for this package.

SparkML semantics (fit/transform over tables, schema validation) without
Spark — reference: the Estimator/Transformer contract used throughout
mmlspark (e.g. deep-learning/.../CNTKModel.scala:500 transform,
lightgbm/LightGBMBase.scala:43 train), plus `NamespaceInjections.pipelineModel`
(core L1) and FluentAPI `df.mlTransform(stage)` (core/spark/FluentAPI.scala:12-24).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from .params import ComplexParam, Params
from .schema import Table
from .telemetry import log_verb

__all__ = [
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Model",
    "Pipeline",
    "PipelineModel",
    "LambdaTransformer",
    "ml_transform",
]


class PipelineStage(Params):
    """Common base: params + persistence + schema transform."""

    def transform_schema(self, columns: List[str]) -> List[str]:
        """Best-effort static schema check: given input column names, return
        output column names.  Subclasses override to validate inputs early
        (reference: transformSchema in every Spark stage)."""
        return columns

    # persistence — implemented via serialize.py to avoid import cycles
    def save(self, path: str, overwrite: bool = True) -> None:
        from . import serialize

        serialize.save_stage(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str) -> "PipelineStage":
        from . import serialize

        return serialize.load_stage(path)


class Transformer(PipelineStage):
    def transform(self, table: Table) -> Table:
        with log_verb(self, "transform"):
            return self._transform(table)

    def _transform(self, table: Table) -> Table:
        raise NotImplementedError

    def __call__(self, table: Table) -> Table:
        return self.transform(table)


class Estimator(PipelineStage):
    def fit(self, table: Table) -> "Transformer":
        with log_verb(self, "fit"):
            return self._fit(table)

    def _fit(self, table: Table) -> "Transformer":
        raise NotImplementedError

    def fit_transform(self, table: Table) -> Table:
        return self.fit(table).transform(table)


class Model(Transformer):
    """A Transformer produced by an Estimator."""


class Pipeline(Estimator):
    """Chain of stages; fitting fits estimators in sequence on the running
    transform of the input (SparkML Pipeline semantics)."""

    stages = ComplexParam("list of PipelineStage", default=None)

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def _fit(self, table: Table) -> "PipelineModel":
        fitted: List[Transformer] = []
        cur = table
        stages = self.stages or []
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(cur)
                fitted.append(model)
            elif isinstance(stage, Transformer):
                model = stage
                fitted.append(stage)
            else:
                raise TypeError(f"stage {i} is neither Estimator nor Transformer: {stage}")
            if i < len(stages) - 1:
                cur = model.transform(cur)
        return PipelineModel(stages=fitted)

    def transform_schema(self, columns: List[str]) -> List[str]:
        for stage in self.stages or []:
            columns = stage.transform_schema(columns)
        return columns


class PipelineModel(Model):
    stages = ComplexParam("list of fitted Transformers", default=None)

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, **kw):
        super().__init__(**kw)
        if stages is not None:
            self.set(stages=list(stages))

    def _transform(self, table: Table) -> Table:
        for stage in self.stages or []:
            table = stage.transform(table)
        return table

    def transform_schema(self, columns: List[str]) -> List[str]:
        for stage in self.stages or []:
            columns = stage.transform_schema(columns)
        return columns


class LambdaTransformer(Transformer):
    """Arbitrary table->table function as a stage.

    Reference: core stages/Lambda.scala:22.  The function is a complex param
    (pickled on save, like the reference's UDFParam).
    """

    fn = ComplexParam("Table -> Table callable")

    def __init__(self, fn: Optional[Callable[[Table], Table]] = None, **kw):
        super().__init__(**kw)
        if fn is not None:
            self.set(fn=fn)

    def _transform(self, table: Table) -> Table:
        return self.fn(table)


def ml_transform(table: Table, *stages: Transformer) -> Table:
    """FluentAPI analog: `ml_transform(t, s1, s2)` (FluentAPI.scala:12-24)."""
    for s in stages:
        table = s.transform(table)
    return table
