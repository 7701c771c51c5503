"""Stage registry: the reflection backbone.

A copy of the JAX package's `core/registry.py` for this package, with a
registry of its own.

Reference: core/utils/JarLoadingUtils.scala:43 walks the classpath to find all
`Wrappable` stages.  Here stages self-register via decorator and
`all_stages()` lists them.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Type

_REGISTRY: Dict[str, Type] = {}

# modules whose import registers all public stages of this package (kept
# in sync as the port grows); a registry of its own, apart from the JAX
# package's
STAGE_MODULES = [
    "mmlspark_tpu_torch.core.pipeline",
    "mmlspark_tpu_torch.models.torch_model",
    "mmlspark_tpu_torch.models.image_featurizer",
    "mmlspark_tpu_torch.models.deep_vision",
    "mmlspark_tpu_torch.ops.image_stages",
    "mmlspark_tpu_torch.io.http.transformers",
    "mmlspark_tpu_torch.gbdt.estimators",
    "mmlspark_tpu_torch.online.featurizer",
    "mmlspark_tpu_torch.models.statistics",
    "mmlspark_tpu_torch.stages.basic",
    "mmlspark_tpu_torch.stages.batching",
    "mmlspark_tpu_torch.stages.text",
    "mmlspark_tpu_torch.featurize.featurize",
    "mmlspark_tpu_torch.featurize.value_indexer",
    "mmlspark_tpu_torch.featurize.clean_missing",
    "mmlspark_tpu_torch.featurize.text",
    "mmlspark_tpu_torch.featurize.tokenizer",
    "mmlspark_tpu_torch.models.linear",
    "mmlspark_tpu_torch.models.train_classifier",
    "mmlspark_tpu_torch.featurize.word2vec",
    "mmlspark_tpu_torch.online.learners",
    "mmlspark_tpu_torch.online.contextual_bandit",
    "mmlspark_tpu_torch.models.bilstm",
    "mmlspark_tpu_torch.nn.knn",
    "mmlspark_tpu_torch.automl.tune",
    "mmlspark_tpu_torch.automl.find_best",
    "mmlspark_tpu_torch.isolationforest.iforest",
    "mmlspark_tpu_torch.recommendation.indexer",
    "mmlspark_tpu_torch.recommendation.ranking",
    "mmlspark_tpu_torch.recommendation.sar",
    "mmlspark_tpu_torch.recommendation.tvs",
    "mmlspark_tpu_torch.explainers.superpixel",
    "mmlspark_tpu_torch.explainers.tabular",
    "mmlspark_tpu_torch.explainers.image",
    "mmlspark_tpu_torch.explainers.text",
    "mmlspark_tpu_torch.cyber.access_anomaly",
    "mmlspark_tpu_torch.cyber.feature",
    "mmlspark_tpu_torch.cognitive.vision",
    "mmlspark_tpu_torch.cognitive.text_analytics",
    "mmlspark_tpu_torch.cognitive.services",
    "mmlspark_tpu_torch.cognitive.speech",
]


def register_stage(cls=None, *, name: Optional[str] = None):
    def wrap(c):
        _REGISTRY[name or c.__name__] = c
        return c

    return wrap(cls) if cls is not None else wrap


def get_stage_class(name: str) -> Type:
    if name not in _REGISTRY:
        load_all_modules()
    return _REGISTRY[name]


def load_all_modules() -> List[str]:
    loaded = []
    for mod in STAGE_MODULES:
        try:
            importlib.import_module(mod)
            loaded.append(mod)
        except ModuleNotFoundError as e:
            # only suppress "this stage module isn't built yet"; a missing
            # transitive dependency inside a present module must surface,
            # or the registry silently shrinks
            if e.name != mod and not mod.startswith(f"{e.name}."):
                raise
    return loaded


def all_stages() -> Dict[str, Type]:
    load_all_modules()
    return dict(_REGISTRY)
