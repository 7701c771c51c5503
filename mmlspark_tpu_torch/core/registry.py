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
