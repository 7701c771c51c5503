"""The check that the process never loaded JAX or the JAX package: each
loaded module's top-level name (the part before the first dot) is
compared whole, so the port, whose name begins with the JAX package's,
passes."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

__all__ = ["FORBIDDEN", "top_level", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mmlspark_tpu"})


def top_level(module_name: str) -> str:
    return module_name.split(".", 1)[0]


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted({n for n in names if top_level(n) in FORBIDDEN})
