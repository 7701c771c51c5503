"""Param system: typed, documented stage configuration.

A copy of the JAX package's `core/params.py` for this package.

Mirrors SparkML `Params` + MMLSpark's ComplexParam extension
(reference core/serialize/ComplexParam.scala:13; org/apache/spark/ml/param/*.scala),
re-designed for a Python-first framework: Params are class-level descriptors,
values live in an instance map, and "complex" values (numpy arrays, nested
stages, callables, model bundles) are marked as such — the split Spark's
`ComplexParamsSerializer` makes (org/apache/spark/ml/ComplexParamsSerializer.scala).
"""
from __future__ import annotations

import copy
import uuid
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

__all__ = ["Param", "ComplexParam", "ServiceParam", "Params", "TypeConverters"]

T = TypeVar("T")


class TypeConverters:
    """Lenient converters mirroring pyspark.ml.param.TypeConverters."""

    @staticmethod
    def to_int(v):
        return int(v)

    @staticmethod
    def to_float(v):
        return float(v)

    @staticmethod
    def to_str(v):
        if not isinstance(v, str):
            raise TypeError(f"expected str, got {type(v)}")
        return v

    @staticmethod
    def to_bool(v):
        return bool(v)

    @staticmethod
    def to_list_int(v):
        return [int(x) for x in v]

    @staticmethod
    def to_list_float(v):
        return [float(x) for x in v]

    @staticmethod
    def to_list_str(v):
        return [TypeConverters.to_str(x) for x in v]

    @staticmethod
    def identity(v):
        return v


class Param(Generic[T]):
    """A named, documented parameter declared at class level.

    Works as a descriptor: `stage.my_param` reads the effective value
    (set -> default -> error); `stage.set(my_param=v)` writes.
    """

    is_complex = False
    _REQUIRED = object()  # sentinel: no default declared

    def __init__(
        self,
        doc: str = "",
        default: Any = _REQUIRED,
        converter: Optional[Callable[[Any], T]] = None,
        transient: bool = False,
    ):
        self.doc = doc
        self.has_default = default is not Param._REQUIRED
        self.default = None if not self.has_default else default
        self.converter = converter or TypeConverters.identity
        #: transient params are runtime-only hooks (delegates, live clients):
        #: skipped on save/load and excluded from round-trip equality
        self.transient = transient
        self.name: str = ""  # filled by __set_name__

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get_or_default(self.name)

    def __set__(self, obj, value):
        obj.set(**{self.name: value})

    def convert(self, value):
        return self.converter(value)

    def __repr__(self):
        return f"Param({self.name!r})"


class ComplexParam(Param):
    """Param whose value cannot round-trip through JSON (models, arrays,
    nested stages, UDFs) — reference core/serialize/ComplexParam.scala:13.
    """

    is_complex = True


class ServiceParam(Param):
    """Value-or-column duality: the param is either a constant or the name of
    a column supplying per-row values — reference
    cognitive/CognitiveServiceBase.scala:29-126 (ServiceParam).

    Set with `stage.set(p=value)` or `stage.set_col(p, "colname")`; read with
    `stage.resolve(row_or_table)`.
    """

    def convert(self, value):
        if isinstance(value, dict) and set(value) <= {"value", "col"}:
            return value
        return {"value": self.converter(value)}


class Params:
    """Base for everything with params.  Subclasses declare `Param` class
    attributes; instances carry `_param_map` (explicitly set) and read
    defaults from the declarations.
    """

    def __init__(self, **kwargs):
        self.uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._param_map: Dict[str, Any] = {}
        if kwargs:
            self.set(**kwargs)

    # ---- declaration access -------------------------------------------
    @classmethod
    def params(cls) -> Dict[str, Param]:
        out: Dict[str, Param] = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Param):
                    out[k] = v
        return out

    @classmethod
    def param(cls, name: str) -> Param:
        p = cls.params().get(name)
        if p is None:
            raise KeyError(f"{cls.__name__} has no param '{name}'")
        return p

    # ---- get/set -------------------------------------------------------
    def set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            p = self.param(name)
            if value is None:
                # pyspark semantics: setting None clears the explicit value,
                # falling back to the declared default
                self._param_map.pop(name, None)
            else:
                self._param_map[name] = p.convert(value)
        return self

    def set_col(self, name: str, col: str) -> "Params":
        p = self.param(name)
        if not isinstance(p, ServiceParam):
            raise TypeError(f"{name} is not a ServiceParam")
        self._param_map[name] = {"col": col}
        return self

    def is_set(self, name: str) -> bool:
        return name in self._param_map

    def is_defined(self, name: str) -> bool:
        return name in self._param_map or self.param(name).has_default

    def get(self, name: str) -> Any:
        return self._param_map.get(name)

    def get_or_default(self, name: str) -> Any:
        if name in self._param_map:
            return self._param_map[name]
        p = self.param(name)
        if p.has_default:
            return copy.copy(p.default) if isinstance(p.default, (list, dict)) else p.default
        raise KeyError(f"param '{name}' of {type(self).__name__} is not set and has no default")

    def resolve(self, name: str, table=None, row_index: int = None):
        """Resolve a ServiceParam to a constant or a per-row value."""
        v = self.get_or_default(name)
        if isinstance(v, dict) and "col" in v:
            if table is None:
                raise ValueError(f"param '{name}' is column-bound; need a table")
            col = table[v["col"]]
            return col if row_index is None else col[row_index]
        if isinstance(v, dict) and "value" in v:
            return v["value"]
        return v

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self.params().items()):
            cur = self._param_map.get(name, p.default if p.has_default else "<unset>")
            lines.append(f"{name}: {p.doc} (current: {cur!r})")
        return "\n".join(lines)

    def copy(self, extra: Optional[Dict[str, Any]] = None) -> "Params":
        new = copy.copy(self)
        new._param_map = dict(self._param_map)
        new.uid = self.uid
        if extra:
            new.set(**extra)
        return new

    # ---- serialization hooks (implemented in serialize.py) -------------
    def simple_param_values(self) -> Dict[str, Any]:
        return {
            n: v
            for n, v in self._param_map.items()
            if not self.param(n).is_complex
        }

    def complex_param_values(self) -> Dict[str, Any]:
        return {
            n: v for n, v in self._param_map.items()
            if self.param(n).is_complex and not self.param(n).transient
        }
