"""Stage persistence: save/load every stage with simple + complex params.

A copy of the JAX package's `core/serialize.py` for this package, with
the same on-disk layout, kinds and format version.  Reference:
org/apache/spark/ml/Serializer.scala:21-147 and
ComplexParamsSerializer.scala — metadata JSON for JSON-able params, a
dedicated directory per complex param (models, arrays, nested stages,
UDFs).  Layout:

    <path>/metadata.json              {formatVersion, class, uid, params{...}}
    <path>/complexParams/<name>/      per-kind payload (npz / nested stage / pickle)

A stage loads without its `__init__`: `cls.__new__` plus
`Params.__init__`, then the saved param map.  Every stage of this
package keeps its whole state in Params, so nothing else is needed (the
JAX package's `_save_extra` / `_load_extra` hooks have no user here).

Only stages of this package load.  A directory the JAX package saved
names classes such as `mmlspark_tpu.models.tpu_model.TPUModel`, and
resolving one (or unpickling its FlaxBundle) would import the JAX
package; `load_stage` refuses any class path outside
`mmlspark_tpu_torch.` with a ValueError before it imports anything.
Weights cross over as numpy trees through
`models.bundle.from_flax_variables`.
"""
from __future__ import annotations

import importlib
import json
import os
import pickle
import shutil
from typing import Any

import numpy as np

from .params import Params
from .schema import CategoricalMap, Table

__all__ = ["save_stage", "load_stage"]

_FORMAT_VERSION = 1
_PACKAGE = "mmlspark_tpu_torch."


def _class_path(obj) -> str:
    t = type(obj)
    return f"{t.__module__}.{t.__qualname__}"


def _resolve_class(path: str):
    if not path.startswith(_PACKAGE):
        raise ValueError(
            f"cannot load stage class {path!r}: only stages of "
            f"mmlspark_tpu_torch load here (a stage the JAX package saved "
            f"would import it).  Rebuild the stage in mmlspark_tpu_torch and "
            f"carry its weights across with "
            f"mmlspark_tpu_torch.models.bundle.from_flax_variables (a GBDT "
            f"model's forest with mmlspark_tpu_torch.gbdt.Booster."
            f"from_model_string of its model_string)")
    module, _, name = path.rpartition(".")
    mod = importlib.import_module(module)
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _json_default(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"not JSON-serializable: {type(v)}")


# ---- complex value writers/readers -------------------------------------

def _write_complex(value: Any, path: str) -> dict:
    """Write one complex value under `path`, return a descriptor dict."""
    os.makedirs(path, exist_ok=True)
    from .pipeline import PipelineStage

    if isinstance(value, PipelineStage):
        save_stage(value, os.path.join(path, "stage"))
        return {"kind": "stage"}
    if isinstance(value, (list, tuple)) and value and all(
        isinstance(v, PipelineStage) for v in value
    ):
        for i, v in enumerate(value):
            save_stage(v, os.path.join(path, f"stage_{i}"))
        return {"kind": "stage_list", "n": len(value)}
    if isinstance(value, np.ndarray):
        np.save(os.path.join(path, "array.npy"), value, allow_pickle=value.dtype == object)
        return {"kind": "ndarray"}
    if isinstance(value, dict) and value and all(
        isinstance(v, np.ndarray) for v in value.values()
    ):
        np.savez(os.path.join(path, "arrays.npz"), **value)
        return {"kind": "ndarray_dict"}
    if isinstance(value, Table):
        cols = {n: value.columns[n] for n in value.column_names}
        with open(os.path.join(path, "table.pkl"), "wb") as f:
            pickle.dump({"columns": cols, "meta": value.meta}, f)
        return {"kind": "table"}
    if isinstance(value, CategoricalMap):
        with open(os.path.join(path, "catmap.json"), "w") as f:
            json.dump(value.to_json(), f)
        return {"kind": "categorical_map"}
    # catch-all: pickle (UDFs, TorchBundles, custom objects)
    with open(os.path.join(path, "value.pkl"), "wb") as f:
        pickle.dump(value, f)
    return {"kind": "pickle"}


def _read_complex(desc: dict, path: str) -> Any:
    kind = desc["kind"]
    if kind == "stage":
        return load_stage(os.path.join(path, "stage"))
    if kind == "stage_list":
        return [load_stage(os.path.join(path, f"stage_{i}")) for i in range(desc["n"])]
    if kind == "ndarray":
        return np.load(os.path.join(path, "array.npy"), allow_pickle=True)
    if kind == "ndarray_dict":
        with np.load(os.path.join(path, "arrays.npz")) as z:
            return {k: z[k] for k in z.files}
    if kind == "table":
        with open(os.path.join(path, "table.pkl"), "rb") as f:
            d = pickle.load(f)
        return Table(d["columns"], d["meta"])
    if kind == "categorical_map":
        with open(os.path.join(path, "catmap.json")) as f:
            return CategoricalMap.from_json(json.load(f))
    if kind == "pickle":
        with open(os.path.join(path, "value.pkl"), "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unknown complex param kind {kind!r}")


# ---- public API --------------------------------------------------------

def save_stage(stage: Params, path: str, overwrite: bool = True) -> None:
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        shutil.rmtree(path)
    os.makedirs(path)
    complex_descs = {}
    for name, value in stage.complex_param_values().items():
        if value is None:
            complex_descs[name] = {"kind": "none"}
            continue
        complex_descs[name] = _write_complex(
            value, os.path.join(path, "complexParams", name)
        )
    meta = {
        "formatVersion": _FORMAT_VERSION,
        "class": _class_path(stage),
        "uid": stage.uid,
        "params": stage.simple_param_values(),
        "complexParams": complex_descs,
    }
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1, default=_json_default)


def load_stage(path: str) -> Params:
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cls = _resolve_class(meta["class"])
    stage = cls.__new__(cls)
    Params.__init__(stage)
    stage.uid = meta["uid"]
    declared = cls.params()
    for name, value in meta["params"].items():
        if name in declared:
            stage._param_map[name] = value
    for name, desc in meta.get("complexParams", {}).items():
        if desc["kind"] == "none":
            stage._param_map[name] = None
        else:
            stage._param_map[name] = _read_complex(
                desc, os.path.join(path, "complexParams", name)
            )
    return stage
