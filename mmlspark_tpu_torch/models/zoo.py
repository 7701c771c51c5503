"""Model zoo: manifest + sha-verified model repository.

Counterpart of the JAX package's `models/zoo.py` for TorchBundles, with a
cache root of its own.  Reference: deep-learning/.../downloader/
ModelDownloader.scala:26-263 — a repository abstraction with a JSON
MANIFEST and sha-verified transfer with retry; `ModelSchema` carries
layerNames/inputNode for ImageFeaturizer.  Models are pickled bundles;
offline, the zoo seeds random-initialised models of any registered
builder (the ResNets, the convnets, the ViTs, `transformer_lm`) from a
seed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import shutil
from typing import Dict, List, Optional

from ..utils.fault_tolerance import retry_with_backoff
from .bundle import TorchBundle

__all__ = ["ModelSchema", "ModelRepo", "default_repo", "get_or_create_resnet"]

_MANIFEST = "MANIFEST.json"


@dataclasses.dataclass
class ModelSchema:
    """Reference: downloader/Schema.scala (ModelSchema: name, dataset,
    modelType, uri, hash, size, inputNode, numLayers, layerNames)."""

    name: str
    model_type: str = "image"
    dataset: str = ""
    uri: str = ""
    sha256: str = ""
    size: int = 0
    input_shape: Optional[List[int]] = None
    layer_names: Optional[List[str]] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: dict) -> "ModelSchema":
        return ModelSchema(**d)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ModelRepo:
    """A directory of pickled bundles + MANIFEST.json."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _manifest_path(self) -> str:
        return os.path.join(self.root, _MANIFEST)

    def manifest(self) -> Dict[str, ModelSchema]:
        if not os.path.exists(self._manifest_path()):
            return {}
        with open(self._manifest_path()) as f:
            raw = json.load(f)
        return {k: ModelSchema.from_json(v) for k, v in raw.items()}

    def _write_manifest(self, entries: Dict[str, ModelSchema]) -> None:
        with open(self._manifest_path(), "w") as f:
            json.dump({k: v.to_json() for k, v in entries.items()}, f, indent=1)

    def list_models(self) -> List[str]:
        return sorted(self.manifest().keys())

    def publish(self, name: str, bundle: TorchBundle, **schema_kw) -> ModelSchema:
        path = os.path.join(self.root, f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(bundle, f)
        schema = ModelSchema(
            name=name, uri=path, sha256=_sha256(path),
            size=os.path.getsize(path),
            input_shape=list(bundle.input_shape) if bundle.input_shape else None,
            layer_names=list(bundle.layer_names), **schema_kw)
        entries = self.manifest()
        entries[name] = schema
        self._write_manifest(entries)
        return schema

    def get_schema(self, name: str) -> ModelSchema:
        entries = self.manifest()
        if name not in entries:
            raise KeyError(f"model {name!r} not in repo {self.root}; have {sorted(entries)}")
        return entries[name]

    def load(self, name: str, verify: bool = True, retries: int = 3) -> TorchBundle:
        """sha-verified load with retry (ModelDownloader.scala:216-238)."""
        schema = self.get_schema(name)

        def attempt() -> TorchBundle:
            path = schema.uri
            if not os.path.exists(path):
                path = os.path.join(self.root, f"{name}.pkl")
            if verify and schema.sha256 and _sha256(path) != schema.sha256:
                raise IOError(f"sha256 mismatch for model {name!r} at {path}")
            with open(path, "rb") as f:
                return pickle.load(f)

        return retry_with_backoff(attempt, retries=retries, initial_delay_sec=0.05)

    def download_from(self, other: "ModelRepo", name: str) -> ModelSchema:
        """Repo-to-repo sha-verified transfer (remote->local in the
        reference; here any source repo)."""
        schema = other.get_schema(name)
        src = schema.uri
        dst = os.path.join(self.root, f"{name}.pkl")

        def attempt():
            shutil.copyfile(src, dst)
            if schema.sha256 and _sha256(dst) != schema.sha256:
                raise IOError(f"sha256 mismatch downloading {name!r}")

        retry_with_backoff(attempt, retries=3, initial_delay_sec=0.05)
        local = dataclasses.replace(schema, uri=dst)
        entries = self.manifest()
        entries[name] = local
        self._write_manifest(entries)
        return local


_DEFAULT_REPO: Optional[ModelRepo] = None


def default_repo() -> ModelRepo:
    """Process-default repo: $MMLSPARK_TPU_TORCH_MODEL_REPO, else
    ~/.cache/mmlspark_tpu_torch/models."""
    global _DEFAULT_REPO
    if _DEFAULT_REPO is None:
        root = os.environ.get(
            "MMLSPARK_TPU_TORCH_MODEL_REPO",
            os.path.join(os.path.expanduser("~"), ".cache",
                         "mmlspark_tpu_torch", "models"))
        _DEFAULT_REPO = ModelRepo(root)
    return _DEFAULT_REPO


def get_or_create_resnet(name: str = "resnet50", input_shape=(224, 224, 3),
                         num_classes: int = 1000,
                         repo: Optional[ModelRepo] = None,
                         seed: int = 0) -> TorchBundle:
    """The repo's `name` model (any registered builder, despite the name),
    random-initialised from `seed` and published on first use.  A ViT is
    built for `input_shape`'s image size."""
    repo = repo or default_repo()
    key = f"{name}_{input_shape[0]}x{input_shape[1]}_{num_classes}"
    try:
        return repo.load(key)
    except KeyError:
        bundle = TorchBundle(name, {"num_classes": num_classes},
                             input_shape=input_shape, seed=seed)
        repo.publish(key, bundle, model_type="image", dataset="random-init")
        return bundle
