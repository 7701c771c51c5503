"""The port's `ModelRepo.download_from` (mmlspark_tpu_torch.models.zoo), the
JAX package's repo-to-repo sha-verified transfer with retry, held to the
JAX suite's behaviour (tests/test_models.py `test_repo_transfer`): the
copy loads with the source's layer names, a copy whose bytes differ from
the manifest's sha256 raises after the retries, and a transient failure
is retried.  Host code only; no JAX.
"""
import shutil

import numpy as np
import pytest

from mmlspark_tpu_torch.models import zoo
from mmlspark_tpu_torch.models.bundle import TorchBundle


@pytest.fixture(scope="module")
def tiny_bundle():
    return TorchBundle("convnet_cifar", {"num_classes": 3},
                       input_shape=(16, 16, 3), dtype="float32", seed=1)


def test_repo_transfer(tmp_path, tiny_bundle):
    src = zoo.ModelRepo(str(tmp_path / "src"))
    dst = zoo.ModelRepo(str(tmp_path / "dst"))
    src.publish("tiny", tiny_bundle)
    schema = dst.download_from(src, "tiny")
    assert schema.uri.startswith(str(tmp_path / "dst"))
    assert schema.sha256 == src.get_schema("tiny").sha256
    assert dst.list_models() == ["tiny"]
    loaded = dst.load("tiny")
    assert loaded.layer_names == tiny_bundle.layer_names
    for k, v in tiny_bundle.state_dict.items():
        np.testing.assert_array_equal(loaded.state_dict[k], v)


def test_a_corrupted_source_fails_the_sha_check(tmp_path, tiny_bundle):
    src = zoo.ModelRepo(str(tmp_path / "src"))
    dst = zoo.ModelRepo(str(tmp_path / "dst"))
    src.publish("tiny", tiny_bundle)
    with open(src.get_schema("tiny").uri, "ab") as f:
        f.write(b"corruption")
    with pytest.raises(IOError, match="sha256 mismatch"):
        dst.download_from(src, "tiny")
    assert dst.list_models() == []


def test_a_transient_copy_failure_is_retried(tmp_path, tiny_bundle,
                                             monkeypatch):
    src = zoo.ModelRepo(str(tmp_path / "src"))
    dst = zoo.ModelRepo(str(tmp_path / "dst"))
    src.publish("tiny", tiny_bundle)
    real, calls = shutil.copyfile, []

    def flaky(a, b):
        calls.append(a)
        if len(calls) == 1:
            with open(b, "wb") as f:
                f.write(b"half a file")  # the sha check rejects it
            return b
        return real(a, b)

    monkeypatch.setattr(zoo.shutil, "copyfile", flaky)
    dst.download_from(src, "tiny")
    assert len(calls) == 2
    assert dst.load("tiny").layer_names == tiny_bundle.layer_names
