"""Registry-wide fuzzing sweep of mmlspark_tpu_torch: every registered
stage must be fuzzed.

The port's counterpart of the FULL / SERDE sweep of
tests/test_fuzzing_coverage.py (reference FuzzingTest.scala), over the
port's own registry (`core/registry.all_stages`).  Every registered
class sits in one bucket:

  - FULL      an example (stage, table) from tests/torch_fuzzing.py; runs
              the whole harness: save/load round trip, param equality and
              the loaded stage's transform equal to the unsaved one's,
              bit for bit, with the executor caches cleared between.  An
              estimator's fitted model goes through the round trip too.
  - SERDE     save/load + param equality only, with a recorded reason:
              the two HTTP stages and the 40 cognitive services, whose
              transform needs a live endpoint (tests/test_torch_http.py
              and test_torch_cognitive.py run them against local
              servers), as in the JAX package's sweep.

An uncovered registry class or a stale bucket entry fails the sweep.
Imports nothing of the JAX package.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core import registry
from mmlspark_tpu_torch.core.pipeline import Estimator, Model

from torch_fuzzing import (CLASSIC_EXAMPLES, COGNITIVE_STAGES,
                           GBDT_EXAMPLES, ONLINE_STATS_EXAMPLES,
                           SLICE16_EXAMPLES, SLICE17_EXAMPLES,
                           check_params_equal, example, fuzz, roundtrip,
                           serde_example)

torch.set_num_threads(2)

FULL = ["ImageTransformer", "ResizeImageTransformer", "UnrollImage",
        "UnrollBinaryImage", "ImageSetAugmenter", "TorchModel",
        "ImageFeaturizer", "DeepVisionClassifier", "DeepVisionModel",
        "JSONInputParser", "CustomInputParser", "JSONOutputParser",
        "StringOutputParser", "CustomOutputParser"] + GBDT_EXAMPLES + \
    ONLINE_STATS_EXAMPLES + CLASSIC_EXAMPLES + SLICE16_EXAMPLES + \
    SLICE17_EXAMPLES

_NETWORK = ("sends requests over the network; echo-server transform tests "
            "live in test_torch_http.py")
SERDE = {  # name -> (factory, reason)
    "HTTPTransformer": (lambda: serde_example("HTTPTransformer"), _NETWORK),
    "SimpleHTTPTransformer": (lambda: serde_example("SimpleHTTPTransformer"),
                              _NETWORK),
}
_SERVICE = ("transform needs a live HTTP endpoint; mock-server transform "
            "tests live in test_torch_cognitive.py")
SERDE.update({name: (lambda name=name: serde_example(name), _SERVICE)
              for name in COGNITIVE_STAGES})


def test_every_registered_stage_is_covered():
    stages = registry.all_stages()
    covered = set(FULL) | set(SERDE)
    uncovered = sorted(n for n in stages if n not in covered)
    assert not uncovered, (
        f"registered stages with no fuzzing example (add them to FULL or "
        f"SERDE in test_torch_fuzzing.py): {uncovered}")
    stale = sorted(n for n in covered if n not in stages)
    assert not stale, f"bucket entries not in the registry: {stale}"
    assert len(stages) == 161, sorted(stages)


@pytest.mark.parametrize("name", FULL)
def test_fuzz_full(name):
    stage, table = example(name)
    result = fuzz(stage, table)
    if isinstance(stage, Estimator):
        model, _ = result
        # the estimator's example also round-trips the model it fits
        assert isinstance(model, Model) and type(model).__name__ in FULL
    elif isinstance(stage, Model) and name.startswith("GBDT"):
        # a fitted GBDT model reloads bit for bit, the forest included
        loaded = roundtrip(stage)
        assert loaded.model_string == stage.model_string
        table = example(name)[1]
        np.testing.assert_array_equal(
            loaded.predict_leaf(table), stage.predict_leaf(table))


@pytest.mark.parametrize("name", sorted(SERDE))
def test_fuzz_serde(name):
    factory, reason = SERDE[name]
    assert reason
    stage = factory()
    check_params_equal(stage, roundtrip(stage))
