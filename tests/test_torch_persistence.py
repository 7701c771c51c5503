"""Stage persistence of mmlspark_tpu_torch (core/serialize.py,
`PipelineStage.save` / `load`) and the rest of the ported stages'
surface: `FunctionBundle`, and the readers of io/binary.py and
io/image.py held against the JAX package's on the same files.

1. Each of thirteen registered stages (each estimator and the model it
   fits; the GBDT, hashed featurizer and statistics stages among them),
   a `Pipeline` and a fitted `PipelineModel`, and a `TorchModel`
   over a `FunctionBundle` are saved here and loaded in a fresh
   interpreter with the JAX package blocked: a load builds a stage
   without its `__init__`, so the loaded stage must carry everything in
   its Params; each loaded transform equals this process's unsaved one
   bit for bit (the CPU path is deterministic).
2. A directory the JAX package saves is refused with a ValueError that
   names the stage and `from_flax_variables`, before anything of the
   JAX package is imported (checked with it blocked).
3. A prequantized int8 bundle keeps its int8 buffers through a round
   trip, and a TorchBundle pickles to numpy and plain attributes only.
4. A fitted GBDT model (dense and hashed-sparse) saves, loads and
   transforms bit for bit, its forest on the device predictor too; a
   JAX-saved one is refused, and its model string carries the forest.
"""
import io
import json
import os
import pickle
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.pipeline import Pipeline as JPipeline
from mmlspark_tpu.io import binary as JB
from mmlspark_tpu.io import image as JI
from mmlspark_tpu.ops.image_stages import UnrollImage as JUnrollImage
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.core.pipeline import (Pipeline, PipelineModel,
                                              PipelineStage)
from mmlspark_tpu_torch.io import binary as B
from mmlspark_tpu_torch.io import image as I
from mmlspark_tpu_torch.models.bundle import (FunctionBundle, TorchBundle,
                                              prequantize)
from mmlspark_tpu_torch.models.torch_model import TorchModel
from mmlspark_tpu_torch.ops import image_stages as S
from mmlspark_tpu_torch.ops import quant as Q

from torch_fuzzing import (affine_fn, check_params_equal, example, img_table,
                           roundtrip, tiny_bundle)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
STAGES = ["ImageTransformer", "ResizeImageTransformer", "UnrollImage",
          "UnrollBinaryImage", "ImageSetAugmenter", "TorchModel",
          "ImageFeaturizer", "DeepVisionClassifier", "DeepVisionModel",
          "GBDTClassifier", "GBDTRegressionModel", "VowpalWabbitFeaturizer",
          "ComputeModelStatistics", "Word2Vec", "VowpalWabbitClassifier",
          "VowpalWabbitContextualBandit", "SequenceTagger", "KNN", "SAR",
          "IsolationForest", "AccessAnomaly", "TabularLIME", "ImageLIME"]
BLOCKER = """
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "mmlspark_tpu")

def _blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if _blocked(name):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
"""


def _run_blocked(script: str) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, TESTS]))
    proc = subprocess.run([sys.executable, "-c", BLOCKER + script], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _pipeline():
    return Pipeline([
        S.ImageTransformer(device="cpu").resize(32, 32).flip(),
        S.UnrollImage(output_col="unrolled", device="cpu"),
        TorchModel(bundle=tiny_bundle(), input_col="unrolled",
                   fetch_node="pool", batch_size=4, device="cpu")])


def _function_model():
    rng = np.random.default_rng(9)
    bundle = FunctionBundle(
        affine_fn, {"w": torch.from_numpy(rng.standard_normal((12, 3))
                                          .astype(np.float32)),
                    "b": np.ones(3, np.float32)},
        input_shape=(12,), layer_names=["output", "norm"])
    return TorchModel(bundle=bundle, input_col="x", fetch_node="norm",
                      batch_size=4, device="cpu")


def test_every_stage_loads_in_a_fresh_interpreter(tmp_path):
    """Save here, load and transform in a fresh interpreter that cannot
    import the JAX package; every output equal bit for bit."""
    cases = {}
    for name in STAGES:
        stage, table = example(name)
        cases[name] = (stage, table)
        if hasattr(stage, "fit"):
            cases[f"{name}.model"] = (stage.fit(table), table)
    table = img_table(5)
    cases["Pipeline"] = (_pipeline(), table)
    cases["PipelineModel"] = (_pipeline().fit(table), table)
    x = np.random.default_rng(10).standard_normal((5, 12)).astype(np.float32)
    cases["FunctionBundle"] = (_function_model(), Table({"x": x}))
    manifest = {}
    for key, (stage, table) in cases.items():
        d = str(tmp_path / key)
        stage.save(d)
        out = (None if hasattr(stage, "fit") else stage.transform(table))
        with open(d + ".pkl", "wb") as f:
            pickle.dump((table, out, stage.simple_param_values()), f)
        manifest[key] = d
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump(manifest, f)
    out = _run_blocked(f"""
import json, pickle
from mmlspark_tpu_torch.core.pipeline import PipelineStage
manifest = json.load(open({str(tmp_path / "manifest.json")!r}))
for key, d in sorted(manifest.items()):
    table, want, params = pickle.load(open(d + ".pkl", "rb"))
    stage = PipelineStage.load(d)
    assert stage.simple_param_values() == params, (key, params)
    if want is None:  # an estimator: its fit is the fuzz sweep's
        assert hasattr(stage, "fit"), key
    else:
        got = stage.transform(table)
        assert got.approx_equals(want, rtol=0.0, atol=0.0), key
    print("loaded", key)
leaked = [m for m in sys.modules if _blocked(m)]
assert not leaked, leaked
""")
    assert sorted(line.split()[1] for line in out.splitlines()
                  if line.startswith("loaded")) == sorted(manifest)


def test_pipeline_and_pipeline_model_persist_through_their_stages(tmp_path):
    table = img_table(5)
    pipe = _pipeline()
    model = pipe.fit(table)
    assert isinstance(model, PipelineModel)
    model.save(str(tmp_path / "pm"))
    with open(tmp_path / "pm" / "metadata.json") as f:
        meta = json.load(f)
    assert meta["formatVersion"] == 1
    assert meta["class"] == "mmlspark_tpu_torch.core.pipeline.PipelineModel"
    assert meta["complexParams"]["stages"] == {"kind": "stage_list", "n": 3}
    assert os.path.isfile(tmp_path / "pm" / "complexParams" / "stages" /
                          "stage_2" / "complexParams" / "bundle" /
                          "value.pkl")
    loaded_pipe = roundtrip(pipe)
    check_params_equal(pipe, loaded_pipe)
    for a, b in zip(pipe.stages, loaded_pipe.stages):
        check_params_equal(a, b)
    loaded = PipelineStage.load(str(tmp_path / "pm"))
    want = model.transform(table)
    assert loaded.transform(table).approx_equals(want, rtol=0.0, atol=0.0)
    assert loaded_pipe.fit(table).transform(table).approx_equals(
        want, rtol=0.0, atol=0.0)


def test_a_function_bundle_runs_through_torch_model():
    stage = _function_model()
    bundle = stage.bundle
    assert all(isinstance(v, np.ndarray) for v in bundle.variables.values())
    x = np.random.default_rng(11).standard_normal((7, 12)).astype(np.float32)
    y = x @ bundle.variables["w"] + bundle.variables["b"]
    got = stage.transform(Table({"x": x}))["output"]
    np.testing.assert_allclose(got[:, 0], np.linalg.norm(y, axis=1),
                               rtol=1e-5)
    out = stage.copy({"fetch_node": None}).transform(Table({"x": x}))
    np.testing.assert_allclose(out["output"], y, rtol=1e-5, atol=1e-6)
    loaded = roundtrip(stage)
    assert loaded.bundle.bundle_id == bundle.bundle_id
    np.testing.assert_array_equal(
        loaded.transform(Table({"x": x}))["output"], got)


def _files(root):
    from PIL import Image

    rng = np.random.default_rng(12)
    os.makedirs(os.path.join(root, "a", "b"))
    names = []
    for i, (sub, ext) in enumerate([("", "png"), ("a", "png"), ("a/b", "bmp"),
                                    ("a", "png")]):
        arr = rng.integers(0, 255, (9 + i, 7, 3), dtype=np.uint8)
        path = os.path.join(root, sub, f"img{i}.{ext}")
        Image.fromarray(arr).save(path)
        names.append(path)
    with open(os.path.join(TESTS, "jpeg_fixtures", "gray_40x30.jpg"),
              "rb") as f:
        jpeg = f.read()
    with open(os.path.join(root, "a", "gray.jpg"), "wb") as f:
        f.write(jpeg)
    with open(os.path.join(root, "a", "b", "notes.txt"), "wb") as f:
        f.write(b"not an image")
    zpath = os.path.join(root, "set.zip")
    with zipfile.ZipFile(zpath, "w") as zf:
        for p in names:
            zf.write(p, os.path.relpath(p, root))
        zf.writestr("empty/", b"")
    return zpath


def _rows_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert {k: v for k, v in x.items() if k != "data"} == \
            {k: v for k, v in y.items() if k != "data"}
        np.testing.assert_array_equal(np.asarray(x["data"]),
                                      np.asarray(y["data"]))


def test_io_readers_match_the_jax_package(tmp_path):
    zpath = _files(str(tmp_path))
    pattern = os.path.join(str(tmp_path), "**", "*")
    got, want = B.read_binary_files(pattern), JB.read_binary_files(pattern)
    assert list(got["path"]) == list(want["path"])
    assert list(got["bytes"]) == list(want["bytes"])
    sub = B.read_binary_files(pattern, sample_ratio=0.5, seed=3)
    assert list(sub["path"]) == list(
        JB.read_binary_files(pattern, sample_ratio=0.5, seed=3)["path"])
    assert list(I.read_binary_files(pattern)["path"]) == list(got["path"])
    images = I.read_image_dir(pattern)
    ref = JI.read_image_dir(pattern)
    assert images.num_rows == ref.num_rows == 5  # the zip and text dropped
    _rows_equal(list(images["image"]), list(ref["image"]))
    assert I.read_image_dir(pattern, drop_invalid=False).num_rows == \
        JI.read_image_dir(pattern, drop_invalid=False).num_rows == 7
    for ratio, seed in ((1.0, 0), (0.5, 4)):
        assert list(B.zip_iterator(zpath, ratio, seed)) == list(
            JB.zip_iterator(zpath, ratio, seed))
    row = images["image"][0]
    for fmt in ("PNG", "BMP"):
        assert I.encode_image_row(row, fmt) == JI.encode_image_row(row, fmt)
    gray = [r for r in images["image"] if r["nChannels"] == 1][0]
    assert I.encode_image_row(gray) == JI.encode_image_row(gray)


def test_a_jax_saved_stage_is_refused_without_importing_it(tmp_path):
    for name, stage in (("unroll", JUnrollImage(output_col="v")),
                        ("pipeline", JPipeline([JUnrollImage()]))):
        stage.save(str(tmp_path / name))
        with pytest.raises(ValueError, match="from_flax_variables") as e:
            PipelineStage.load(str(tmp_path / name))
        assert "mmlspark_tpu." in str(e.value)
    out = _run_blocked(f"""
from mmlspark_tpu_torch.core.pipeline import PipelineStage
for name in ("unroll", "pipeline"):
    try:
        PipelineStage.load({str(tmp_path)!r} + "/" + name)
    except ValueError as e:
        assert "from_flax_variables" in str(e), e
        print("refused", name)
leaked = [m for m in sys.modules if _blocked(m)]
assert not leaked, leaked
""")
    assert out.split() == ["refused", "unroll", "refused", "pipeline"]


def test_a_prequantized_bundle_keeps_its_int8_buffers(tmp_path):
    bundle = prequantize(TorchBundle(
        "vit_tiny", {"num_classes": 4, "quant": True},
        input_shape=(32, 32, 3), dtype="float32", seed=2))
    x = np.random.default_rng(13).integers(0, 255, (5, 32, 32, 3)).astype(
        np.float32)
    stage = TorchModel(bundle=bundle, input_col="x", fetch_node="pool",
                       batch_size=8, device="cpu")
    want = stage.transform(Table({"x": x}))["output"]
    loaded = roundtrip(stage)
    sd = loaded.bundle.state_dict
    for k in ("blocks.0.qkv.wq", "blocks.11.mlp_out.wq"):
        assert sd[k].dtype == np.int8
        np.testing.assert_array_equal(sd[k], bundle.state_dict[k])
    module = loaded.bundle.module(torch.device("cpu"))
    assert module.blocks[3].proj.wq.dtype == torch.int8
    Q.INT8_GEMMS = 0
    got = loaded.transform(Table({"x": x}))["output"]
    assert Q.INT8_GEMMS == 4 * 12  # every block's four int8 layers, once
    np.testing.assert_array_equal(got, want)


def test_a_torch_bundle_pickles_to_numpy_and_plain_attributes():
    bundle = tiny_bundle()
    blob = pickle.dumps(bundle)
    modules = set()

    class Recording(pickle.Unpickler):
        def find_class(self, module, name):
            modules.add(module)
            return super().find_class(module, name)

    loaded = Recording(io.BytesIO(blob)).load()
    assert all(m.split(".")[0] in ("numpy", "builtins", "copyreg",
                                   "_codecs") or
               m == "mmlspark_tpu_torch.models.bundle" for m in modules), \
        modules
    assert set(vars(bundle)) == {
        "bundle_id", "builder", "builder_kwargs", "input_shape", "dtype",
        "state_dict", "layer_names", "input_dtype"}
    assert all(isinstance(v, np.ndarray) for v in bundle.state_dict.values())
    assert loaded.bundle_id == bundle.bundle_id


def test_a_fitted_gbdt_model_round_trips_bit_for_bit(tmp_path):
    from mmlspark_tpu.gbdt import GBDTRegressor as JRegressor

    from mmlspark_tpu_torch.gbdt import Booster, GBDTRegressor

    for name in ("GBDTClassificationModel", "GBDTRegressionModel",
                 "GBDTRankerModel"):
        model, table = example(name)
        want = model.transform(table)
        model.save(str(tmp_path / name))
        loaded = PipelineStage.load(str(tmp_path / name))
        check_params_equal(model, loaded)
        assert loaded.model_string == model.model_string
        assert loaded.transform(table).approx_equals(want, rtol=0.0,
                                                     atol=0.0)
        np.testing.assert_array_equal(
            loaded.features_shap(table), model.features_shap(table))
    # the dense regressor's forest on the device predictor, after a load
    rng = np.random.default_rng(14)
    x = rng.normal(size=(80, 4))
    y = x[:, 0] - 2 * x[:, 1]
    t = Table({"features": x, "label": y})
    model = GBDTRegressor(num_iterations=6, num_leaves=7, min_data_in_leaf=5,
                          device="cpu").fit(t)
    loaded = roundtrip(model)
    np.testing.assert_array_equal(
        loaded.booster.raw_scores_jit(x, device="cpu"),
        model.booster.raw_scores_jit(x, device="cpu"))
    # a JAX-saved GBDT model is refused by name; its model string carries
    # the forest across with equal scores
    jmodel = JRegressor(num_iterations=6, num_leaves=7, min_data_in_leaf=5,
                        parallelism="serial").fit(
        __import__("mmlspark_tpu").Table({"features": x, "label": y}))
    jmodel.save(str(tmp_path / "jax_gbdt"))
    with pytest.raises(ValueError, match="from_model_string"):
        PipelineStage.load(str(tmp_path / "jax_gbdt"))
    bridged = Booster.from_model_string(jmodel.model_string)
    np.testing.assert_array_equal(bridged.score(x), jmodel.booster.score(x))


def test_a_fitted_access_anomaly_model_and_a_lime_stage_round_trip(tmp_path):
    from mmlspark_tpu.cyber import AccessAnomaly as JAccessAnomaly

    from mmlspark_tpu_torch.cyber import AccessAnomalyModel

    est, table = example("AccessAnomaly")
    model = est.fit(table)
    want = model.transform(table)
    model.save(str(tmp_path / "aa"))
    loaded = PipelineStage.load(str(tmp_path / "aa"))
    check_params_equal(model, loaded)
    for t in model.factors:
        for a, b in zip(model.factors[t], loaded.factors[t]):
            np.testing.assert_array_equal(a, b)
    assert loaded.transform(table).approx_equals(want, rtol=0.0, atol=0.0)
    # a JAX-saved model is refused by name; its numpy factors carry over
    jt = __import__("mmlspark_tpu").Table(
        {k: table[k] for k in table.column_names})
    jmodel = JAccessAnomaly(rank=3, max_iter=2).fit(jt)
    jmodel.save(str(tmp_path / "jax_aa"))
    with pytest.raises(ValueError):
        PipelineStage.load(str(tmp_path / "jax_aa"))
    bridged = AccessAnomalyModel(factors=jmodel.factors, stats=jmodel.stats)
    np.testing.assert_array_equal(bridged.transform(table)["anomaly_score"],
                                  jmodel.transform(jt)["anomaly_score"])
    for name in ("TabularLIME", "TextLIME", "ImageSHAP"):
        stage, table = example(name)
        want = stage.transform(table)
        stage.save(str(tmp_path / name))
        loaded = PipelineStage.load(str(tmp_path / name))
        check_params_equal(stage, loaded)
        assert loaded.transform(table).approx_equals(want, rtol=0.0,
                                                     atol=0.0), name
