"""Serialization-fuzzing harness of mmlspark_tpu_torch: every registered
stage gets, from one example object + table, (1) a save/load round trip
with param equality, (2) transform equality after the round trip, bit
for bit, (3) schema-transform consistency.

The port's counterpart of tests/fuzzing.py (reference core test/fuzzing/
Fuzzing.scala:222-325).  Two differences: the executor caches are
cleared before a loaded stage transforms (they key on `bundle_id`, which
pickle preserves, so a loaded stage would otherwise reuse the unsaved
stage's device module and prove nothing), and the outputs must be equal,
not close (the CPU path is deterministic).  The example stages and
tables live here too, so that test_torch_fuzzing.py and
test_torch_persistence.py share them.  Imports nothing of the JAX
package.
"""
from __future__ import annotations

import io as _io
import os
import tempfile

import numpy as np

from mmlspark_tpu_torch.core.pipeline import (Estimator, PipelineStage,
                                              Transformer)
from mmlspark_tpu_torch.core.schema import Table
from mmlspark_tpu_torch.io.image import array_to_image_row


def clear_executor_caches() -> None:
    from mmlspark_tpu_torch.models import generation, torch_model

    torch_model._EXEC_CACHE.clear()
    generation._MODULES.clear()


def roundtrip(stage: PipelineStage) -> PipelineStage:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stage")
        stage.save(path)
        loaded = PipelineStage.load(path)
    clear_executor_caches()
    return loaded


def check_params_equal(a: PipelineStage, b: PipelineStage):
    assert type(a) is type(b)
    assert a.uid == b.uid
    sa, sb = a.simple_param_values(), b.simple_param_values()
    assert sa == sb, f"simple params differ: {sa} vs {sb}"
    assert set(a.complex_param_values()) == set(b.complex_param_values())


def check_schema(stage: PipelineStage, table: Table, out: Table):
    want = stage.transform_schema(list(table.column_names))
    assert set(want) <= set(out.column_names) | set(table.column_names), (
        want, out.column_names)


def fuzz_transformer(stage: Transformer, table: Table):
    out1 = stage.transform(table)
    check_schema(stage, table, out1)
    loaded = roundtrip(stage)
    check_params_equal(stage, loaded)
    out2 = loaded.transform(table)
    assert out1.approx_equals(out2, rtol=0.0, atol=0.0), (
        f"{type(stage).__name__}: transform differs after save/load round-trip"
    )
    return out1


def fuzz_estimator(stage: Estimator, table: Table):
    model = stage.fit(table)
    out1 = model.transform(table)
    loaded_est = roundtrip(stage)
    check_params_equal(stage, loaded_est)
    model2 = roundtrip(model)
    check_params_equal(model, model2)
    out2 = model2.transform(table)
    assert out1.approx_equals(out2, rtol=0.0, atol=0.0), (
        f"{type(stage).__name__}: model transform differs after round-trip"
    )
    return model, out1


def fuzz(stage: PipelineStage, table: Table):
    if isinstance(stage, Estimator):
        return fuzz_estimator(stage, table)
    return fuzz_transformer(stage, table)


# ----------------------------------------------------------------------
# example stages and tables (tiny: the CPU path, f32)
# ----------------------------------------------------------------------

def img_table(n=6, h=16, w=12, seed=42) -> Table:
    rng = np.random.default_rng(seed)
    rows = np.empty(n, object)
    for i in range(n):
        rows[i] = array_to_image_row(
            rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8))
    return Table({"image": rows})


def png_table(n=3, seed=43) -> Table:
    from PIL import Image

    rng = np.random.default_rng(seed)
    blobs = np.empty(n, object)
    for i in range(n):
        buf = _io.BytesIO()
        Image.fromarray(rng.integers(0, 255, size=(10, 10, 3),
                                     dtype=np.uint8)).save(buf, format="PNG")
        blobs[i] = buf.getvalue()
    return Table({"bytes": blobs})


def tiny_bundle():
    from mmlspark_tpu_torch.models.bundle import TorchBundle

    return TorchBundle("resnet18", {"num_classes": 10},
                       input_shape=(32, 32, 3), dtype="float32", seed=0)


def example(name: str):
    """(stage, table) for each of the port's registered stages."""
    from mmlspark_tpu_torch.models.deep_vision import DeepVisionClassifier
    from mmlspark_tpu_torch.models.image_featurizer import ImageFeaturizer
    from mmlspark_tpu_torch.models.torch_model import TorchModel
    from mmlspark_tpu_torch.ops import image_stages as S

    cpu = {"device": "cpu"}
    if name == "ImageTransformer":
        return S.ImageTransformer(**cpu).resize(8, 8).flip(), img_table()
    if name == "ResizeImageTransformer":
        return S.ResizeImageTransformer(height=8, width=8, **cpu), img_table()
    if name == "UnrollImage":
        return S.UnrollImage(mean=[1.0, 2.0, 3.0], std=[2.0, 2.0, 2.0],
                             **cpu), img_table()
    if name == "UnrollBinaryImage":
        return S.UnrollBinaryImage(height=4, width=4, **cpu), png_table()
    if name == "ImageSetAugmenter":
        return S.ImageSetAugmenter(flip_up_down=True, **cpu), img_table()
    if name == "TorchModel":
        x = np.random.default_rng(44).normal(size=(6, 32, 32, 3))
        return TorchModel(bundle=tiny_bundle(), input_col="x", output_col="y",
                          batch_size=4, **cpu), Table(
                              {"x": x.astype(np.float32)})
    if name == "ImageFeaturizer":
        return ImageFeaturizer(bundle=tiny_bundle(), batch_size=4,
                               **cpu), img_table(4)
    if name == "DeepVisionClassifier":
        rng = np.random.default_rng(45)
        rows = np.empty(8, object)
        for i in range(8):
            base = np.array([30, 30, 200] if i % 2 else [200, 30, 30],
                            np.uint8)
            rows[i] = np.clip(rng.normal(base, 20, (32, 32, 3)), 0,
                              255).astype(np.uint8)
        t = Table({"image": rows,
                   "label": np.asarray([float(i % 2) for i in range(8)])})
        return DeepVisionClassifier(backbone="resnet18", epochs=1,
                                    batch_size=8, seed=0, **cpu), t
    if name == "DeepVisionModel":
        from mmlspark_tpu_torch.models.bundle import TorchBundle
        from mmlspark_tpu_torch.models.deep_vision import DeepVisionModel

        bundle = TorchBundle("resnet18", {"num_classes": 2},
                             input_shape=(32, 32, 3), dtype="float32", seed=1)
        return DeepVisionModel(bundle=bundle, classes=["cat", "dog"],
                               height=32, width=32, **cpu), img_table(5)
    if name == "JSONInputParser":
        from mmlspark_tpu_torch.io.http.transformers import JSONInputParser
        return JSONInputParser(input_cols=["a"], url="http://localhost:9/x"), \
            Table({"a": np.array([1, 2, 3])})
    if name == "CustomInputParser":
        from mmlspark_tpu_torch.io.http.transformers import CustomInputParser
        return CustomInputParser(input_cols=["a"], udf=row_to_request), \
            Table({"a": np.array([1, 2])})
    if name == "JSONOutputParser":
        from mmlspark_tpu_torch.io.http.transformers import JSONOutputParser
        return JSONOutputParser(), fake_responses_table()
    if name == "StringOutputParser":
        from mmlspark_tpu_torch.io.http.transformers import StringOutputParser
        return StringOutputParser(), fake_responses_table()
    if name == "CustomOutputParser":
        from mmlspark_tpu_torch.io.http.transformers import CustomOutputParser
        return CustomOutputParser(udf=response_status), fake_responses_table()
    if name in GBDT_EXAMPLES:
        return gbdt_example(name)
    if name in ONLINE_STATS_EXAMPLES:
        return online_stats_example(name)
    if name in CLASSIC_EXAMPLES:
        return classic_example(name)
    if name in SLICE16_EXAMPLES:
        return slice16_example(name)
    if name in SLICE17_EXAMPLES:
        return slice17_example(name)
    raise KeyError(name)


# the GBDT stages (as the JAX package's tests/test_fuzzing_coverage.py
# fuzzes them): an estimator per family, the model it fits, and the
# LightGBM* aliases, which are the same classes
GBDT_EXAMPLES = ["GBDTClassifier", "GBDTClassificationModel",
                 "GBDTRegressor", "GBDTRegressionModel", "GBDTRanker",
                 "GBDTRankerModel", "LightGBMClassifier", "LightGBMRegressor",
                 "LightGBMRanker"]
ONLINE_STATS_EXAMPLES = ["VowpalWabbitFeaturizer", "VowpalWabbitInteractions",
                         "VectorZipper", "ComputeModelStatistics",
                         "ComputePerInstanceStatistics"]


def cls_table(n=60, seed=46) -> Table:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
    return Table({"features": x, "label": y})


def reg_table(n=60, seed=47) -> Table:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4))
    return Table({"features": x, "label": 2 * x[:, 0] - x[:, 2] + 0.1 *
                  rng.normal(size=n)})


def rank_table() -> Table:
    t = reg_table(48)
    return Table({"features": t["features"],
                  "label": (np.asarray(t["label"]) > 0).astype(np.float64),
                  "group": np.repeat(np.arange(8), 6)})


def hashed_table() -> Table:
    from mmlspark_tpu_torch.online import VowpalWabbitFeaturizer

    rng = np.random.default_rng(48)
    words = [f"w{i}" for i in range(30)]
    text = np.asarray([" ".join(rng.choice(words, 5)) for _ in range(40)],
                      object)
    label = np.asarray([float("w1" in t.split()) for t in text])
    return VowpalWabbitFeaturizer(
        input_cols=["text"], output_col="features", num_bits=12,
        string_split_cols=["text"]).transform(Table({"text": text,
                                                     "label": label}))


def gbdt_example(name: str):
    from mmlspark_tpu_torch.gbdt import estimators as G

    small = dict(num_leaves=7, min_data_in_leaf=5, device="cpu")
    family = name.replace("LightGBM", "GBDT").replace("Classification",
                                                       "Classifier")
    family = family.replace("RegressionModel", "Regressor").replace(
        "RankerModel", "Ranker")
    if family == "GBDTClassifier":
        # the hashed CSR path for the classifier, dense for the others
        est, table = G.GBDTClassifier(num_iterations=5, **small), \
            hashed_table()
    elif family == "GBDTRegressor":
        est, table = G.GBDTRegressor(num_iterations=5, boosting_type="dart",
                                     **small), reg_table()
    else:
        est, table = G.GBDTRanker(num_iterations=4, num_leaves=7,
                                  min_data_in_leaf=3, device="cpu"), \
            rank_table()
    if name.endswith("Model"):
        return est.fit(table), table
    return est, table


def online_stats_example(name: str):
    from mmlspark_tpu_torch.models import statistics as S
    from mmlspark_tpu_torch.online import featurizer as F

    if name == "VowpalWabbitFeaturizer":
        text = np.asarray(["good movie", "bad film", "good film"], object)
        return F.VowpalWabbitFeaturizer(input_cols=["text", "n"], num_bits=10,
                                        string_split_cols=["text"]), \
            Table({"text": text, "n": np.array([1.0, 0.0, 2.5])})
    if name == "VowpalWabbitInteractions":
        t = Table({"a": np.arange(4.0), "b": np.arange(4.0) * 3})
        t = F.VowpalWabbitFeaturizer(input_cols=["a"], output_col="na",
                                     num_bits=10).transform(t)
        t = F.VowpalWabbitFeaturizer(input_cols=["b"], output_col="nb",
                                     num_bits=10).transform(t)
        return F.VowpalWabbitInteractions(input_cols=["na", "nb"],
                                          num_bits=10), t
    if name == "VectorZipper":
        return F.VectorZipper(input_cols=["value", "k"], output_col="zipped"), \
            Table({"value": np.array([1.0, 2.0, 3.0]),
                   "k": np.array([4, 5, 6])})
    if name == "ComputeModelStatistics":
        t = Table({"label": np.array([0.0, 1.0, 1.0, 0.0]),
                   "prediction": np.array([0.0, 1.0, 0.0, 0.0]),
                   "scores": np.array([0.2, 0.9, 0.4, 0.1])})
        return S.ComputeModelStatistics(evaluation_metric="classification"), t
    t = Table({"label": np.array([1, 0]), "prediction": np.array([1.0, 0.0]),
               "scores": np.array([[0.2, 0.8], [0.7, 0.3]])})
    return S.ComputePerInstanceStatistics(
        evaluation_metric="classification"), t


# the classic-ML slice's stages (as the JAX package's
# tests/test_fuzzing_coverage.py fuzzes them): the plumbing stages, the
# featurizers, the linear learners and TrainClassifier / TrainRegressor,
# each estimator's model too
CLASSIC_EXAMPLES = [
    "Cacher", "DropColumns", "SelectColumns", "RenameColumn", "Repartition",
    "Explode", "SummarizeData", "ClassBalancer", "ClassBalancerModel",
    "Timer", "TimerModel", "UDFTransformer", "MultiColumnAdapter",
    "EnsembleByKey", "StratifiedRepartition", "PartitionConsolidator",
    "FixedMiniBatchTransformer", "DynamicMiniBatchTransformer",
    "TimeIntervalMiniBatchTransformer", "FlattenBatch", "TextPreprocessor",
    "UnicodeNormalize", "Featurize", "FeaturizeModel", "ValueIndexer",
    "ValueIndexerModel", "IndexToValue", "CleanMissingData",
    "CleanMissingDataModel", "DataConversion", "CountSelector",
    "CountSelectorModel", "TextFeaturizer", "TextFeaturizerModel",
    "BPETokenizer", "BPETokenizerModel", "MultiNGram", "PageSplitter",
    "LinearRegression", "LinearRegressionModel", "LogisticRegression",
    "LogisticRegressionModel", "TrainClassifier", "TrainedClassifierModel",
    "TrainRegressor", "TrainedRegressorModel"]


# module-level functions: they pickle by name
def square(v):
    return v * v


def plus_one(v):
    return v + 1


def num_table(n=24, seed=49) -> Table:
    rng = np.random.default_rng(seed)
    return Table({"value": rng.normal(size=n),
                  "k": np.asarray(list("ab") * (n // 2)),
                  "label": (rng.random(n) > 0.5).astype(np.float64)})


def text_table() -> Table:
    return Table({"text": np.asarray(
        ["the quick brown fox jumps over the lazy dog",
         "pack my box with five dozen liquor jugs",
         "how vexingly quick daft zebras jump",
         "the five boxing wizards jump quickly"] * 4, object)})


def mixed_table() -> Table:
    return Table({
        "num": np.array([1.0, np.nan, 3.0, 4.0, 2.0, np.nan]),
        "cat": np.asarray(list("uvuvuv")),
        "label": np.asarray(["yes", "no", "yes", "no", "yes", "no"]),
    })


def classic_example(name: str):
    from mmlspark_tpu_torch import featurize as FZ
    from mmlspark_tpu_torch import stages as ST
    from mmlspark_tpu_torch.models import linear as L
    from mmlspark_tpu_torch.models import train_classifier as TC

    cpu = {"device": "cpu"}
    models = {"ClassBalancerModel": "ClassBalancer", "TimerModel": "Timer",
              "FeaturizeModel": "Featurize",
              "ValueIndexerModel": "ValueIndexer",
              "CleanMissingDataModel": "CleanMissingData",
              "CountSelectorModel": "CountSelector",
              "TextFeaturizerModel": "TextFeaturizer",
              "BPETokenizerModel": "BPETokenizer",
              "LinearRegressionModel": "LinearRegression",
              "LogisticRegressionModel": "LogisticRegression",
              "TrainedClassifierModel": "TrainClassifier",
              "TrainedRegressorModel": "TrainRegressor"}
    if name in models:
        est, table = classic_example(models[name])
        return est.fit(table), table
    simple = {
        "Cacher": lambda: ST.Cacher(),
        "DropColumns": lambda: ST.DropColumns(cols=["k"]),
        "SelectColumns": lambda: ST.SelectColumns(cols=["value"]),
        "RenameColumn": lambda: ST.RenameColumn(input_col="value",
                                                output_col="v2"),
        "Repartition": lambda: ST.Repartition(n=3),
        "SummarizeData": lambda: ST.SummarizeData(),
        "ClassBalancer": lambda: ST.ClassBalancer(input_col="label"),
        "Timer": lambda: ST.Timer(stage=ST.UDFTransformer(
            input_col="value", output_col="sq", udf=square)),
        "UDFTransformer": lambda: ST.UDFTransformer(
            input_col="value", output_col="sq", udf=square),
        "EnsembleByKey": lambda: ST.EnsembleByKey(keys=["k"],
                                                  cols=["value"]),
        "StratifiedRepartition": lambda: ST.StratifiedRepartition(
            n=2, label_col="label"),
        "PartitionConsolidator": lambda: ST.PartitionConsolidator(
            grace_period_ms=50),
        "FixedMiniBatchTransformer": lambda: ST.FixedMiniBatchTransformer(
            batch_size=5),
        "DynamicMiniBatchTransformer": lambda:
            ST.DynamicMiniBatchTransformer(max_batch_size=6),
        # a flush interval no run reaches: batches by max_batch_size alone
        "TimeIntervalMiniBatchTransformer": lambda:
            ST.TimeIntervalMiniBatchTransformer(interval_ms=10 ** 7,
                                                max_batch_size=8),
    }
    if name in simple:
        return simple[name](), num_table()
    if name == "Explode":
        col = np.empty(3, object)
        for i in range(3):
            col[i] = list(range(i + 1))
        return ST.Explode(input_col="xs"), Table({"xs": col,
                                                  "id": np.arange(3)})
    if name == "MultiColumnAdapter":
        return ST.MultiColumnAdapter(
            base_stage=ST.UDFTransformer(udf=plus_one), input_cols=["a", "b"],
            output_cols=["a1", "b1"]), Table({"a": np.arange(4.0),
                                              "b": np.arange(4.0) * 2})
    if name == "FlattenBatch":
        return ST.FlattenBatch(), ST.FixedMiniBatchTransformer(
            batch_size=5).transform(num_table())
    if name == "TextPreprocessor":
        return ST.TextPreprocessor(input_col="text", output_col="clean",
                                   map={"quick": "fast", "lazy": "idle"}), \
            text_table()
    if name == "UnicodeNormalize":
        return ST.UnicodeNormalize(input_col="text", output_col="norm",
                                   form="NFC", lower=True), text_table()
    if name == "Featurize":
        return FZ.Featurize(input_cols=["num", "cat"],
                            output_col="features"), mixed_table()
    if name == "ValueIndexer":
        return FZ.ValueIndexer(input_col="label", output_col="idx"), \
            mixed_table()
    if name == "IndexToValue":
        t = FZ.ValueIndexer(input_col="label", output_col="idx").fit(
            mixed_table()).transform(mixed_table())
        return FZ.IndexToValue(input_col="idx", output_col="back"), t
    if name == "CleanMissingData":
        return FZ.CleanMissingData(input_cols=["num"]), mixed_table()
    if name == "DataConversion":
        return FZ.DataConversion(cols=["value"], convert_to="integer"), \
            Table({"value": np.array([1.2, 3.9, 2.1])})
    if name == "CountSelector":
        x = np.zeros((6, 3), np.float32)
        x[:, 0] = np.random.default_rng(50).normal(size=6)
        return FZ.CountSelector(input_col="features", output_col="selected"), \
            Table({"features": x})
    if name == "TextFeaturizer":
        return FZ.TextFeaturizer(input_col="text", num_features=64), \
            text_table()
    if name == "BPETokenizer":
        return FZ.BPETokenizer(input_col="text", vocab_size=64), text_table()
    if name == "MultiNGram":
        toks = np.empty(3, object)
        for i in range(3):
            toks[i] = ["a", "b", "c", "d"][: i + 2]
        return FZ.MultiNGram(input_col="tokens", output_col="ngrams",
                             lengths=[1, 2]), Table({"tokens": toks})
    if name == "PageSplitter":
        return FZ.PageSplitter(input_col="text", maximum_page_length=20,
                               minimum_page_length=10), text_table()
    if name == "LinearRegression":
        return L.LinearRegression(**cpu), reg_table()
    if name == "LogisticRegression":
        return L.LogisticRegression(max_iter=60, **cpu), cls_table()
    if name == "TrainClassifier":
        t = cls_table(50)
        return TC.TrainClassifier(**cpu), Table({
            "num": np.asarray(t["features"])[:, 0],
            "cat": np.asarray(list("xy") * 25), "label": t["label"]})
    if name == "TrainRegressor":
        t = reg_table(50)
        return TC.TrainRegressor(**cpu), Table({
            "num": np.asarray(t["features"])[:, 0],
            "num2": np.asarray(t["features"])[:, 1], "label": t["label"]})
    raise KeyError(name)


# Word2Vec, the online learners, the tagger, KNN, automl, the isolation
# forest and recommendation (the fuzz examples of the JAX package's
# tests/test_fuzzing_coverage.py, on the CPU)
SLICE16_EXAMPLES = [
    "Word2Vec", "Word2VecModel", "VowpalWabbitClassifier",
    "VowpalWabbitClassificationModel", "VowpalWabbitRegressor",
    "VowpalWabbitRegressionModel", "VowpalWabbitContextualBandit",
    "VowpalWabbitContextualBanditModel", "SequenceTagger",
    "SequenceTaggerModel", "KNN", "KNNModel", "ConditionalKNN",
    "ConditionalKNNModel", "TuneHyperparameters", "TuneHyperparametersModel",
    "FindBestModel", "BestModel", "IsolationForest", "IsolationForestModel",
    "SAR", "SARModel", "RecommendationIndexer", "RecommendationIndexerModel",
    "RankingAdapter", "RankingAdapterModel", "RankingTrainValidationSplit",
    "RankingTrainValidationSplitModel"]


def ratings_table() -> Table:
    rng = np.random.default_rng(3)
    n_users, n_items, n = 12, 10, 120
    return Table({
        "user": rng.integers(0, n_users, n).astype(np.int64),
        "item": rng.integers(0, n_items, n).astype(np.int64),
        "rating": rng.integers(1, 6, n).astype(np.float64),
    })


def cb_table() -> Table:
    from mmlspark_tpu_torch.online.hashing import FeatureHasher

    rng = np.random.default_rng(5)
    h = FeatureHasher(12, 0)
    n, d, num_actions = 30, 3, 3
    shared_rows = np.empty(n, object)
    action_rows = np.empty(n, object)
    chosen = np.zeros(n, np.int64)
    cost = np.zeros(n)
    prob = np.full(n, 1.0 / num_actions)
    for i in range(n):
        idx = np.array([h("s", f"f{j}") for j in range(d)], np.uint32)
        vals = rng.normal(size=d).astype(np.float32)
        shared_rows[i] = (idx, vals)
        acts = []
        for a in range(num_actions):
            aidx = np.array([h(f"act{a}", f"x{j}") for j in range(d)],
                            np.uint32)
            acts.append((aidx, vals))
        action_rows[i] = acts
        chosen[i] = int(rng.integers(num_actions)) + 1
        cost[i] = float(rng.normal())
    return Table({"shared": shared_rows, "features": action_rows,
                  "chosen_action": chosen, "cost": cost,
                  "probability": prob})


def slice16_example(name: str):
    from mmlspark_tpu_torch import automl as AM
    from mmlspark_tpu_torch.featurize import Word2Vec
    from mmlspark_tpu_torch.isolationforest import IsolationForest
    from mmlspark_tpu_torch.models import linear as L
    from mmlspark_tpu_torch.models.bilstm import SequenceTagger
    from mmlspark_tpu_torch.nn import KNN, ConditionalKNN
    from mmlspark_tpu_torch.online import (VowpalWabbitClassifier,
                                           VowpalWabbitContextualBandit,
                                           VowpalWabbitRegressor)
    from mmlspark_tpu_torch import recommendation as R

    cpu = {"device": "cpu"}
    models = {"Word2VecModel": "Word2Vec",
              "VowpalWabbitClassificationModel": "VowpalWabbitClassifier",
              "VowpalWabbitRegressionModel": "VowpalWabbitRegressor",
              "VowpalWabbitContextualBanditModel":
                  "VowpalWabbitContextualBandit",
              "SequenceTaggerModel": "SequenceTagger", "KNNModel": "KNN",
              "ConditionalKNNModel": "ConditionalKNN",
              "TuneHyperparametersModel": "TuneHyperparameters",
              "BestModel": "FindBestModel",
              "IsolationForestModel": "IsolationForest", "SARModel": "SAR",
              "RecommendationIndexerModel": "RecommendationIndexer",
              "RankingAdapterModel": "RankingAdapter",
              "RankingTrainValidationSplitModel":
                  "RankingTrainValidationSplit"}
    if name in models:
        est, table = slice16_example(models[name])
        return est.fit(table), table
    rng = np.random.default_rng(51)
    if name == "Word2Vec":
        docs = ["bread cheese apple soup", "hammer wrench drill saw",
                "bread soup cheese", "drill hammer saw wrench"] * 3
        return Word2Vec(vector_size=8, min_count=2, epochs=1, batch_size=32,
                        **cpu), Table({"text": np.asarray(docs, object)})
    if name == "VowpalWabbitClassifier":
        return VowpalWabbitClassifier(num_passes=2, **cpu), hashed_table()
    if name == "VowpalWabbitRegressor":
        t = hashed_table()
        return VowpalWabbitRegressor(num_passes=2, **cpu), t
    if name == "VowpalWabbitContextualBandit":
        return VowpalWabbitContextualBandit(num_passes=2, num_bits=12,
                                            **cpu), cb_table()
    if name == "SequenceTagger":
        toks = np.empty(6, object)
        tags = np.empty(6, object)
        for i in range(6):
            toks[i] = ["w%d" % (j % 4) for j in range(3 + i % 2)]
            tags[i] = ["T%d" % (j % 2) for j in range(3 + i % 2)]
        return SequenceTagger(epochs=1, hidden=8, embed_dim=8, **cpu), \
            Table({"tokens": toks, "tags": tags})
    if name == "KNN":
        return KNN(k=2, **cpu), Table({
            "features": rng.normal(size=(20, 3)).astype(np.float32),
            "values": np.arange(20.0)})
    if name == "ConditionalKNN":
        conds = np.empty(20, object)
        for i in range(20):
            conds[i] = {0, 1}
        return ConditionalKNN(k=2, label_col="labels", **cpu), Table({
            "features": rng.normal(size=(20, 3)).astype(np.float32),
            "values": np.arange(20.0),
            "labels": np.asarray([i % 2 for i in range(20)]),
            "conditioner": conds})
    if name == "TuneHyperparameters":
        space = (AM.HyperparamBuilder()
                 .add_hyperparam("reg_param", AM.DiscreteHyperParam([1e-4, 1.0]))
                 .build())
        return AM.TuneHyperparameters(
            models=[L.LogisticRegression(max_iter=20, **cpu)],
            param_space=AM.GridSpace(space), evaluation_metric="accuracy",
            num_folds=2, parallelism=1, seed=2), cls_table(40)
    if name == "FindBestModel":
        t = cls_table(40)
        m1 = L.LogisticRegression(max_iter=40, **cpu).fit(t)
        m2 = L.LogisticRegression(max_iter=1, learning_rate=1e-6,
                                  **cpu).fit(t)
        return AM.FindBestModel(models=[m2, m1],
                                evaluation_metric="accuracy"), t
    if name == "IsolationForest":
        return IsolationForest(num_estimators=10, max_samples=32, **cpu), \
            Table({"features": rng.normal(size=(60, 3)).astype(np.float32)})
    if name == "SAR":
        return R.SAR(support_threshold=1, **cpu), ratings_table()
    if name == "RecommendationIndexer":
        return R.RecommendationIndexer(
            user_input_col="user", item_input_col="item",
            user_output_col="user_idx", item_output_col="item_idx"), Table({
                "user": np.asarray(["u1", "u2", "u1", "u3"]),
                "item": np.asarray(["a", "b", "c", "a"]),
                "rating": np.array([1.0, 2.0, 3.0, 4.0])})
    if name == "RankingAdapter":
        return R.RankingAdapter(recommender=R.SAR(support_threshold=1, **cpu),
                                k=3), ratings_table()
    if name == "RankingTrainValidationSplit":
        return R.RankingTrainValidationSplit(
            estimator=R.SAR(support_threshold=1, **cpu),
            param_grid=[{"similarity_function": "jaccard"}],
            evaluator=R.RankingEvaluator(metric_name="ndcgAt", k=3),
            train_ratio=0.75, seed=2), ratings_table()
    raise KeyError(name)


# the explainers and CyberML (the fuzz examples of the JAX package's
# tests/test_fuzzing_coverage.py, on the CPU)
SLICE17_EXAMPLES = [
    "TabularLIME", "TabularSHAP", "VectorLIME", "VectorSHAP", "ImageLIME",
    "ImageSHAP", "TextLIME", "TextSHAP", "SuperpixelTransformer",
    "AccessAnomaly", "AccessAnomalyModel", "ComplementAccessTransformer",
    "IdIndexer", "IdIndexerModel", "PartitionedStandardScaler",
    "PartitionedMinMaxScaler", "PartitionedScalerModel"]

# the cognitive services' stages: save/load + param equality only (their
# transform needs a live endpoint; test_torch_cognitive.py runs them
# against a mock service)
COGNITIVE_STAGES = [
    "AnalyzeInvoices", "AnalyzeLayout", "BreakSentence", "Detect",
    "DetectAnomalies", "DetectLastAnomaly", "DocumentTranslator",
    "SpeechToText", "Translate", "Transliterate", "EntityDetector",
    "KeyPhraseExtractor", "LanguageDetector", "NER", "PII", "TextSentiment",
    "AnalyzeImage", "DescribeImage", "DetectFace", "FindSimilarFace",
    "GenerateThumbnails", "GroupFaces", "IdentifyFaces", "OCR", "ReadImage",
    "RecognizeDomainSpecificContent", "TagImage", "VerifyFaces",
    "AnalyzeReceipts", "AnalyzeBusinessCards", "AnalyzeIDDocuments",
    "AnalyzeCustomModel", "GetCustomModel", "ListCustomModels",
    "DictionaryLookup", "DictionaryExamples", "SimpleDetectAnomalies",
    "SpeechToTextSDK", "ConversationTranscription", "BingImageSearch"]


# module-level scoring functions of the explained models (pickle by name)
def linear_score_fn(t):
    from mmlspark_tpu_torch.core.schema import features_matrix

    x = features_matrix(t["features"])
    w = np.array([2.0, -3.0, 0.5], np.float32)[: x.shape[1]]
    return t.with_column("scores", x @ w)


def brightness_fn(t):
    vals = np.array([np.asarray(r).mean() for r in t["image"]])
    return t.with_column("scores", vals)


def keyword_fn(t):
    vals = np.array([float("fox" in s) for s in t["text"]])
    return t.with_column("scores", vals)


def float_img_table(n=2, seed=52) -> Table:
    rng = np.random.default_rng(seed)
    imgs = np.empty(n, object)
    for i in range(n):
        imgs[i] = rng.random((24, 24, 3)).astype(np.float32)
    return Table({"image": imgs})


def slice17_example(name: str):
    from mmlspark_tpu_torch import cyber as C
    from mmlspark_tpu_torch import explainers as E
    from mmlspark_tpu_torch.core.pipeline import LambdaTransformer

    cpu = {"device": "cpu"}
    models = {"AccessAnomalyModel": "AccessAnomaly",
              "IdIndexerModel": "IdIndexer",
              "PartitionedScalerModel": "PartitionedMinMaxScaler"}
    if name in models:
        est, table = slice17_example(models[name])
        return est.fit(table), table
    rng = np.random.default_rng(53)
    vec = Table({"features": rng.normal(size=(3, 3)).astype(np.float32)})
    texts = Table({"text": np.asarray(["the quick fox", "a lazy dog"],
                                      object)})
    linear, image, text = (LambdaTransformer(fn) for fn in (
        linear_score_fn, brightness_fn, keyword_fn))
    if name == "TabularLIME":
        return E.TabularLIME(model=linear, num_samples=32, seed=1, **cpu), \
            Table({"features": rng.normal(size=(4, 3)).astype(np.float32)})
    if name == "TabularSHAP":
        return E.TabularSHAP(model=linear, num_samples=32, seed=2), vec
    if name == "VectorLIME":
        return E.VectorLIME(model=linear, num_samples=32, seed=3, **cpu), vec
    if name == "VectorSHAP":
        return E.VectorSHAP(model=linear, num_samples=32, seed=4), vec
    if name == "ImageLIME":
        return E.ImageLIME(model=image, num_samples=16, seed=5,
                           cell_size=8.0, **cpu), float_img_table()
    if name == "ImageSHAP":
        return E.ImageSHAP(model=image, num_samples=16, seed=6,
                           cell_size=8.0), float_img_table()
    if name == "TextLIME":
        return E.TextLIME(model=text, num_samples=16, seed=7, **cpu), texts
    if name == "TextSHAP":
        return E.TextSHAP(model=text, num_samples=16, seed=8), texts
    if name == "SuperpixelTransformer":
        return E.SuperpixelTransformer(input_col="image", cell_size=8.0), \
            float_img_table()
    if name == "AccessAnomaly":
        n = 80
        return C.AccessAnomaly(rank=3, max_iter=3, **cpu), Table({
            "tenant": np.zeros(n, np.int64),
            "user": rng.integers(0, 10, n).astype(np.int64),
            "res": rng.integers(0, 8, n).astype(np.int64)})
    if name == "ComplementAccessTransformer":
        n = 20
        return C.ComplementAccessTransformer(complement_ratio=1.0,
                                             seed=5), Table({
            "tenant": np.zeros(n, np.int64),
            "user": rng.integers(0, 5, n).astype(np.int64),
            "res": rng.integers(0, 5, n).astype(np.int64)})
    if name == "IdIndexer":
        n = 20
        return C.IdIndexer(input_col="user", partition_key="tenant",
                           output_col="user_idx"), Table({
            "tenant": rng.integers(0, 2, n).astype(np.int64),
            "user": rng.integers(0, 6, n).astype(np.int64)})
    if name in ("PartitionedStandardScaler", "PartitionedMinMaxScaler"):
        n = 24
        return getattr(C, name)(input_col="value", partition_key="tenant",
                                output_col="scaled"), Table({
            "tenant": rng.integers(0, 2, n).astype(np.int64),
            "value": rng.normal(size=n)})
    raise KeyError(name)


def serde_example(name: str):
    """The stage alone, for the stages whose transform needs a live HTTP
    endpoint (save/load + param equality only)."""
    from mmlspark_tpu_torch.io.http import transformers as T

    if name == "HTTPTransformer":
        return T.HTTPTransformer(concurrency=2)
    if name == "SimpleHTTPTransformer":
        return T.SimpleHTTPTransformer(input_cols=["a"],
                                       url="http://localhost:9/x")
    if name in COGNITIVE_STAGES:
        from mmlspark_tpu_torch import cognitive

        extra = {"count": 2} if name == "BingImageSearch" else {}
        return getattr(cognitive, name)(url="http://localhost:9/api",
                                        subscription_key="k", **extra)
    raise KeyError(name)


# the HTTP parsers' functions and tables (module-level, so they pickle by
# name; no network)
def row_to_request(row):
    from mmlspark_tpu_torch.io.http.schema import to_http_request

    payload = {k: (v.item() if hasattr(v, "item") else v)
               for k, v in dict(row).items()}
    return to_http_request("http://localhost:9/x", payload)


def response_status(resp):
    return None if resp is None else resp.status_code


def fake_responses_table() -> Table:
    from mmlspark_tpu_torch.io.http.schema import HTTPResponseData

    resps = np.empty(3, object)
    for i in range(3):
        resps[i] = HTTPResponseData(
            status_code=200, reason="OK",
            headers={"Content-Type": "application/json"},
            entity=b'{"v": %d}' % i)
    return Table({"response": resps})


def affine_fn(variables, batch):
    """A FunctionBundle's function (module-level, so it pickles by name):
    an affine map of flat rows and its row norms."""
    y = batch.reshape(batch.shape[0], -1) @ variables["w"] + variables["b"]
    return {"output": y, "norm": y.norm(dim=1, keepdim=True)}
