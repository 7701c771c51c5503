"""The port's stage registry lists every module that registers a stage.

`core/registry.STAGE_MODULES` is what `get_stage_class` and `all_stages`
import to fill the registry; a module that carries `@register_stage` but
is missing from the list leaves its stages unknown to a fresh
interpreter (a saved pipeline that names them does not load).  Two
checks: an AST scan of `mmlspark_tpu_torch/` for every module with a
`@register_stage` class, against the list; and, in a fresh subprocess,
`get_stage_class` of the deep-vision stages (the ones the list missed).
"""
import ast
import functools
import json
import os
import subprocess
import sys

import pytest

from mmlspark_tpu_torch.core import registry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mmlspark_tpu_torch")


def _is_register_stage(dec: ast.expr) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = target.attr if isinstance(target, ast.Attribute) else \
        getattr(target, "id", None)
    return name == "register_stage"


def _registering_modules():
    """module name -> the classes it decorates with `@register_stage`."""
    out = {}
    for d, _subdirs, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            classes = [n.name for n in ast.walk(tree)
                       if isinstance(n, ast.ClassDef)
                       and any(_is_register_stage(x) for x in n.decorator_list)]
            if classes:
                rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                out[rel] = classes
    return out


def test_the_scan_finds_the_known_stage_modules():
    mods = _registering_modules()
    for m, cls in (("mmlspark_tpu_torch.models.torch_model", "TorchModel"),
                   ("mmlspark_tpu_torch.models.deep_vision",
                    "DeepVisionClassifier"),
                   ("mmlspark_tpu_torch.ops.image_stages", "UnrollImage")):
        assert cls in mods.get(m, []), (m, cls, mods)


@pytest.mark.parametrize("module", sorted(_registering_modules()))
def test_every_registering_module_is_in_stage_modules(module):
    assert module in registry.STAGE_MODULES, (
        f"{module} registers {_registering_modules()[module]} but is not in "
        f"core/registry.STAGE_MODULES")


@pytest.mark.parametrize("name", ["DeepVisionClassifier", "DeepVisionModel"])
def test_get_stage_class_resolves_in_a_fresh_interpreter(name):
    script = (
        "from mmlspark_tpu_torch.core import registry\n"
        f"cls = registry.get_stage_class({name!r})\n"
        "assert cls.__module__ == 'mmlspark_tpu_torch.models.deep_vision', "
        "cls.__module__\n"
        f"assert {name!r} in registry.all_stages()\n"
        "print('ok', cls.__name__)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == f"ok {name}", \
        proc.stdout + proc.stderr


@pytest.mark.parametrize("name,module", [
    ("GBDTClassifier", "mmlspark_tpu_torch.gbdt.estimators"),
    ("LightGBMRanker", "mmlspark_tpu_torch.gbdt.estimators"),
    ("VowpalWabbitFeaturizer", "mmlspark_tpu_torch.online.featurizer"),
    ("ComputeModelStatistics", "mmlspark_tpu_torch.models.statistics")])
def test_the_gbdt_slice_stages_resolve_in_a_fresh_interpreter(name, module):
    script = (
        "from mmlspark_tpu_torch.core import registry\n"
        f"cls = registry.get_stage_class({name!r})\n"
        f"assert cls.__module__ == {module!r}, cls.__module__\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


# the classic-ML slice's 46 stages, by the module that registers each
CLASSIC_STAGES = {
    "mmlspark_tpu_torch.stages.basic": [
        "DropColumns", "SelectColumns", "RenameColumn", "Repartition",
        "Cacher", "Explode", "UDFTransformer", "MultiColumnAdapter",
        "EnsembleByKey", "ClassBalancer", "ClassBalancerModel",
        "SummarizeData", "Timer", "TimerModel", "StratifiedRepartition",
        "PartitionConsolidator"],
    "mmlspark_tpu_torch.stages.batching": [
        "FixedMiniBatchTransformer", "DynamicMiniBatchTransformer",
        "TimeIntervalMiniBatchTransformer", "FlattenBatch"],
    "mmlspark_tpu_torch.stages.text": ["TextPreprocessor", "UnicodeNormalize"],
    "mmlspark_tpu_torch.featurize.value_indexer": [
        "ValueIndexer", "ValueIndexerModel", "IndexToValue"],
    "mmlspark_tpu_torch.featurize.clean_missing": [
        "CleanMissingData", "CleanMissingDataModel"],
    "mmlspark_tpu_torch.featurize.featurize": [
        "Featurize", "FeaturizeModel", "DataConversion", "CountSelector",
        "CountSelectorModel"],
    "mmlspark_tpu_torch.featurize.text": [
        "TextFeaturizer", "TextFeaturizerModel", "MultiNGram", "PageSplitter"],
    "mmlspark_tpu_torch.featurize.tokenizer": ["BPETokenizer",
                                               "BPETokenizerModel"],
    "mmlspark_tpu_torch.models.linear": [
        "LogisticRegression", "LogisticRegressionModel", "LinearRegression",
        "LinearRegressionModel"],
    "mmlspark_tpu_torch.models.train_classifier": [
        "TrainClassifier", "TrainedClassifierModel", "TrainRegressor",
        "TrainedRegressorModel"],
}
CLASSIC = [(n, m) for m, names in CLASSIC_STAGES.items() for n in names]


@functools.lru_cache(maxsize=None)
def _fresh_resolution() -> dict:
    """name -> module of `get_stage_class(name)` for every classic-ML
    stage, resolved by name in one fresh interpreter."""
    names = [n for n, _ in CLASSIC]
    script = (
        "import json\n"
        "from mmlspark_tpu_torch.core import registry\n"
        f"names = {names!r}\n"
        "print(json.dumps({n: registry.get_stage_class(n).__module__ "
        "for n in names}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_classic_slice_has_46_stages():
    assert len(CLASSIC) == len(dict(CLASSIC)) == 46
    mods = _registering_modules()
    for module, names in CLASSIC_STAGES.items():
        assert sorted(mods[module]) == sorted(names), module


@pytest.mark.parametrize("name,module", CLASSIC, ids=[n for n, _ in CLASSIC])
def test_the_classic_slice_stages_resolve_in_a_fresh_interpreter(name,
                                                                 module):
    assert _fresh_resolution()[name] == module


# the rest of classic ML's 28 stages (Word2Vec, the online learners, the
# tagger, KNN, automl, the isolation forest, recommendation)
REST_STAGES = {
    "mmlspark_tpu_torch.featurize.word2vec": ["Word2Vec", "Word2VecModel"],
    "mmlspark_tpu_torch.online.learners": [
        "VowpalWabbitClassifier", "VowpalWabbitClassificationModel",
        "VowpalWabbitRegressor", "VowpalWabbitRegressionModel"],
    "mmlspark_tpu_torch.online.contextual_bandit": [
        "VowpalWabbitContextualBandit", "VowpalWabbitContextualBanditModel"],
    "mmlspark_tpu_torch.models.bilstm": ["SequenceTagger",
                                         "SequenceTaggerModel"],
    "mmlspark_tpu_torch.nn.knn": ["KNN", "KNNModel", "ConditionalKNN",
                                  "ConditionalKNNModel"],
    "mmlspark_tpu_torch.automl.tune": ["TuneHyperparameters",
                                       "TuneHyperparametersModel"],
    "mmlspark_tpu_torch.automl.find_best": ["FindBestModel", "BestModel"],
    "mmlspark_tpu_torch.isolationforest.iforest": ["IsolationForest",
                                                   "IsolationForestModel"],
    "mmlspark_tpu_torch.recommendation.indexer": [
        "RecommendationIndexer", "RecommendationIndexerModel"],
    "mmlspark_tpu_torch.recommendation.ranking": ["RankingAdapter",
                                                  "RankingAdapterModel"],
    "mmlspark_tpu_torch.recommendation.sar": ["SAR", "SARModel"],
    "mmlspark_tpu_torch.recommendation.tvs": [
        "RankingTrainValidationSplit", "RankingTrainValidationSplitModel"],
}
REST = [(n, m) for m, names in REST_STAGES.items() for n in names]


@functools.lru_cache(maxsize=None)
def _fresh_rest_resolution() -> dict:
    names = [n for n, _ in REST]
    script = (
        "import json\n"
        "from mmlspark_tpu_torch.core import registry\n"
        f"names = {names!r}\n"
        "print(json.dumps({n: registry.get_stage_class(n).__module__ "
        "for n in names}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_rest_of_classic_ml_registers_its_stages():
    mods = _registering_modules()
    for module, names in REST_STAGES.items():
        assert sorted(mods[module]) == sorted(names), module
    assert len(REST) == len(dict(REST)) == 28


@pytest.mark.parametrize("name,module", REST, ids=[n for n, _ in REST])
def test_the_rest_of_classic_ml_resolves_in_a_fresh_interpreter(name,
                                                                 module):
    assert _fresh_rest_resolution()[name] == module


# the explainers', CyberML's and the cognitive services' 57 stages
SLICE17_STAGES = {
    "mmlspark_tpu_torch.explainers.superpixel": ["SuperpixelTransformer"],
    "mmlspark_tpu_torch.explainers.tabular": [
        "TabularLIME", "VectorLIME", "TabularSHAP", "VectorSHAP"],
    "mmlspark_tpu_torch.explainers.image": ["ImageLIME", "ImageSHAP"],
    "mmlspark_tpu_torch.explainers.text": ["TextLIME", "TextSHAP"],
    "mmlspark_tpu_torch.cyber.access_anomaly": [
        "ComplementAccessTransformer", "AccessAnomaly", "AccessAnomalyModel"],
    "mmlspark_tpu_torch.cyber.feature": [
        "IdIndexer", "IdIndexerModel", "PartitionedStandardScaler",
        "PartitionedMinMaxScaler", "PartitionedScalerModel"],
    "mmlspark_tpu_torch.cognitive.vision": [
        "OCR", "AnalyzeImage", "ReadImage", "GenerateThumbnails", "TagImage",
        "DescribeImage", "RecognizeDomainSpecificContent", "DetectFace",
        "FindSimilarFace", "GroupFaces", "IdentifyFaces", "VerifyFaces"],
    "mmlspark_tpu_torch.cognitive.text_analytics": [
        "TextSentiment", "LanguageDetector", "EntityDetector",
        "KeyPhraseExtractor", "NER", "PII"],
    "mmlspark_tpu_torch.cognitive.services": [
        "SpeechToText", "DetectLastAnomaly", "DetectAnomalies",
        "SimpleDetectAnomalies", "Translate", "Detect", "BreakSentence",
        "Transliterate", "DictionaryLookup", "DictionaryExamples",
        "DocumentTranslator", "AnalyzeLayout", "AnalyzeInvoices",
        "AnalyzeReceipts", "AnalyzeBusinessCards", "AnalyzeIDDocuments",
        "AnalyzeCustomModel", "GetCustomModel", "ListCustomModels",
        "BingImageSearch"],
    "mmlspark_tpu_torch.cognitive.speech": ["SpeechToTextSDK",
                                            "ConversationTranscription"],
}
SLICE17 = [(n, m) for m, names in SLICE17_STAGES.items() for n in names]


@functools.lru_cache(maxsize=None)
def _fresh_slice17_resolution() -> dict:
    names = [n for n, _ in SLICE17]
    script = (
        "import json\n"
        "from mmlspark_tpu_torch.core import registry\n"
        f"names = {names!r}\n"
        "print(json.dumps({n: registry.get_stage_class(n).__module__ "
        "for n in names}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_explainers_cyber_and_cognitive_register_57_stages():
    mods = _registering_modules()
    for module, names in SLICE17_STAGES.items():
        assert sorted(mods[module]) == sorted(names), module
    assert len(SLICE17) == len(dict(SLICE17)) == 57
    assert len(registry.all_stages()) == 161


@pytest.mark.parametrize("name,module", SLICE17, ids=[n for n, _ in SLICE17])
def test_the_slice17_stages_resolve_in_a_fresh_interpreter(name, module):
    assert _fresh_slice17_resolution()[name] == module
