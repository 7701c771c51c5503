"""mmlspark_tpu_torch imports nothing of JAX, flax or the JAX package.

Two checks: every module of the port (and chip_smoke.py) imports in a
fresh interpreter whose `sys.meta_path` refuses `jax`, `flax`, `jaxlib`,
`optax` and `mmlspark_tpu` (the exact name and its submodules — note that
"mmlspark_tpu_torch" starts with "mmlspark_tpu", so a bare prefix test
would be wrong); and an AST scan of the sources finds no such import.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "mmlspark_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "mmlspark_tpu")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


# the port's own tools: run as scripts, importing mmlspark_tpu_torch only
TOOLS = [os.path.join(ROOT, "tools", f"{n}.py")
         for n in ("torch_fleet_soak", "torch_chaos_soak")]


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")] + TOOLS
    for d, _subdirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return out


def _modules():
    mods = []
    for path in _sources()[1 + len(TOOLS):]:
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(mods)


def test_blocked_names_are_exact():
    assert _blocked("mmlspark_tpu") and _blocked("mmlspark_tpu.ops.image")
    assert _blocked("jax.numpy") and _blocked("flax")
    assert not _blocked("mmlspark_tpu_torch")
    assert not _blocked("mmlspark_tpu_torch.ops.image_kernels")
    assert not _blocked("jaxtyping")


def test_the_native_jpeg_decoder_is_covered():
    """The port's host JPEG decoder is one of the modules both checks
    below scan and import."""
    assert "mmlspark_tpu_torch.native" in _modules()
    assert os.path.join(PKG, "native", "__init__.py") in _sources()


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _blocked(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _blocked(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    script = f"""
import importlib, importlib.abc, runpy, sys
BLOCKED = {BLOCKED!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for m in {_modules()!r}:
    importlib.import_module(m)
# chip_smoke.py's and the tools' own imports (main() not run here)
for path in {[os.path.join(ROOT, "chip_smoke.py")] + TOOLS!r}:
    runpy.run_path(path, run_name="not_main")
leaked = [m for m in sys.modules
          if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), \
        proc.stdout + proc.stderr


def test_the_scan_covers_the_serving_slice():
    """The checks above walk the whole package; the decode-serving slice's
    modules are among what they check."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.serving", "mmlspark_tpu_torch.serving.batcher",
              "mmlspark_tpu_torch.serving.dsl", "mmlspark_tpu_torch.serving.server",
              "mmlspark_tpu_torch.serving.journal", "mmlspark_tpu_torch.io.http",
              "mmlspark_tpu_torch.io.http.schema",
              "mmlspark_tpu_torch.ops.paged_attention",
              "mmlspark_tpu_torch.ops.quant"):
        assert m in mods, m


def test_the_scan_covers_the_image_stage_slice():
    """... and so are the image stages' and the compressed wire's."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.ops.image", "mmlspark_tpu_torch.ops.image_kernels",
              "mmlspark_tpu_torch.ops.image_stages",
              "mmlspark_tpu_torch.ops.wire_codec", "mmlspark_tpu_torch.io.feed"):
        assert m in mods, m


def test_the_scan_covers_the_persistence_and_int8_slice():
    """... and so are stage persistence's, the file readers' and the int8
    layers'."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.core.serialize",
              "mmlspark_tpu_torch.core.params",
              "mmlspark_tpu_torch.io.binary", "mmlspark_tpu_torch.io.image",
              "mmlspark_tpu_torch.models.bundle",
              "mmlspark_tpu_torch.ops.quant"):
        assert m in mods, m


def test_the_scan_covers_the_moe_speculative_and_distillation_slice():
    """... and so are the MoE blocks', beam search's, speculative
    decoding's (generate and the batcher) and distillation's."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.models.transformer",
              "mmlspark_tpu_torch.models.vit",
              "mmlspark_tpu_torch.models.bundle",
              "mmlspark_tpu_torch.models.training",
              "mmlspark_tpu_torch.models.generation",
              "mmlspark_tpu_torch.serving.batcher",
              "mmlspark_tpu_torch.serving.dsl"):
        assert m in mods, m


def test_the_scan_covers_the_fleet_slice():
    """... and so are the serving layers above one server: the HTTP
    clients and stages, the registry, the fleet gateway and its
    telemetry, rollout, autoscale and port forwarding."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.core.shared",
              "mmlspark_tpu_torch.core.telemetry.fleet",
              "mmlspark_tpu_torch.core.telemetry.spans",
              "mmlspark_tpu_torch.core.telemetry.exposition",
              "mmlspark_tpu_torch.io.http.clients",
              "mmlspark_tpu_torch.io.http.transformers",
              "mmlspark_tpu_torch.serving.registry",
              "mmlspark_tpu_torch.serving.fleet",
              "mmlspark_tpu_torch.serving.rollout",
              "mmlspark_tpu_torch.serving.autoscale",
              "mmlspark_tpu_torch.serving.port_forwarding"):
        assert m in mods, m


def test_the_scan_covers_the_gbdt_slice():
    """... and so are the GBDT engine's, the hashed featurizer's and the
    model statistics'."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.gbdt", "mmlspark_tpu_torch.gbdt.binning",
              "mmlspark_tpu_torch.gbdt.objectives",
              "mmlspark_tpu_torch.gbdt.histogram",
              "mmlspark_tpu_torch.gbdt.tree", "mmlspark_tpu_torch.gbdt.sparse",
              "mmlspark_tpu_torch.gbdt.boosting",
              "mmlspark_tpu_torch.gbdt.delegate",
              "mmlspark_tpu_torch.gbdt.aggregator",
              "mmlspark_tpu_torch.gbdt.estimators",
              "mmlspark_tpu_torch.online", "mmlspark_tpu_torch.online.hashing",
              "mmlspark_tpu_torch.online.featurizer",
              "mmlspark_tpu_torch.models.statistics"):
        assert m in mods, m


def test_the_scan_covers_the_classic_ml_slice():
    """... and so are the classic-ML foundation's (the batching engines,
    the plumbing stages, featurization, the host library, parquet, plot,
    the utilities) and the linear learners' with TrainClassifier /
    TrainRegressor."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.core.batching",
              "mmlspark_tpu_torch.stages", "mmlspark_tpu_torch.stages.basic",
              "mmlspark_tpu_torch.stages.batching",
              "mmlspark_tpu_torch.stages.text",
              "mmlspark_tpu_torch.featurize",
              "mmlspark_tpu_torch.featurize.value_indexer",
              "mmlspark_tpu_torch.featurize.clean_missing",
              "mmlspark_tpu_torch.featurize.featurize",
              "mmlspark_tpu_torch.featurize.text",
              "mmlspark_tpu_torch.featurize.tokenizer",
              "mmlspark_tpu_torch.native", "mmlspark_tpu_torch.io.binary",
              "mmlspark_tpu_torch.io.parquet", "mmlspark_tpu_torch.plot",
              "mmlspark_tpu_torch.utils.stopwatch",
              "mmlspark_tpu_torch.utils.async_utils",
              "mmlspark_tpu_torch.utils.fault_tolerance",
              "mmlspark_tpu_torch.models.linear",
              "mmlspark_tpu_torch.models.train_classifier"):
        assert m in mods, m


def test_the_scan_covers_the_rest_of_classic_ml():
    """... and so are Word2Vec's, the online learners' and K1's, the
    convnets' and the tagger's, KNN's, automl's, the isolation forest's
    and recommendation's."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.featurize.word2vec",
              "mmlspark_tpu_torch.online.learners",
              "mmlspark_tpu_torch.online.contextual_bandit",
              "mmlspark_tpu_torch.ops.online_pass",
              "mmlspark_tpu_torch.ops.topk",
              "mmlspark_tpu_torch.models.convnets",
              "mmlspark_tpu_torch.models.bilstm",
              "mmlspark_tpu_torch.nn", "mmlspark_tpu_torch.nn.ball_tree",
              "mmlspark_tpu_torch.nn.knn", "mmlspark_tpu_torch.automl",
              "mmlspark_tpu_torch.automl.param_space",
              "mmlspark_tpu_torch.automl.find_best",
              "mmlspark_tpu_torch.automl.tune",
              "mmlspark_tpu_torch.isolationforest",
              "mmlspark_tpu_torch.isolationforest.iforest",
              "mmlspark_tpu_torch.recommendation",
              "mmlspark_tpu_torch.recommendation.indexer",
              "mmlspark_tpu_torch.recommendation.ranking",
              "mmlspark_tpu_torch.recommendation.sar",
              "mmlspark_tpu_torch.recommendation.tvs"):
        assert m in mods, m


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_the_repo_tools(path):
    """`tools/` is the JAX package's tooling (the bench gate the JAX
    rollout imports among it): no port module and not chip_smoke.py
    imports it, at module level or inside a function."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if a.name == "tools" or a.name.startswith("tools.")]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and (node.module == "tools"
                                or node.module.startswith("tools.")):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_the_scan_covers_the_explainers_cyber_and_the_service_layer():
    """... and so are the explainers', CyberML's, the cognitive services',
    the PowerBI writer's and the binding generator's."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.explainers",
              "mmlspark_tpu_torch.explainers.regression",
              "mmlspark_tpu_torch.explainers.base",
              "mmlspark_tpu_torch.explainers.superpixel",
              "mmlspark_tpu_torch.explainers.tabular",
              "mmlspark_tpu_torch.explainers.image",
              "mmlspark_tpu_torch.explainers.text",
              "mmlspark_tpu_torch.cyber", "mmlspark_tpu_torch.cyber.feature",
              "mmlspark_tpu_torch.cyber.dataset",
              "mmlspark_tpu_torch.cyber.access_anomaly",
              "mmlspark_tpu_torch.cognitive",
              "mmlspark_tpu_torch.cognitive.base",
              "mmlspark_tpu_torch.cognitive.vision",
              "mmlspark_tpu_torch.cognitive.text_analytics",
              "mmlspark_tpu_torch.cognitive.services",
              "mmlspark_tpu_torch.cognitive.speech",
              "mmlspark_tpu_torch.cognitive.search",
              "mmlspark_tpu_torch.io.powerbi",
              "mmlspark_tpu_torch.codegen",
              "mmlspark_tpu_torch.codegen.generate"):
        assert m in mods, m


def test_the_scan_covers_device_telemetry_and_the_distributed_slice():
    """... and so are the device telemetry's, the mesh and rule tables',
    the sequence-parallel attention's, the pipeline's, the elastic
    runtime's, the topology's and the 3D trainer's — and the gloo rank
    worker the distributed tests spawn imports no JAX either."""
    mods = set(_modules())
    for m in ("mmlspark_tpu_torch.core.telemetry.device",
              "mmlspark_tpu_torch.parallel",
              "mmlspark_tpu_torch.parallel.mesh",
              "mmlspark_tpu_torch.parallel.sharding_rules",
              "mmlspark_tpu_torch.parallel.ring_attention",
              "mmlspark_tpu_torch.parallel.pipeline",
              "mmlspark_tpu_torch.parallel.distributed",
              "mmlspark_tpu_torch.utils.cluster",
              "mmlspark_tpu_torch.models.trainer3d"):
        assert m in mods, m
    worker = os.path.join(ROOT, "tests", "torch_dist_worker.py")
    with open(worker) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_blocked(n) for n in names), names


def test_the_scan_covers_the_data_side_of_distributed():
    """... and so are the sharded feed's and the two soak tools' (the
    AST scan reads every import of a tool, those inside its functions
    too)."""
    assert "mmlspark_tpu_torch.io.shard_put" in set(_modules())
    for tool in TOOLS:
        assert tool in _sources()
