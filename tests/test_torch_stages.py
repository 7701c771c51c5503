"""The port's batching engines (mmlspark_tpu_torch.core.batching), plumbing
stages (mmlspark_tpu_torch.stages), `Trie` and utilities (`StopWatch`,
`bounded_parallel_map`, `retry_with_timeout`) held against the JAX
package's on the same inputs, made from seeds with numpy.

Everything here is host numpy in both packages, so outputs are equal:
the same columns, dtypes, values and metadata (tests/torch_tables.py),
NaN equal to NaN.  Timers and the consolidator's grace period are the
only clocks; their outputs are compared, not their times.
"""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mmlspark_tpu.core.batching as JB
import mmlspark_tpu.stages.basic as JSB
import mmlspark_tpu.stages.batching as JSM
import mmlspark_tpu.stages.text as JST
from mmlspark_tpu import Table as JTable

import mmlspark_tpu_torch.core.batching as PB
import mmlspark_tpu_torch.stages.basic as PSB
import mmlspark_tpu_torch.stages.batching as PSM
import mmlspark_tpu_torch.stages.text as PST
from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch.core.telemetry import gauge as p_gauge

from torch_tables import assert_same_table

torch.set_num_threads(2)

J = SimpleNamespace(basic=JSB, mb=JSM, text=JST, Table=JTable)
P = SimpleNamespace(basic=PSB, mb=PSM, text=PST, Table=PTable)


# module-level functions: picklable, the same object for both packages
def square(v):
    return v * v


def plus_one(v):
    return v + 1


def add(a, b):
    return a + b


def num_cols(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return {"value": rng.normal(size=n),
            "k": np.asarray((list("abc") * n)[:n]),
            "label": (rng.random(n) > 0.5).astype(np.float64),
            "vec": rng.normal(size=(n, 3)).astype(np.float32)}


def text_cols():
    return {"text": np.asarray(
        ["the quick brown fox jumps over the lazy dog",
         "Ｃａｆé naïve ﬁancé ＡＢＣ",
         "how vexingly quick daft zebras jump",
         "the five boxing wizards jump quickly"] * 3, object)}


def list_cols():
    xs = np.empty(4, object)
    for i in range(4):
        xs[i] = list(range(i))  # the first row is empty
    return {"xs": xs, "id": np.arange(4), "w": np.arange(4) * 0.5}


def inner_udf(m):
    stage = m.basic.UDFTransformer(udf=plus_one)
    stage.uid = "inner"
    return stage


# name -> factory(ns) -> (stage, table)
CASES = {
    "Cacher": lambda m: (m.basic.Cacher(), m.Table(num_cols())),
    "DropColumns": lambda m: (m.basic.DropColumns(cols=["k", "vec"]),
                              m.Table(num_cols())),
    "SelectColumns": lambda m: (m.basic.SelectColumns(cols=["vec", "value"]),
                                m.Table(num_cols())),
    "RenameColumn": lambda m: (m.basic.RenameColumn(input_col="value",
                                                    output_col="v2"),
                               m.Table(num_cols())),
    "Repartition": lambda m: (m.basic.Repartition(n=3), m.Table(num_cols())),
    "Explode": lambda m: (m.basic.Explode(input_col="xs"),
                          m.Table(list_cols())),
    "UDFTransformer": lambda m: (m.basic.UDFTransformer(
        input_col="value", output_col="sq", udf=square), m.Table(num_cols())),
    "UDFTransformer-rows": lambda m: (m.basic.UDFTransformer(
        input_cols=["value", "label"], output_col="s", udf=add),
        m.Table(num_cols())),
    "MultiColumnAdapter": lambda m: (m.basic.MultiColumnAdapter(
        base_stage=inner_udf(m),
        input_cols=["value", "label"], output_cols=["v1", "l1"]),
        m.Table(num_cols())),
    "EnsembleByKey": lambda m: (m.basic.EnsembleByKey(
        keys=["k"], cols=["value", "vec"]), m.Table(num_cols())),
    "EnsembleByKey-rows": lambda m: (m.basic.EnsembleByKey(
        keys=["k"], cols=["value", "vec"], collapse_group=False),
        m.Table(num_cols())),
    "SummarizeData": lambda m: (m.basic.SummarizeData(), m.Table({
        "x": np.array([1.0, np.nan, 3.0, 4.0, 2.5]),
        "i": np.arange(5), "s": np.asarray(["a", None, "b", "a", "c"],
                                           object)})),
    "SummarizeData-counts": lambda m: (m.basic.SummarizeData(
        basic=False, percentiles=False), m.Table(num_cols())),
    "StratifiedRepartition-equal": lambda m: (m.basic.StratifiedRepartition(
        n=4, label_col="k"), m.Table(num_cols())),
    "StratifiedRepartition-original": lambda m: (
        m.basic.StratifiedRepartition(n=5, mode="original"),
        m.Table(num_cols())),
    "StratifiedRepartition-mixed": lambda m: (m.basic.StratifiedRepartition(
        n=3, label_col="k", mode="mixed", seed=7), m.Table(num_cols())),
    "FixedMiniBatchTransformer": lambda m: (m.mb.FixedMiniBatchTransformer(
        batch_size=5), m.Table(num_cols(23))),
    "DynamicMiniBatchTransformer": lambda m: (
        m.mb.DynamicMiniBatchTransformer(max_batch_size=7),
        m.Table(num_cols())),
    "DynamicMiniBatchTransformer-one": lambda m: (
        m.mb.DynamicMiniBatchTransformer(), m.Table(num_cols())),
    # a flush interval no run reaches: batches by max_batch_size alone
    "TimeIntervalMiniBatchTransformer": lambda m: (
        m.mb.TimeIntervalMiniBatchTransformer(interval_ms=10 ** 7,
                                              max_batch_size=8),
        m.Table(num_cols())),
    "FlattenBatch": lambda m: (m.mb.FlattenBatch(),
                               m.mb.FixedMiniBatchTransformer(
                                   batch_size=5).transform(
                                       m.Table(num_cols(23)))),
    "TextPreprocessor": lambda m: (m.text.TextPreprocessor(
        input_col="text", output_col="clean",
        map={"quick": "fast", "qu": "QU", "the": "a", "lazy": ""}),
        m.Table(text_cols())),
    "TextPreprocessor-NFKC": lambda m: (m.text.TextPreprocessor(
        input_col="text", output_col="clean", map={"fi": "f-i"},
        normalize_func="NFKC"), m.Table(text_cols())),
    "TextPreprocessor-lower": lambda m: (m.text.TextPreprocessor(
        input_col="text", output_col="clean", map={"c": "k"},
        normalize_func="lower"), m.Table(text_cols())),
    "UnicodeNormalize": lambda m: (m.text.UnicodeNormalize(
        input_col="text", output_col="norm"), m.Table(text_cols())),
    "UnicodeNormalize-NFC": lambda m: (m.text.UnicodeNormalize(
        input_col="text", output_col="norm", form="NFC", lower=False),
        m.Table(text_cols())),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_transform_equals_the_jax_package(case):
    js, jt = CASES[case](J)
    ps, pt = CASES[case](P)
    assert_same_table(jt, pt)
    assert_same_table(js.transform(jt), ps.transform(pt))


@pytest.mark.parametrize("labels", [
    np.asarray(list("aabbbc")), np.array([0.0, 1.0, 1.0, 1.0, 2.0, 2.0]),
    np.array([3, 3, 3, 1])])
def test_class_balancer_equals_the_jax_package(labels):
    jm = JSB.ClassBalancer(input_col="y").fit(JTable({"y": labels}))
    pm = PSB.ClassBalancer(input_col="y").fit(PTable({"y": labels}))
    assert jm.weights == pm.weights
    assert all(type(a) is type(b) for a, b in zip(jm.weights, pm.weights))
    # an unseen label gets NaN, as the reference's left join
    probe = np.concatenate([labels, labels[:1]])
    if labels.dtype.kind == "U":
        probe[-1] = "z"
    else:
        probe[-1] = 99
    assert_same_table(jm.transform(JTable({"y": probe})),
                      pm.transform(PTable({"y": probe})))


def test_ensemble_by_two_keys_fails_as_in_the_jax_package():
    """Two key columns build `np.array([tuple, ...], dtype=object)`, which
    numpy makes 2-D, so a key is an unhashable row array: the JAX package
    raises TypeError there, and its copy does the same (ROADMAP queue C,
    "Not port faults")."""
    for m, table in ((JSB, JTable), (PSB, PTable)):
        with pytest.raises(TypeError, match="unhashable"):
            m.EnsembleByKey(keys=["k", "label"], cols=["value"]).transform(
                table(num_cols()))


def test_class_balancer_refuses_an_empty_table():
    with pytest.raises(ValueError, match="empty"):
        PSB.ClassBalancer(input_col="y").fit(PTable({"y": np.array([])}))


def test_timer_wraps_an_estimator_and_a_transformer():
    from mmlspark_tpu.featurize.clean_missing import CleanMissingData as JC
    from mmlspark_tpu_torch.featurize.clean_missing import \
        CleanMissingData as PC

    cols = {"x": np.array([1.0, np.nan, 4.0])}
    for stage_j, stage_p in (
            (JC(input_cols=["x"]), PC(input_cols=["x"])),
            (JSB.UDFTransformer(input_col="x", output_col="y", udf=square),
             PSB.UDFTransformer(input_col="x", output_col="y", udf=square))):
        jm = JSB.Timer(stage=stage_j).fit(JTable(cols))
        pm = PSB.Timer(stage=stage_p).fit(PTable(cols))
        assert pm.last_fit_time >= 0.0
        assert_same_table(jm.transform(JTable(cols)),
                          pm.transform(PTable(cols)))
        assert pm.last_transform_time > 0.0


@pytest.mark.parametrize("stage,cols", [
    (lambda m: m.DropColumns(cols=["nope"]), ["a"]),
    (lambda m: m.SelectColumns(cols=["nope"]), ["a"])])
def test_schema_checks_refuse_missing_columns(stage, cols):
    for m in (JSB, PSB):
        with pytest.raises(ValueError, match="missing columns"):
            stage(m).transform_schema(cols)
    assert PSB.DropColumns(cols=["a"]).transform_schema(["a", "b"]) == ["b"]


def test_stratified_repartition_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        PSB.StratifiedRepartition(n=2, mode="nope").transform(
            PTable(num_cols()))


def test_stratified_repartition_default_is_one_shard_on_the_cpu():
    """Without `n` the port asks `utils.cluster.get_num_shards`: 1 without
    a card and outside a process group (the JAX package asks
    jax.device_count(), 8 under this suite's virtual mesh); every row
    lands in partition 0."""
    from mmlspark_tpu_torch.utils.cluster import get_num_shards

    assert not torch.cuda.is_available()
    assert get_num_shards() == 1
    out = PSB.StratifiedRepartition(label_col="k").transform(
        PTable(num_cols()))
    assert out.get_meta("__partitioning__") == {"num_partitions": 1}
    assert not out["__partition__"].any()
    assert out["__partition__"].dtype == np.int32


def test_flatten_batch_refuses_misaligned_batch_rows():
    batched = PSM.FixedMiniBatchTransformer(batch_size=4).transform(
        PTable({"a": np.arange(4), "b": np.arange(4.0)}))
    bad = batched.with_column("b", [np.arange(3.0)])
    with pytest.raises(ValueError, match="mismatched"):
        PSM.FlattenBatch().transform(bad)


def test_time_interval_batches_flush_on_the_clock():
    """A slow row source: the port's batcher flushes every interval, as
    the JAX package's does (same rule, host clock)."""
    def slow(n):
        for i in range(n):
            time.sleep(0.004)
            yield i

    for mod in (JB, PB):
        batches = list(mod.time_interval_batcher(slow(12), interval_ms=10))
        assert sum(batches, []) == list(range(12))
        assert len(batches) >= 3


def test_has_mini_batcher_defaults_to_a_fixed_batcher():
    class Staged(PSM.HasMiniBatcher, PSM.Transformer):
        pass

    got = Staged().get_mini_batcher()
    assert isinstance(got, PSM.FixedMiniBatchTransformer)
    assert got.batch_size == 32


def test_partition_consolidator_funnels_concurrent_callers():
    """Three concurrent transforms: one elected caller returns every row,
    the others none (PartitionConsolidator.scala's election)."""
    stage = PSB.PartitionConsolidator(grace_period_ms=100)
    tables = [PTable({"i": np.arange(3) + 10 * k}) for k in range(3)]
    out = [None] * 3
    start = threading.Barrier(3)

    def run(k):
        start.wait()
        out[k] = stage.transform(tables[k])

    threads = [threading.Thread(target=run, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    sizes = sorted(t.num_rows for t in out)
    assert sizes == [0, 0, 9]
    full = next(t for t in out if t.num_rows)
    assert sorted(full["i"].tolist()) == [0, 1, 2, 10, 11, 12, 20, 21, 22]
    # a lone caller gets its own rows back after the grace period
    assert_same_table(
        JSB.PartitionConsolidator(grace_period_ms=10).transform(tables[1]),
        PSB.PartitionConsolidator(grace_period_ms=10).transform(tables[1]))


# ---- the Trie -----------------------------------------------------------

TRIE_MAPS = [{}, {"a": "1", "ab": "2", "abc": "3"}, {"ab": "X", "b": "Y"},
             {"the": "", "th": "T", "e": "E"}, {"ü": "ue", "ß": "ss"}]


@pytest.mark.parametrize("mapping", TRIE_MAPS, ids=range(len(TRIE_MAPS)))
def test_trie_longest_match_equals_the_jax_package(mapping):
    rng = np.random.default_rng(len(mapping))
    alphabet = list("abcethüß ")
    texts = ["", "abcabab", "the theme", "Straße über"] + [
        "".join(rng.choice(alphabet, int(rng.integers(0, 30))))
        for _ in range(40)]
    jt, pt = JST.Trie(mapping), PST.Trie(mapping)
    for s in texts:
        assert pt.map_text(s) == jt.map_text(s), s


def test_trie_put_overrides_a_key():
    t = PST.Trie({"ab": "1"})
    t.put("ab", "2")
    t.put("abc", "3")
    assert t.map_text("abab abc") == "22 3"


# ---- core/batching --------------------------------------------------------

@pytest.mark.parametrize("n,size", [(0, 3), (7, 3), (9, 3), (5, 10)])
def test_fixed_batcher_equals_the_jax_package(n, size):
    assert list(PB.fixed_batcher(range(n), size)) == \
        list(JB.fixed_batcher(range(n), size))


@pytest.mark.parametrize("n,size,buffer", [(10, 3, 1), (10, 3, 2),
                                           (0, 4, 2), (64, 8, 4)])
def test_fixed_buffered_batcher_equals_the_jax_package(n, size, buffer):
    got = list(PB.FixedBufferedBatcher(iter(range(n)), size, buffer))
    assert got == list(JB.FixedBufferedBatcher(iter(range(n)), size, buffer))
    assert got == list(PB.fixed_batcher(range(n), size))


@pytest.mark.parametrize("n", [0, 1, 50])
def test_dynamic_buffered_batcher_keeps_every_item_in_order(n):
    """Its batch sizes follow the threads' timing in both packages; the
    items, their order and the batch cap do not."""
    got = list(PB.DynamicBufferedBatcher(iter(range(n)), max_buffer=16))
    assert sum(got, []) == list(range(n))
    assert all(1 <= len(b) <= 17 for b in got)


def test_buffered_prefetch_equals_the_jax_package():
    items = [np.arange(i) for i in range(9)]
    got = list(PB.buffered_prefetch(iter(items), buffer_size=2))
    want = list(JB.buffered_prefetch(iter(items), buffer_size=2))
    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _failing(n):
    yield from range(n)
    raise KeyError("source failed")


@pytest.mark.parametrize("make", [
    lambda: PB.buffered_prefetch(_failing(3)),
    lambda: PB.FixedBufferedBatcher(_failing(5), 2),
    lambda: PB.DynamicBufferedBatcher(_failing(5))])
def test_a_producer_error_reaches_the_consumer(make):
    with pytest.raises(KeyError, match="source failed"):
        list(make())


@pytest.mark.parametrize("cls", ["FixedBufferedBatcher",
                                 "DynamicBufferedBatcher"])
def test_buffered_batchers_are_single_use(cls):
    args = (iter(range(4)), 2) if cls == "FixedBufferedBatcher" \
        else (iter(range(4)),)
    b = getattr(PB, cls)(*args)
    list(b)
    with pytest.raises(RuntimeError, match="single-use"):
        list(b)


def test_buffered_batcher_reports_its_queue_depth():
    g = p_gauge("core.batching.queue.depth")
    g.set(-1)
    list(PB.FixedBufferedBatcher(iter(range(6)), 2))
    assert g.value >= 0


# ---- the utilities: StopWatch, bounded_parallel_map, retry_with_timeout ---

def test_stopwatch_surfaces():
    from mmlspark_tpu.utils.stopwatch import StopWatch as JSW
    from mmlspark_tpu_torch.utils.stopwatch import StopWatch

    assert [n for n in dir(StopWatch) if not n.startswith("__")] == \
        [n for n in dir(JSW) if not n.startswith("__")]
    sw = StopWatch()
    with sw:
        time.sleep(0.002)
    first = sw.elapsed_ns
    assert first >= 2_000_000 and sw.elapsed_s == sw.elapsed_sec
    out, dt = sw.measure(lambda a, b: a + b, 2, 3)
    assert out == 5 and sw.elapsed_ns == first + dt
    with sw.measure():
        time.sleep(0.001)
    assert sw.elapsed_ns >= first + dt + 1_000_000
    sw.restart()
    assert sw.stop() < first


@pytest.mark.parametrize("n,concurrency", [(0, 2), (7, 1), (50, 8)])
def test_bounded_parallel_map_keeps_input_order(n, concurrency):
    from mmlspark_tpu.utils.async_utils import bounded_parallel_map as jmap
    from mmlspark_tpu_torch.utils.async_utils import bounded_parallel_map

    in_flight, peak = [0], [0]
    lock = threading.Lock()

    def work(i):
        with lock:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        time.sleep(0.001 * (i % 3))
        with lock:
            in_flight[0] -= 1
        return i * i

    got = list(bounded_parallel_map(work, range(n), concurrency))
    assert got == list(jmap(lambda i: i * i, range(n), concurrency))
    assert peak[0] <= concurrency


def test_retry_with_timeout_retries_then_raises():
    from mmlspark_tpu_torch.utils.fault_tolerance import retry_with_timeout

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "up"

    assert retry_with_timeout(flaky, 1.0, retries=3) == "up"
    assert len(calls) == 3
    with pytest.raises(TimeoutError):
        retry_with_timeout(lambda: time.sleep(0.2), 0.01, retries=2)
    with pytest.raises(KeyError):  # not retryable: raised at once
        retry_with_timeout(lambda: {}["k"], 1.0, retries=5,
                           retryable=(ConnectionError,))
    with pytest.raises(ValueError, match="retries must be >= 1"):
        retry_with_timeout(lambda: 1, 1.0, retries=0)
