"""The port's featurization stages (mmlspark_tpu_torch.featurize) held
against the JAX package's on the same inputs, made from seeds with numpy:
`ValueIndexer` / `IndexToValue`, `CleanMissingData`, `Featurize`,
`DataConversion`, `CountSelector`, `TextFeaturizer`, `MultiNGram`,
`PageSplitter`, `BPETokenizer` and `pack_sequences`.

All of them are host numpy in both packages, so the fitted state and the
outputs are equal (tests/torch_tables.py): the same columns, dtypes,
values and metadata, the BPE merges and ids too, ties included.  The one
tolerance is 1e-6 where f32 and f64 meet: none of these cases needs it,
and `Featurize`'s f32 output is compared with `==`.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as JTable
from mmlspark_tpu.featurize import clean_missing as JC
from mmlspark_tpu.featurize import featurize as JF
from mmlspark_tpu.featurize import text as JX
from mmlspark_tpu.featurize import tokenizer as JK
from mmlspark_tpu.featurize import value_indexer as JV

from mmlspark_tpu_torch import Table as PTable
from mmlspark_tpu_torch import featurize as PFZ
from mmlspark_tpu_torch.featurize import clean_missing as PC
from mmlspark_tpu_torch.featurize import featurize as PF
from mmlspark_tpu_torch.featurize import text as PX
from mmlspark_tpu_torch.featurize import tokenizer as PK
from mmlspark_tpu_torch.featurize import value_indexer as PV

from torch_tables import assert_same_table

torch.set_num_threads(2)


def mixed_cols(n=40, seed=0):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n)
    num[rng.random(n) < 0.2] = np.nan
    vec = np.empty(n, object)
    for i in range(n):
        vec[i] = rng.normal(size=3)
    words = ["red", "green", "blue", "cyan"]
    return {
        "num": num,
        "count": rng.integers(0, 9, n),
        "flag": rng.random(n) > 0.5,
        "cat": np.asarray(rng.choice(words, n)),
        "many": np.asarray([f"id{int(v)}" for v in rng.integers(0, 30, n)],
                           object),
        "text": np.asarray([" ".join(rng.choice(words, 3)) for _ in range(n)],
                           object),
        "dense": rng.normal(size=(n, 2)).astype(np.float32),
        "ragged": vec,
        "label": np.asarray(rng.choice(["no", "yes", "maybe"], n), object),
    }


def reviews(n=60, seed=1):
    rng = np.random.default_rng(seed)
    vocab = ["good", "bad", "great", "plot", "the", "a", "movie", "was",
             "not", "very", "acting", "boring", "fun", "and", "it's"]
    return {"text": np.asarray(
        [" ".join(rng.choice(vocab, int(rng.integers(0, 12))))
         + ("!" if i % 3 else " The END.") for i in range(n)], object)}


def both(cols):
    return JTable(dict(cols)), PTable(dict(cols))


def fit_both(j_est, p_est, cols, key):
    jt, pt = both(cols)
    jm, pm = j_est.fit(jt), p_est.fit(pt)
    assert type(pm).__name__ == type(jm).__name__
    return jm, pm, jm.transform(jt), pm.transform(pt)


# ---- ValueIndexer / IndexToValue ----------------------------------------

@pytest.mark.parametrize("col", ["label", "count", "cat", "flag", "mixed"])
def test_value_indexer_equals_the_jax_package(col):
    cols = mixed_cols()
    if col == "mixed":  # uncomparable types: first-seen order
        cols["mixed"] = np.asarray([1, "a", 2.5, "a", 1, "b", 1] * 5 +
                                   [3] * 5, object)
    jm, pm, jo, po = fit_both(JV.ValueIndexer(input_col=col, output_col="i"),
                              PV.ValueIndexer(input_col=col, output_col="i"),
                              cols, col)
    assert list(jm.levels.levels) == list(pm.levels.levels)
    assert_same_table(jo, po)
    back_j = JV.IndexToValue(input_col="i", output_col="back").transform(jo)
    back_p = PV.IndexToValue(input_col="i", output_col="back").transform(po)
    assert_same_table(back_j, back_p)


def test_value_indexer_refuses_an_unseen_value():
    model = PV.ValueIndexer(input_col="cat").fit(PTable(mixed_cols()))
    with pytest.raises(ValueError, match="not seen during fit"):
        model.transform(PTable({"cat": np.asarray(["violet"])}))
    with pytest.raises(ValueError, match="no categorical metadata"):
        PV.IndexToValue(input_col="cat").transform(PTable(mixed_cols()))


# ---- CleanMissingData ---------------------------------------------------

@pytest.mark.parametrize("mode,out", [("Mean", None), ("Median", ["n2"]),
                                      ("Custom", None), ("mean", None)])
def test_clean_missing_data_equals_the_jax_package(mode, out):
    cols = mixed_cols()
    cols["allnan"] = np.full(40, np.nan)
    kw = dict(input_cols=["num", "allnan"] if out is None else ["num"],
              output_cols=out, cleaning_mode=mode)
    if mode == "Custom":
        kw["custom_value"] = -7
    jm, pm, jo, po = fit_both(JC.CleanMissingData(**kw),
                              PC.CleanMissingData(**kw), cols, None)
    assert jm.fill_values == pm.fill_values
    assert_same_table(jo, po)


def test_clean_missing_data_refuses_bad_modes():
    with pytest.raises(ValueError, match="custom_value"):
        PC.CleanMissingData(input_cols=["num"], cleaning_mode="Custom").fit(
            PTable(mixed_cols()))
    with pytest.raises(ValueError, match="unknown cleaning_mode"):
        PC.CleanMissingData(input_cols=["num"], cleaning_mode="max").fit(
            PTable(mixed_cols()))


# ---- Featurize ------------------------------------------------------------

FEATURIZE_CASES = {
    "all": dict(input_cols=["num", "count", "flag", "cat", "many", "text",
                            "dense", "ragged"]),
    "threshold": dict(input_cols=["cat", "many", "num"],
                      categorical_threshold=10, number_of_features=16),
    "no-one-hot": dict(input_cols=["cat", "text"],
                       one_hot_encode_categoricals=False,
                       number_of_features=8),
}


@pytest.mark.parametrize("case", sorted(FEATURIZE_CASES))
def test_featurize_equals_the_jax_package(case):
    kw = dict(FEATURIZE_CASES[case], output_col="features")
    jm, pm, jo, po = fit_both(JF.Featurize(**kw), PF.Featurize(**kw),
                              mixed_cols(), None)
    assert jm.strategies == pm.strategies
    assert po["features"].dtype == np.float32
    assert_same_table(jo, po)
    # a table the fit did not see: unseen levels are all-zero rows
    other = mixed_cols(seed=5)
    other["cat"][:3] = "violet"
    assert_same_table(jm.transform(JTable(dict(other))),
                      pm.transform(PTable(dict(other))))


def test_featurize_refuses_no_columns_and_hashes_by_crc32():
    with pytest.raises(ValueError, match="no input columns"):
        PF.FeaturizeModel(input_cols=[], strategies={}).transform(
            PTable(mixed_cols()))
    for tok in ["", "a", "naïve", "id17", "x" * 100]:
        for dims in (1, 7, 256, 4096):
            assert PF._hash_token(tok, dims) == JF._hash_token(tok, dims)


@pytest.mark.parametrize("to", ["boolean", "byte", "short", "integer",
                                "long", "float", "double", "string",
                                "categorical"])
def test_data_conversion_equals_the_jax_package(to):
    cols = {"x": np.array([1.2, 3.9, -2.1, 0.0, 3.9]),
            "n": np.array([3, 1, 2, 3, 0])}
    kw = dict(cols=["x", "n"], convert_to=to)
    jt, pt = both(cols)
    assert_same_table(JF.DataConversion(**kw).transform(jt),
                      PF.DataConversion(**kw).transform(pt))


def test_data_conversion_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="unknown target"):
        PF.DataConversion(cols=["x"], convert_to="complex").transform(
            PTable({"x": np.arange(3.0)}))


@pytest.mark.parametrize("ragged", [False, True])
def test_count_selector_equals_the_jax_package(ragged):
    rng = np.random.default_rng(3)
    x = np.zeros((12, 6), np.float32)
    x[:, [0, 3]] = rng.normal(size=(12, 2))
    x[5, 4] = -1.0
    col = x
    if ragged:
        col = np.empty(12, object)
        for i in range(12):
            col[i] = x[i].astype(np.float64)
    kw = dict(input_col="features", output_col="sel")
    jm, pm, jo, po = fit_both(JF.CountSelector(**kw), PF.CountSelector(**kw),
                              {"features": col}, None)
    np.testing.assert_array_equal(jm.indices, pm.indices)
    assert pm.indices.dtype == np.int64
    assert_same_table(jo, po)


# ---- text -----------------------------------------------------------------

TEXT_CASES = {
    "defaults": {},
    "stopwords-ngrams": dict(use_stop_words_remover=True, use_ngram=True,
                             n_gram_length=3, num_features=64),
    "no-idf": dict(use_idf=False, num_features=32),
    "whitespace": dict(use_tokenizer=False, min_doc_freq=3,
                       num_features=128),
}


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_text_featurizer_equals_the_jax_package(case):
    kw = dict(TEXT_CASES[case], input_col="text", output_col="tf")
    jm, pm, jo, po = fit_both(JX.TextFeaturizer(**kw), PX.TextFeaturizer(**kw),
                              reviews(), None)
    assert jm.config == pm.config
    np.testing.assert_array_equal(jm.idf, pm.idf)
    assert pm.idf.dtype == np.float64
    assert_same_table(jo, po)


@pytest.mark.parametrize("lengths", [[1, 2, 3], [2], [4, 1]])
def test_multi_ngram_equals_the_jax_package(lengths):
    rng = np.random.default_rng(len(lengths))
    toks = np.empty(6, object)
    for i in range(6):
        toks[i] = list(rng.choice(list("abcde"), i))
    kw = dict(input_col="tokens", output_col="grams", lengths=lengths)
    jt, pt = both({"tokens": toks})
    assert_same_table(JX.MultiNGram(**kw).transform(jt),
                      PX.MultiNGram(**kw).transform(pt))


@pytest.mark.parametrize("max_len,min_len", [(20, 10), (7, 7), (50, 0),
                                             (5000, 4500)])
def test_page_splitter_equals_the_jax_package(max_len, min_len):
    text = reviews(8)["text"].copy()
    text[0] = "x" * 45 + " short " + "y" * 13
    text[1] = ""
    kw = dict(input_col="text", output_col="pages",
              maximum_page_length=max_len, minimum_page_length=min_len)
    jt, pt = both({"text": text})
    jo = JX.PageSplitter(**kw).transform(jt)
    po = PX.PageSplitter(**kw).transform(pt)
    assert_same_table(jo, po)
    for pages, t in zip(po["pages"], text):
        assert "".join(pages) == t
        assert all(len(p) <= max_len for p in pages)


# ---- BPE tokenizer --------------------------------------------------------

def corpus(n=80, seed=4):
    rng = np.random.default_rng(seed)
    stems = ["low", "lower", "newest", "widest", "new", "wide", "est",
             "Hello", "world", "naïve", "lowest", "aa", "ab", "ba", "bb"]
    return {"text": np.asarray([" ".join(rng.choice(stems, int(
        rng.integers(1, 9)))) for _ in range(n)], object)}


BPE_CASES = {"64": dict(vocab_size=64), "200-eos": dict(
    vocab_size=200, append_eos=True), "cased": dict(vocab_size=90,
                                                    lowercase=False),
    "tiny": dict(vocab_size=10)}


@pytest.mark.parametrize("case", sorted(BPE_CASES))
def test_bpe_tokenizer_equals_the_jax_package(case):
    kw = dict(BPE_CASES[case], input_col="text", output_col="ids")
    jm, pm, jo, po = fit_both(JK.BPETokenizer(**kw), PK.BPETokenizer(**kw),
                              corpus(), None)
    assert pm.vocab == jm.vocab
    assert pm.merges == jm.merges  # the tie order too
    assert_same_table(jo, po)
    for text in ["lowest newer", "unseen ZZ", "", "a b  c"]:
        ids = pm.encode(text)
        np.testing.assert_array_equal(ids, jm.encode(text))
        assert ids.dtype == np.int32
        assert pm.decode(ids) == jm.decode(ids)
        assert [pm.is_word_end(int(i)) for i in ids] == \
            [jm.is_word_end(int(i)) for i in ids]
    assert pm.eos_id == jm.eos_id == PK.EOS_ID
    assert not pm.is_word_end(-1) and not pm.is_word_end(10 ** 6)


def test_bpe_tokenizer_ties_follow_first_counted_order():
    """Equal pair counts: the first pair counted wins (Counter order), in
    both packages; the corpus is built so every first merge is a tie."""
    cols = {"text": np.asarray(["ab ba", "ba ab", "cd dc"], object)}
    kw = dict(input_col="text", vocab_size=16)
    jm = JK.BPETokenizer(**kw).fit(JTable(dict(cols)))
    pm = PK.BPETokenizer(**kw).fit(PTable(dict(cols)))
    assert pm.merges == jm.merges
    assert pm.merges[0] == ["a", "b"]


def test_bpe_schema_checks():
    with pytest.raises(ValueError, match="missing column"):
        PK.BPETokenizer(input_col="text").transform_schema(["other"])
    assert PK.BPETokenizer(input_col="text", output_col="ids") \
        .transform_schema(["text"]) == ["text", "ids"]


@pytest.mark.parametrize("mode,seq_len", [("pad", 5), ("pack", 5),
                                          ("pack", 64), ("pad", 1)])
def test_pack_sequences_equals_the_jax_package(mode, seq_len):
    rng = np.random.default_rng(seq_len)
    rows = [rng.integers(3, 50, int(rng.integers(1, 12))).astype(np.int32)
            for _ in range(9)]
    got = PK.pack_sequences(rows, seq_len, mode=mode, pad_id=0)
    want = JK.pack_sequences(rows, seq_len, mode=mode, pad_id=0)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_pack_sequences_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        PK.pack_sequences([np.arange(3)], 4, mode="fold")


def test_the_package_exports_only_what_is_ported():
    """Everything the JAX package's `featurize` exports, Word2Vec included
    since it was ported (tests/test_torch_word2vec.py)."""
    import mmlspark_tpu.featurize as JFZ

    names = [n for n in vars(JFZ) if not n.startswith("_")
             and not isinstance(getattr(JFZ, n), type(JFZ))]
    assert "Word2Vec" in names and "Word2VecModel" in names
    for name in names + ["pack_sequences"]:
        assert hasattr(PFZ, name), name
