"""Featurization stages, copies of the JAX package's `featurize/` modules
for this package (host numpy, as there).  `Word2Vec`
(`featurize/word2vec.py`, which trains on the device) is not ported yet
(ROADMAP A17)."""
from .value_indexer import ValueIndexer, ValueIndexerModel, IndexToValue
from .clean_missing import CleanMissingData, CleanMissingDataModel
from .featurize import Featurize, FeaturizeModel, DataConversion, CountSelector, CountSelectorModel
from .text import TextFeaturizer, TextFeaturizerModel, MultiNGram, PageSplitter
from .tokenizer import BPETokenizer, BPETokenizerModel, pack_sequences
