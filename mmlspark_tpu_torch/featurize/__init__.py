"""Featurization stages, copies of the JAX package's `featurize/` modules
for this package (host numpy, as there), and `Word2Vec`, whose steps run
on the card (`featurize/word2vec.py`)."""
from .value_indexer import ValueIndexer, ValueIndexerModel, IndexToValue
from .clean_missing import CleanMissingData, CleanMissingDataModel
from .featurize import Featurize, FeaturizeModel, DataConversion, CountSelector, CountSelectorModel
from .text import TextFeaturizer, TextFeaturizerModel, MultiNGram, PageSplitter
from .tokenizer import BPETokenizer, BPETokenizerModel, pack_sequences
from .word2vec import Word2Vec, Word2VecModel
