"""Cognitive services: config-driven HTTP transformer stages.

Reference: the cognitive module (~5.5k LoC, all `CognitiveServicesBase`
subclasses over the §2.3 HTTP stack).  Every service is a Transformer whose
params are constants or per-row columns (ServiceParam), batched through the
bounded-concurrency client.

A copy of the JAX package's `cognitive/__init__.py` for this package.
"""
from .base import BasicAsyncReply, CognitiveServicesBase
from .search import AzureSearchWriter
from .services import (
    AnalyzeBusinessCards,
    AnalyzeCustomModel,
    AnalyzeIDDocuments,
    AnalyzeInvoices,
    AnalyzeLayout,
    AnalyzeReceipts,
    BingImageSearch,
    BreakSentence,
    Detect,
    DetectAnomalies,
    DetectLastAnomaly,
    DictionaryExamples,
    DictionaryLookup,
    DocumentTranslator,
    GetCustomModel,
    ListCustomModels,
    SimpleDetectAnomalies,
    SpeechToText,
    Translate,
    Transliterate,
)
from .speech import (
    CompressedStream,
    ConversationTranscription,
    SpeechToTextSDK,
    WavStream,
)
from .text_analytics import (
    NER,
    PII,
    EntityDetector,
    KeyPhraseExtractor,
    LanguageDetector,
    TextSentiment,
)
from .vision import (
    OCR,
    AnalyzeImage,
    DescribeImage,
    DetectFace,
    FindSimilarFace,
    GenerateThumbnails,
    GroupFaces,
    IdentifyFaces,
    ReadImage,
    RecognizeDomainSpecificContent,
    TagImage,
    VerifyFaces,
)

__all__ = [
    "CognitiveServicesBase",
    "BasicAsyncReply",
    "TextSentiment",
    "LanguageDetector",
    "EntityDetector",
    "KeyPhraseExtractor",
    "NER",
    "PII",
    "OCR",
    "AnalyzeImage",
    "ReadImage",
    "GenerateThumbnails",
    "TagImage",
    "DescribeImage",
    "RecognizeDomainSpecificContent",
    "DetectFace",
    "FindSimilarFace",
    "GroupFaces",
    "IdentifyFaces",
    "VerifyFaces",
    "SpeechToText",
    "DetectLastAnomaly",
    "DetectAnomalies",
    "Translate",
    "Detect",
    "BreakSentence",
    "Transliterate",
    "AnalyzeLayout",
    "AnalyzeInvoices",
    "AnalyzeReceipts",
    "AnalyzeBusinessCards",
    "AnalyzeIDDocuments",
    "AnalyzeCustomModel",
    "GetCustomModel",
    "ListCustomModels",
    "SimpleDetectAnomalies",
    "DictionaryLookup",
    "DictionaryExamples",
    "DocumentTranslator",
    "BingImageSearch",
    "AzureSearchWriter",
    "SpeechToTextSDK",
    "ConversationTranscription",
    "WavStream",
    "CompressedStream",
]
