"""The port's cognitive services (mmlspark_tpu_torch.cognitive) against a
copy of tests/test_cognitive.py's local mock service: the JAX package's
request contracts (URLs, headers, payloads, async polling, batched search
push with backoff) run on the port's stages, and the two packages' stages
send the same requests and parse the same outputs on the same tables.
The stages are host code over the port's HTTP layer
(`io/http/clients.py`, `io/http/schema.py`); nothing runs on a device.
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest

from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.cognitive import (
    NER,
    OCR,
    AnalyzeImage,
    AzureSearchWriter,
    BingImageSearch,
    DetectAnomalies,
    DetectFace,
    ReadImage,
    TextSentiment,
    Translate,
    VerifyFaces,
)


class _MockService(BaseHTTPRequestHandler):
    """Route-aware mock: records requests, simulates async ops + throttling."""

    log = []
    async_polls = {}
    search_fail_first = {"on": False, "seen": set()}
    speech_calls = 0

    def _respond(self, code, body: bytes, headers=None):
        self.send_response(code)
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        path = urlparse(self.path).path
        _MockService.log.append({
            "path": self.path, "body": body,
            "headers": dict(self.headers.items()), "method": "POST",
        })
        if path.endswith("/sentiment") or path.endswith("/general"):
            docs = json.loads(body)["documents"]
            out = {"documents": [{"id": d["id"], "sentiment": "positive",
                                  "text_len": len(d["text"])} for d in docs]}
            self._respond(200, json.dumps(out).encode())
        elif path.endswith("/analyze") and "read" in path:
            op_id = str(len(_MockService.async_polls))
            _MockService.async_polls[op_id] = 0
            host, port = self.server.server_address[:2]
            self._respond(202, b"", {
                "Operation-Location": f"http://{host}:{port}/read/result/{op_id}"
            })
        elif "formrecognizer" in path and path.endswith("/analyze"):
            op_id = str(len(_MockService.async_polls))
            _MockService.async_polls[op_id] = 0
            host, port = self.server.server_address[:2]
            self._respond(202, b"", {
                "Operation-Location": f"http://{host}:{port}/read/result/{op_id}"
            })
        elif path.endswith("/ocr") or path.endswith("/analyze"):
            self._respond(200, json.dumps(
                {"language": "en", "regions": []}
            ).encode())
        elif path.endswith("/detect") and "anomalydetector" in path:
            series = json.loads(body)["series"]
            self._respond(200, json.dumps(
                {"isAnomaly": [v["value"] > 100 for v in series],
                 "expectedValues": [v["value"] for v in series]}
            ).encode())
        elif path.endswith("/dictionary/lookup"):
            q = parse_qs(urlparse(self.path).query)
            docs = json.loads(body)
            self._respond(200, json.dumps([{
                "normalizedSource": d["Text"],
                "translations": [{"normalizedTarget": d["Text"][::-1],
                                  "to": q["to"][0]}],
            } for d in docs]).encode())
        elif path.endswith("/dictionary/examples"):
            docs = json.loads(body)
            assert all(set(d) == {"Text", "Translation"} for d in docs)
            self._respond(200, json.dumps([{
                "normalizedSource": d["Text"],
                "examples": [{"sourcePrefix": "the ", "sourceTerm": d["Text"]}],
            } for d in docs]).encode())
        elif "/speech/recognition/" in path:
            _MockService.speech_calls += 1
            self._respond(200, json.dumps({
                "RecognitionStatus": "Success",
                "DisplayText": f"seg{_MockService.speech_calls}",
                "bytes": len(body),
            }).encode())
        elif path.endswith("/translate"):
            q = parse_qs(urlparse(self.path).query)
            self._respond(200, json.dumps([{
                "translations": [{"to": t, "text": "hola"} for t in q["to"]]
            }]).encode())
        elif path.endswith("/detect"):  # face
            self._respond(200, json.dumps([{"faceId": "f1"}]).encode())
        elif path.endswith("/verify"):
            payload = json.loads(body)
            assert set(payload) == {"faceId1", "faceId2"}
            self._respond(200, json.dumps({"isIdentical": True}).encode())
        elif path.endswith("/docs/index"):
            docs = json.loads(body)["value"]
            keys = tuple(d["id"] for d in docs)
            if (_MockService.search_fail_first["on"]
                    and keys not in _MockService.search_fail_first["seen"]
                    and len(docs) > 1):
                _MockService.search_fail_first["seen"].add(keys)
                self._respond(503, b"")
            else:
                self._respond(200, json.dumps({"value": []}).encode())
        else:
            self._respond(404, b"not found")

    def do_GET(self):
        path = urlparse(self.path).path
        _MockService.log.append({"path": self.path, "method": "GET",
                                 "headers": dict(self.headers.items())})
        if "/read/result/" in path:
            op_id = path.rsplit("/", 1)[-1]
            _MockService.async_polls[op_id] += 1
            if _MockService.async_polls[op_id] < 2:
                self._respond(200, json.dumps({"status": "running"}).encode())
            else:
                self._respond(200, json.dumps({
                    "status": "succeeded",
                    "analyzeResult": {"readResults": [{"lines": ["hi"]}]},
                }).encode())
        elif path.rstrip("/").endswith("/custom/models"):
            q = parse_qs(urlparse(self.path).query)
            self._respond(200, json.dumps({
                "summary": {"count": 2},
                "modelList": [{"modelId": "m1"}, {"modelId": "m2"}],
                "op": q.get("op", ["?"])[0],
            }).encode())
        elif "/custom/models/" in path:
            model_id = path.rstrip("/").rsplit("/", 1)[-1]
            q = parse_qs(urlparse(self.path).query)
            self._respond(200, json.dumps({
                "modelInfo": {"modelId": model_id, "status": "ready"},
                "includeKeys": q.get("includeKeys", ["false"])[0],
            }).encode())
        elif "/images/search" in path:
            q = parse_qs(urlparse(self.path).query)
            self._respond(200, json.dumps({
                "value": [{"contentUrl": f"http://img/{q['q'][0]}/{i}"}
                          for i in range(int(q["count"][0]))]
            }).encode())
        else:
            self._respond(404, b"")

    def do_PUT(self):
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        _MockService.log.append({"path": self.path, "method": "PUT", "body": body})
        self._respond(201, b"{}")

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def mock_url():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _MockService)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    host, port = httpd.server_address[:2]
    yield f"http://{host}:{port}"
    httpd.shutdown()
    httpd.server_close()


def test_text_sentiment(mock_url):
    t = Table({"text": ["great day", "bad day", None]})
    out = TextSentiment(
        url=f"{mock_url}/text/analytics/v3.0/sentiment",
        subscription_key="k123",
    ).transform(t)
    assert out["output"][0]["sentiment"] == "positive"
    assert out["output"][2] is None  # null text -> null output
    sent = [e for e in _MockService.log if "/sentiment" in e["path"]]
    assert sent[0]["headers"].get("Ocp-apim-subscription-key") == "k123" or \
        sent[0]["headers"].get("Ocp-Apim-Subscription-Key") == "k123"
    payload = json.loads(sent[0]["body"])
    assert payload["documents"][0]["language"] == "en"


def test_key_as_column(mock_url):
    t = Table({"text": ["x"], "mykey": ["colkey"]})
    stage = NER(url=f"{mock_url}/text/analytics/v3.0/entities/recognition/general")
    stage.set_col("subscription_key", "mykey")
    out = stage.transform(t)
    assert out["output"][0] is not None
    e = [e for e in _MockService.log if "general" in e["path"]][-1]
    key_hdr = {k.lower(): v for k, v in e["headers"].items()}
    assert key_hdr["ocp-apim-subscription-key"] == "colkey"


def test_ocr_binary_mode(mock_url):
    imgs = np.empty(1, dtype=object)
    imgs[0] = b"\x89PNGfake"
    t = Table({"img": imgs})
    out = OCR(url=f"{mock_url}/vision/v2.0/ocr",
              image_bytes_col="img").transform(t)
    assert out["output"][0]["language"] == "en"
    e = [e for e in _MockService.log if "/ocr" in e["path"]][-1]
    assert e["body"] == b"\x89PNGfake"
    hdrs = {k.lower(): v for k, v in e["headers"].items()}
    assert hdrs["content-type"] == "application/octet-stream"
    assert "detectOrientation=true" in e["path"]


def test_analyze_image_url_mode(mock_url):
    t = Table({"urls": ["http://example.com/a.jpg"]})
    out = AnalyzeImage(url=f"{mock_url}/vision/v2.0/analyze",
                       image_url_col="urls").transform(t)
    assert out["output"][0] is not None
    e = [e for e in _MockService.log if "/vision/v2.0/analyze" in e["path"]][-1]
    assert json.loads(e["body"]) == {"url": "http://example.com/a.jpg"}
    assert "visualFeatures" in e["path"]


def test_read_image_async_polling(mock_url):
    t = Table({"urls": ["http://example.com/doc.png"]})
    out = ReadImage(url=f"{mock_url}/vision/v3.1/read/analyze",
                    image_url_col="urls",
                    polling_interval_ms=10).transform(t)
    assert out["output"][0]["status"] == "succeeded"
    assert out["output"][0]["analyzeResult"]["readResults"][0]["lines"] == ["hi"]


def test_detect_anomalies(mock_url):
    ts = np.empty(1, dtype=object)
    vals = np.empty(1, dtype=object)
    ts[0] = ["2024-01-01T00:00:00Z", "2024-01-02T00:00:00Z"]
    vals[0] = [1.0, 2.0]
    t = Table({"timestamps": ts, "values": vals})
    out = DetectAnomalies(
        url=f"{mock_url}/anomalydetector/v1.0/timeseries/entire/detect"
    ).transform(t)
    assert out["output"][0]["isAnomaly"] == [False, False]


def test_translate_multi_target(mock_url):
    t = Table({"text": ["hello"]})
    out = Translate(url=f"{mock_url}/translate",
                    to_language="es,fr").transform(t)
    assert len(out["output"][0][0]["translations"]) == 2


def test_face_detect_and_verify(mock_url):
    t = Table({"urls": ["http://example.com/face.jpg"]})
    out = DetectFace(url=f"{mock_url}/face/v1.0/detect",
                     image_url_col="urls").transform(t)
    assert out["output"][0][0]["faceId"] == "f1"
    t2 = Table({"f1": ["a"], "f2": ["b"]})
    vf = VerifyFaces(url=f"{mock_url}/face/v1.0/verify")
    vf.set_col("face_id1", "f1")
    vf.set_col("face_id2", "f2")
    out2 = vf.transform(t2)
    assert out2["output"][0]["isIdentical"] is True


def test_bing_image_search_and_flatten(mock_url):
    t = Table({"query": ["cats", "dogs"]})
    stage = BingImageSearch(url=f"{mock_url}/v7.0/images/search", count=3)
    out = stage.transform(t)
    urls = BingImageSearch.get_urls(out)
    assert len(urls) == 6
    assert urls["imageUrl"][0].startswith("http://img/cats")


def test_azure_search_writer_with_backoff(mock_url):
    _MockService.search_fail_first["on"] = True
    _MockService.search_fail_first["seen"] = set()
    t = Table({
        "id": [str(i) for i in range(7)],
        "content": [f"doc {i}" for i in range(7)],
    })
    writer = AzureSearchWriter(
        index_name="testidx", key="sk",
        index_definition={"name": "testidx", "fields": [
            {"name": "id", "type": "Edm.String", "key": True},
            {"name": "content", "type": "Edm.String"},
        ]},
        batch_size=4, base_url=mock_url,
    )
    written = writer.write(t)
    assert written == 7
    puts = [e for e in _MockService.log if e["method"] == "PUT"]
    assert any("/indexes/testidx" in e["path"] for e in puts)
    _MockService.search_fail_first["on"] = False


def test_cognitive_roundtrip(mock_url):
    from torch_fuzzing import fuzz_transformer

    t = Table({"text": ["serialize me"]})
    stage = TextSentiment(
        url=f"{mock_url}/text/analytics/v3.0/sentiment", subscription_key="k",
    )
    fuzz_transformer(stage, t)


def test_document_translator_registered():
    from mmlspark_tpu_torch.cognitive import DocumentTranslator
    from mmlspark_tpu_torch.core.registry import get_stage_class

    assert get_stage_class("DocumentTranslator") is DocumentTranslator
    stage = DocumentTranslator(service_name="acct")
    assert "acct.cognitiveservices.azure.com" in stage._base_url()


# ------------------------- cognitive long tail (round-2 VERDICT item 8) ----

def test_dictionary_lookup_and_examples(mock_url):
    from mmlspark_tpu_torch.cognitive import DictionaryExamples, DictionaryLookup

    t = Table({"text": ["fly"]})
    out = DictionaryLookup(url=f"{mock_url}/dictionary/lookup",
                           from_language="en", to_language="es").transform(t)
    entry = out["output"][0][0]
    assert entry["normalizedSource"] == "fly"
    assert entry["translations"][0]["to"] == "es"

    pairs = np.empty(1, dtype=object)
    pairs[0] = ("fly", "volar")
    t2 = Table({"textAndTranslation": pairs})
    out2 = DictionaryExamples(
        url=f"{mock_url}/dictionary/examples").transform(t2)
    assert out2["output"][0][0]["examples"][0]["sourceTerm"] == "fly"


def test_simple_detect_anomalies_groups_and_joins(mock_url):
    from mmlspark_tpu_torch.cognitive import SimpleDetectAnomalies

    # two interleaved series; the 999 point in group "a" is the anomaly
    t = Table({
        "timestamp": ["2024-01-01", "2024-01-01", "2024-01-02",
                      "2024-01-02", "2024-01-03", "2024-01-03"],
        "value": [1.0, 5.0, 999.0, 6.0, 2.0, 7.0],
        "group": ["a", "b", "a", "b", "a", "b"],
    })
    before = len(_MockService.log)
    out = SimpleDetectAnomalies(
        url=f"{mock_url}/anomalydetector/v1.0/timeseries/entire/detect"
    ).transform(t)
    # one request per group, not per row
    assert len(_MockService.log) - before == 2
    verdicts = [o["isAnomaly"] for o in out["output"]]
    assert verdicts == [False, False, True, False, False, False]
    # scalar fields broadcast; list fields joined back positionally
    assert out["output"][2]["expectedValues"] == 999.0


def test_form_recognizer_prebuilt_ops_async(mock_url):
    from mmlspark_tpu_torch.cognitive import AnalyzeReceipts

    t = Table({"urls": ["http://example.com/receipt.jpg"]})
    out = AnalyzeReceipts(
        url=f"{mock_url}/formrecognizer/v2.1/prebuilt/receipt/analyze",
        image_url_col="urls", polling_interval_ms=10).transform(t)
    assert out["output"][0]["status"] == "succeeded"


def test_form_recognizer_custom_model_ops(mock_url):
    from mmlspark_tpu_torch.cognitive import (
        AnalyzeCustomModel,
        GetCustomModel,
        ListCustomModels,
    )

    t = Table({"urls": ["http://example.com/doc.pdf"]})
    out = AnalyzeCustomModel(
        url=f"{mock_url}/formrecognizer/v2.1/custom/models",
        model_id="m42", image_url_col="urls",
        polling_interval_ms=10).transform(t)
    assert out["output"][0]["status"] == "succeeded"

    t2 = Table({"x": [0]})
    got = GetCustomModel(url=f"{mock_url}/formrecognizer/v2.1/custom/models",
                         model_id="m42", include_keys=True).transform(t2)
    assert got["output"][0]["modelInfo"]["modelId"] == "m42"
    assert got["output"][0]["includeKeys"] == "true"

    lst = ListCustomModels(
        url=f"{mock_url}/formrecognizer/v2.1/custom/models",
        op="summary").transform(t2)
    assert lst["output"][0]["op"] == "summary"
    assert lst["output"][0]["summary"]["count"] == 2


def _make_wav(n_seconds=1.0, rate=16000):
    import struct

    n = int(n_seconds * rate)
    pcm = struct.pack("<%dh" % n, *([100] * n))
    hdr = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                      b"fmt ", 16, 1, 1, rate, rate * 2, 2, 16,
                      b"data", len(pcm))
    return hdr + pcm


def test_wav_stream_windows():
    from mmlspark_tpu_torch.cognitive import WavStream

    ws = WavStream(_make_wav(1.0))
    assert ws.sample_rate == 16000 and ws.channels == 1
    assert ws.duration_ms == pytest.approx(1000.0)
    wins = list(ws.windows(250))
    assert len(wins) == 4
    assert [w[0] for w in wins] == [0.0, 250.0, 500.0, 750.0]
    # every window re-wraps into a parseable standalone wav
    rewrapped = WavStream(ws.window_wav(wins[0][1]))
    assert rewrapped.duration_ms == pytest.approx(250.0)


def test_speech_sdk_streaming_continuous(mock_url):
    from mmlspark_tpu_torch.cognitive import SpeechToTextSDK

    audio = np.empty(1, dtype=object)
    audio[0] = _make_wav(1.0)
    t = Table({"audio": audio})
    _MockService.speech_calls = 0
    out = SpeechToTextSDK(
        url=f"{mock_url}/speech/recognition/conversation/cognitiveservices/v1",
        window_ms=250, segmentation="window", concurrency=1).transform(t)
    segs = out["output"][0]
    assert len(segs) == 4
    assert [s["StreamOffsetMs"] for s in segs] == [0.0, 250.0, 500.0, 750.0]
    assert all(s["RecognitionStatus"] == "Success" for s in segs)
    # each window shipped as a self-contained wav (header + 250ms pcm)
    assert all(s["bytes"] == 44 + 2 * 4000 for s in segs)


def test_speech_sdk_flatten_results(mock_url):
    from mmlspark_tpu_torch.cognitive import SpeechToTextSDK

    audio = np.empty(2, dtype=object)
    audio[0] = _make_wav(0.5)
    audio[1] = _make_wav(0.25)
    t = Table({"audio": audio, "rowid": np.array([10, 20])})
    out = SpeechToTextSDK(
        url=f"{mock_url}/speech/recognition/conversation/cognitiveservices/v1",
        window_ms=250, segmentation="window", flatten_results=True,
        concurrency=1).transform(t)
    # 2 + 1 utterances, each a row carrying its source row's columns
    assert len(out) == 3
    assert list(out["rowid"]) == [10, 10, 20]


def test_simple_detect_anomalies_null_rows_and_numeric_timestamps(mock_url):
    from mmlspark_tpu_torch.cognitive import SimpleDetectAnomalies

    # epoch-int timestamps that lexicographic sort would misorder
    # (999 > 1000 as strings), plus a null row that must not poison group a
    vals = np.empty(5, dtype=object)
    for i, v in enumerate([1.0, None, 999.0, 3.0, 4.0]):
        vals[i] = v
    t = Table({
        "timestamp": np.array([999, 1000, 1001, 999, 1000], np.int64),
        "value": vals,
        "group": ["a", "a", "a", "b", "b"],
    })
    out = SimpleDetectAnomalies(
        url=f"{mock_url}/anomalydetector/v1.0/timeseries/entire/detect"
    ).transform(t)
    assert out["output"][1] is None            # null row skipped, not fatal
    assert out["output"][2]["isAnomaly"] is True
    assert out["output"][0]["isAnomaly"] is False
    # chronological order despite lexicographic inversion: row 0 (ts=999)
    # is the group's first point, so its verdict came from position 0
    assert out["output"][0]["expectedValues"] == 1.0


def test_speech_sdk_corrupt_audio_isolated(mock_url):
    from mmlspark_tpu_torch.cognitive import SpeechToTextSDK

    audio = np.empty(2, dtype=object)
    audio[0] = b"not a wav at all"
    audio[1] = _make_wav(0.25)
    t = Table({"audio": audio})
    out = SpeechToTextSDK(
        url=f"{mock_url}/speech/recognition/conversation/cognitiveservices/v1",
        window_ms=250, segmentation="window").transform(t)
    assert out["output"][0] == [] and "decode failed" in out["errors"][0]
    assert len(out["output"][1]) == 1 and out["errors"][1] is None


def test_custom_models_url_trailing_slash_normalized(mock_url):
    from mmlspark_tpu_torch.cognitive import ListCustomModels

    t = Table({"x": [0]})
    out = ListCustomModels(
        url=f"{mock_url}/formrecognizer/v2.1/custom/models/").transform(t)
    assert out["output"][0]["summary"]["count"] == 2


def test_conversation_transcription_query_joining(mock_url):
    """The conversation endpoint carries a query string; language/format
    params must join with '&' (a second '?' would break the service URL)."""
    from mmlspark_tpu_torch.cognitive import ConversationTranscription

    audio = np.empty(1, dtype=object)
    audio[0] = _make_wav(0.5)
    t = Table({"audio": audio})
    before = len(_MockService.log)
    out = ConversationTranscription(
        url=(f"{mock_url}/speech/recognition/conversation/cognitiveservices"
             "/v1?transcriptionMode=conversation"),
        window_ms=250, segmentation="window").transform(t)
    segs = out["output"][0]
    assert len(segs) == 2
    assert [s["StreamOffsetMs"] for s in segs] == [0.0, 250.0]
    reqs = [e for e in _MockService.log[before:] if "speech" in e["path"]]
    assert reqs, "no recognition requests hit the mock"
    for e in reqs:
        assert e["path"].count("?") == 1
        assert "transcriptionMode=conversation" in e["path"]
        assert "&language=" in e["path"]


# ------------------------------------------------ utterance endpointing

def _make_speech_wav(segments, rate=16000, amp=8000):
    """PCM with spoken bursts separated by silence: segments is a list of
    (duration_s, voiced) pairs."""
    import struct as _struct

    samples = []
    for dur, voiced in segments:
        n = int(dur * rate)
        if voiced:
            tt = np.arange(n)
            samples.append((amp * np.sin(2 * np.pi * 220 * tt / rate))
                           .astype(np.int16))
        else:
            samples.append(np.zeros(n, np.int16))
    pcm = np.concatenate(samples).tobytes()
    hdr = _struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                       b"fmt ", 16, 1, 1, rate, rate * 2, 2, 16,
                       b"data", len(pcm))
    return hdr + pcm


def test_wav_stream_utterance_endpointing():
    """A spoken-pause fixture splits at the silences, never mid-utterance
    (SpeechToTextSDK.scala:76-489 continuous-recognizer semantics)."""
    from mmlspark_tpu_torch.cognitive import WavStream

    wav = _make_speech_wav([(0.3, True), (0.5, False), (0.4, True)])
    utts = list(WavStream(wav).utterances(silence_ms=300))
    assert len(utts) == 2
    # offsets land at the utterance starts (one 30ms context frame early)
    assert utts[0][0] == pytest.approx(0.0, abs=65.0)
    assert utts[1][0] == pytest.approx(800.0, abs=65.0)
    # each segment covers its burst (within a context frame either side)
    for (off, pcm), want_ms in zip(utts, (300.0, 400.0)):
        dur = 1000.0 * (len(pcm) // 2) / 16000
        assert dur == pytest.approx(want_ms, abs=80.0)


def test_wav_stream_utterance_blip_and_force_split():
    from mmlspark_tpu_torch.cognitive import WavStream

    # a 40ms blip is dropped (min_utterance_ms=100)
    wav = _make_speech_wav([(0.2, False), (0.04, True), (0.3, False)])
    assert list(WavStream(wav).utterances()) == []
    # a long monologue force-splits at max_utterance_ms
    wav = _make_speech_wav([(1.0, True)])
    utts = list(WavStream(wav).utterances(max_utterance_ms=400))
    assert len(utts) >= 2
    assert all(1000.0 * (len(p) // 2) / 16000 <= 500.0 for _, p in utts)


def test_wav_stream_all_silence_yields_nothing():
    from mmlspark_tpu_torch.cognitive import WavStream

    assert list(WavStream(_make_speech_wav([(0.5, False)])).utterances()) == []


def test_speech_sdk_utterance_segmentation(mock_url):
    """Default wav behavior: one request per spoken utterance, split at
    the pause — not at 2000ms window edges."""
    from mmlspark_tpu_torch.cognitive import SpeechToTextSDK, WavStream

    audio = np.empty(1, dtype=object)
    audio[0] = _make_speech_wav([(0.3, True), (0.5, False), (0.4, True)])
    t = Table({"audio": audio})
    out = SpeechToTextSDK(
        url=f"{mock_url}/speech/recognition/conversation/cognitiveservices/v1",
        concurrency=1).transform(t)
    segs = out["output"][0]
    assert len(segs) == 2
    assert segs[0]["StreamOffsetMs"] == pytest.approx(0.0, abs=65.0)
    assert segs[1]["StreamOffsetMs"] == pytest.approx(800.0, abs=65.0)
    # every utterance shipped as a self-contained parseable wav
    # (mock echoes the byte count: header + pcm)
    for seg, want_ms in zip(segs, (300.0, 400.0)):
        pcm_bytes = seg["bytes"] - 44
        assert 1000.0 * (pcm_bytes // 2) / 16000 == pytest.approx(
            want_ms, abs=80.0)


def test_wav_stream_quiet_speech_still_voiced():
    """Quiet-but-real speech (~1.4% full scale) must not be dropped by the
    adaptive threshold's absolute floor."""
    from mmlspark_tpu_torch.cognitive import WavStream

    wav = _make_speech_wav([(0.3, True), (0.5, False), (0.4, True)], amp=450)
    utts = list(WavStream(wav).utterances(silence_ms=300))
    assert len(utts) == 2


def test_wav_stream_noise_only_not_voiced():
    from mmlspark_tpu_torch.cognitive import WavStream
    import struct as _struct

    rng = np.random.default_rng(3)
    pcm = rng.integers(-8, 8, 16000, np.int16).tobytes()  # tiny noise floor
    hdr = _struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                       b"fmt ", 16, 1, 1, 16000, 32000, 2, 16,
                       b"data", len(pcm))
    assert list(WavStream(hdr + pcm).utterances()) == []


def test_speech_sdk_zero_sample_rate_isolated(mock_url):
    """A wav whose fmt chunk declares sample_rate=0 must not crash the
    stage (per-row failure isolation)."""
    from mmlspark_tpu_torch.cognitive import SpeechToTextSDK
    import struct as _struct

    pcm = (np.full(8000, 5000, np.int16)).tobytes()
    bad = _struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE",
                       b"fmt ", 16, 1, 1, 0, 0, 2, 16, b"data", len(pcm))
    audio = np.empty(2, dtype=object)
    audio[0] = bad + pcm
    audio[1] = _make_speech_wav([(0.3, True)])
    t = Table({"audio": audio})
    out = SpeechToTextSDK(
        url=f"{mock_url}/speech/recognition/conversation/cognitiveservices/v1",
        concurrency=1).transform(t)
    # the zero-rate row still segments (rate clamped to 1) or errors — but
    # the GOOD row must come through either way
    assert len(out["output"][1]) == 1


def test_speech_sdk_segmentation_typo_rejected(mock_url):
    from mmlspark_tpu_torch.cognitive import SpeechToTextSDK

    audio = np.empty(1, dtype=object)
    audio[0] = _make_speech_wav([(0.3, True)])
    t = Table({"audio": audio})
    with pytest.raises(ValueError, match="segmentation"):
        SpeechToTextSDK(
            url=(f"{mock_url}/speech/recognition/conversation/"
                 "cognitiveservices/v1"),
            segmentation="utterances").transform(t)


# ------------------------- the two packages side by side ------------------

def _parity_cases(url):
    imgs = np.empty(2, dtype=object)
    imgs[0], imgs[1] = b"\x89PNG fake bytes", None
    series = (np.empty(2, dtype=object), np.empty(2, dtype=object))
    series[0][0] = series[0][1] = ["2024-01-01T00:00:00Z",
                                   "2024-01-02T00:00:00Z"]
    series[1][0], series[1][1] = [1.0, 2.0], [3.0, 500.0]
    return {
        "TextSentiment": (dict(url=f"{url}/text/analytics/v3.0/sentiment",
                               subscription_key="k1"),
                          {"text": ["great day", None, "bad day"]}),
        "Translate": (dict(url=f"{url}/translate", subscription_key="k2",
                           to_language="es,fr"),
                      {"text": ["hello", "bye"]}),
        "DetectAnomalies": (dict(
            url=f"{url}/anomalydetector/v1.0/timeseries/entire/detect",
            subscription_key="k3"), {"timestamps": series[0],
                                     "values": series[1]}),
        "AnalyzeImage": (dict(url=f"{url}/vision/v3.2/analyze",
                              subscription_key="k4", image_url_col="urls"),
                         {"urls": ["http://img/a.jpg", None]}),
        "OCR": (dict(url=f"{url}/vision/v3.2/ocr", subscription_key="k5",
                     image_bytes_col="image"), {"image": imgs}),
        "ReadImage": (dict(url=f"{url}/vision/v3.2/read/analyze",
                           subscription_key="k6", image_url_col="urls",
                           polling_interval_ms=1),
                      {"urls": ["http://img/b.jpg"]}),
        "DictionaryLookup": (dict(url=f"{url}/dictionary/lookup",
                                  subscription_key="k7", from_language="en",
                                  to_language="es"),
                             {"text": ["fly", "tree"]}),
        "BingImageSearch": (dict(url=f"{url}/images/search",
                                 subscription_key="k8", count=3),
                            {"query": ["cats", "dogs"]}),
    }


def _requests(since):
    return [(e["method"], e["path"], e.get("body"))
            for e in _MockService.log[since:]]


@pytest.mark.parametrize("name", ["TextSentiment", "Translate",
                                  "DetectAnomalies", "AnalyzeImage", "OCR",
                                  "ReadImage", "DictionaryLookup",
                                  "BingImageSearch"])
def test_the_port_sends_and_parses_as_the_jax_package(mock_url, name):
    import mmlspark_tpu
    import mmlspark_tpu.cognitive as jcog

    import mmlspark_tpu_torch.cognitive as pcog

    kw, cols = _parity_cases(mock_url)[name]
    runs = []
    for cog, table in ((jcog, mmlspark_tpu.Table), (pcog, Table)):
        since = len(_MockService.log)
        stage = getattr(cog, name)(concurrency=1, **kw)
        out = stage.transform(table(dict(cols)))
        # the async ids the mock hands out differ between the two runs
        reqs = [(m, p.replace(p.rsplit("/", 1)[-1], "<op>")
                 if "/read/result/" in p else p, b)
                for m, p, b in _requests(since)]
        runs.append((out, reqs, stage.simple_param_values()))
    (jout, jreqs, jparams), (pout, preqs, pparams) = runs
    assert pparams == jparams
    assert preqs == jreqs and preqs
    assert pout.column_names == jout.column_names
    for col in ("output", "errors"):
        assert list(pout[col]) == list(jout[col]), col
