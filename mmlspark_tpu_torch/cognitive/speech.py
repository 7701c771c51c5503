"""Streaming speech recognition: chunked audio -> incremental results.

Reference: cognitive/SpeechToTextSDK.scala:76-489 — per-row recognizers fed
by pulled audio streams (WavStream / CompressedStream, AudioStreams.scala:94)
emitting a row per recognized utterance.  The native Speech SDK's websocket
session is replaced by windowed recognition requests over the same REST
surface as `SpeechToText`: each audio window is posted as one utterance and
the per-row output is the ordered list of segment results (optionally
flattened to a row per utterance, matching the reference's emitted rows).

A copy of the JAX package's `cognitive/speech.py` for this package.
"""
from __future__ import annotations

import json
import struct
from typing import Iterator, List, Optional, Tuple
from urllib.parse import urlencode

import numpy as np

from ..core.params import Param, ServiceParam, TypeConverters
from ..core.registry import register_stage
from ..core.schema import Table
from ..io.http.schema import HTTPRequestData
from .base import CognitiveServicesBase

__all__ = ["WavStream", "CompressedStream", "SpeechToTextSDK",
           "ConversationTranscription"]


class WavStream:
    """Pulled WAV audio stream (AudioStreams.scala WavStream): parses the
    RIFF header and yields windows of whole PCM frames."""

    def __init__(self, data: bytes):
        if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE stream")
        # walk chunks to find fmt + data (canonical files: fmt at 12, data later)
        pos = 12
        self.sample_rate = 16000
        self.channels = 1
        self.bits_per_sample = 16
        self.pcm = b""
        while pos + 8 <= len(data):
            cid = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            body = data[pos + 8:pos + 8 + size]
            if cid == b"fmt ":
                (_fmt, self.channels, self.sample_rate, _bps, _align,
                 self.bits_per_sample) = struct.unpack("<HHIIHH", body[:16])
            elif cid == b"data":
                self.pcm = body
            pos += 8 + size + (size % 2)
        self.frame_bytes = max(self.channels * self.bits_per_sample // 8, 1)

    @property
    def duration_ms(self) -> float:
        frames = len(self.pcm) // self.frame_bytes
        return 1000.0 * frames / max(self.sample_rate, 1)

    def windows(self, window_ms: int) -> Iterator[Tuple[float, bytes]]:
        """(offset_ms, pcm_window) pairs of whole frames."""
        rate = max(self.sample_rate, 1)  # corrupt fmt chunks declare 0
        frames_per_window = max(int(rate * window_ms / 1000.0), 1)
        step = frames_per_window * self.frame_bytes
        for off in range(0, len(self.pcm), step):
            offset_ms = 1000.0 * (off // self.frame_bytes) / rate
            yield offset_ms, self.pcm[off:off + step]

    def utterances(self, silence_ms: int = 300, frame_ms: int = 30,
                   energy_threshold: Optional[float] = None,
                   min_utterance_ms: int = 100,
                   max_utterance_ms: int = 20000
                   ) -> Iterator[Tuple[float, bytes]]:
        """(offset_ms, pcm_segment) per detected utterance — energy/silence
        endpointing over PCM frames, the native SDK's event-driven
        continuous-recognition semantics (SpeechToTextSDK.scala:76-489):
        segments end at pauses, never mid-word.

        A frame is voiced when its RMS exceeds the threshold (auto: the
        louder of ~1% full scale and 2x the 20th-percentile frame RMS, so
        both digital silence and mild noise floors endpoint cleanly).  A
        run of `silence_ms` unvoiced frames closes the utterance; segments
        get one frame of leading/trailing context, blips shorter than
        `min_utterance_ms` are dropped, and `max_utterance_ms` force-splits
        so one long monologue can't become an unbounded request.  Non-16-bit
        PCM falls back to fixed `max_utterance_ms` windows (no decode path).
        """
        if self.bits_per_sample != 16 or not self.pcm:
            yield from self.windows(max_utterance_ms)
            return
        x = np.frombuffer(
            self.pcm[:len(self.pcm) - len(self.pcm) % self.frame_bytes],
            dtype="<i2").astype(np.float32)
        if self.channels > 1:
            x = x.reshape(-1, self.channels).mean(axis=1)
        rate = max(self.sample_rate, 1)  # corrupt fmt chunks declare 0
        spf = max(int(rate * frame_ms / 1000.0), 1)
        n_frames = -(-len(x) // spf)
        pad = np.zeros(n_frames * spf - len(x), np.float32)
        frames = np.concatenate([x, pad]).reshape(n_frames, spf)
        rms = np.sqrt(np.mean(frames * frames, axis=1))
        if energy_threshold is None:
            # 2x the quiet end of the tape (but at least ~1% full scale),
            # capped at half its loud end so quiet-but-real speech and
            # tapes with no silence both stay voiced; the ~0.2%-scale
            # outer floor keeps a noise-only tape from becoming speech
            floor = float(np.percentile(rms, 20)) if n_frames else 0.0
            loud = float(np.percentile(rms, 95)) if n_frames else 0.0
            energy_threshold = max(
                65.0, min(max(327.0, 2.0 * floor), 0.5 * loud))
        voiced = rms > energy_threshold
        silence_frames = max(int(round(silence_ms / frame_ms)), 1)
        min_frames = max(int(round(min_utterance_ms / frame_ms)), 1)
        max_frames = max(int(round(max_utterance_ms / frame_ms)), 1)

        def emit(f0: int, f1: int):
            # one frame of context each side; slice whole PCM frames
            f0, f1 = max(f0 - 1, 0), min(f1 + 1, n_frames)
            s0, s1 = f0 * spf, min(f1 * spf, len(x))
            off_ms = 1000.0 * s0 / rate
            return off_ms, self.pcm[s0 * self.frame_bytes:
                                    s1 * self.frame_bytes]

        start = None   # first voiced frame of the open utterance
        last_voiced = None
        for f in range(n_frames):
            if voiced[f]:
                if start is None:
                    start = f
                last_voiced = f
                if f - start + 1 >= max_frames:  # force-split
                    yield emit(start, f + 1)
                    start = last_voiced = None
            elif start is not None and f - last_voiced >= silence_frames:
                if last_voiced - start + 1 >= min_frames:
                    yield emit(start, last_voiced + 1)
                start = last_voiced = None
        if start is not None and last_voiced - start + 1 >= min_frames:
            yield emit(start, last_voiced + 1)

    def window_wav(self, pcm_window: bytes) -> bytes:
        """Re-wrap a PCM window in a minimal WAV container so each request
        is a self-describing utterance."""
        byte_rate = self.sample_rate * self.frame_bytes
        hdr = struct.pack(
            "<4sI4s4sIHHIIHH4sI",
            b"RIFF", 36 + len(pcm_window), b"WAVE", b"fmt ", 16, 1,
            self.channels, self.sample_rate, byte_rate, self.frame_bytes,
            self.bits_per_sample, b"data", len(pcm_window))
        return hdr + pcm_window


class CompressedStream:
    """Opaque compressed audio (AudioStreams.scala CompressedStream): no
    header knowledge — fixed-size byte windows, offsets unknown."""

    def __init__(self, data: bytes):
        self.data = data

    def windows(self, window_bytes: int) -> Iterator[Tuple[float, bytes]]:
        for off in range(0, len(self.data), window_bytes):
            yield -1.0, self.data[off:off + window_bytes]


@register_stage
class SpeechToTextSDK(CognitiveServicesBase):
    """Continuous recognition over per-row audio streams.

    Reference: SpeechToTextSDK.scala:76-489.  Wav rows are segmented at
    silence boundaries (energy endpointing over PCM frames — the native
    SDK recognizer's event-driven utterance semantics; words are never
    split at arbitrary window edges); compressed rows fall back to fixed
    byte windows.  Every segment is recognized as one utterance;
    `output_col` holds the ordered list of result dicts, each annotated
    with its stream offset.  With `flatten_results` the stage emits one
    row per utterance instead — the reference's emitted-row shape.
    """

    _domain = "stt.speech.microsoft.com"
    _path = "/speech/recognition/conversation/cognitiveservices/v1"
    audio_col = Param("column of audio bytes", default="audio")
    language = ServiceParam("recognition language", default="en-US")
    format = Param("simple|detailed", default="simple")
    stream_format = Param("wav|compressed (windowing strategy)", default="wav")
    segmentation = Param(
        "utterance|window — wav streams segment at silence boundaries "
        "(energy endpointing; the native SDK's continuous-recognition "
        "semantics) or into fixed window_ms windows", default="utterance")
    silence_ms = Param("pause length that ends an utterance", default=300,
                       converter=TypeConverters.to_int)
    energy_threshold = Param("RMS frame-energy voicing threshold "
                             "(None = adaptive)", default=None)
    min_utterance_ms = Param("drop voiced blips shorter than this",
                             default=100, converter=TypeConverters.to_int)
    max_utterance_ms = Param("force-split utterances longer than this",
                             default=20000, converter=TypeConverters.to_int)
    window_ms = Param("recognition window for wav streams (ms) when "
                      "segmentation='window'", default=2000,
                      converter=TypeConverters.to_int)
    window_bytes = Param("recognition window for compressed streams (bytes)",
                         default=32768, converter=TypeConverters.to_int)
    flatten_results = Param("emit a row per utterance instead of a list "
                            "per input row", default=False,
                            converter=TypeConverters.to_bool)

    def _recognize_url(self, table, i) -> str:
        base = self._base_url()
        sep = "&" if "?" in base else "?"  # user urls may carry a query
        q = urlencode({"language": self.resolve("language", table, i),
                       "format": self.format})
        return f"{base}{sep}{q}"

    def _check_segmentation(self) -> str:
        seg_mode = self.get_or_default("segmentation")
        if seg_mode not in ("utterance", "window"):
            raise ValueError(
                f"segmentation must be 'utterance' or 'window', got "
                f"{seg_mode!r}")
        return seg_mode

    def _windows(self, audio: bytes):
        if self.stream_format == "wav":
            stream = WavStream(bytes(audio))
            if self.get_or_default("segmentation") == "utterance":
                thr = self.get_or_default("energy_threshold")
                segs = stream.utterances(
                    silence_ms=int(self.silence_ms),
                    energy_threshold=None if thr is None else float(thr),
                    min_utterance_ms=int(self.min_utterance_ms),
                    max_utterance_ms=int(self.max_utterance_ms))
            else:
                segs = stream.windows(int(self.window_ms))
            return [(off, stream.window_wav(w)) for off, w in segs]
        stream = CompressedStream(bytes(audio))
        return list(stream.windows(int(self.window_bytes)))

    def _transform(self, table: Table) -> Table:
        # validate config BEFORE the per-row loop: a typo'd segmentation
        # value must fail the stage, not be swallowed as a row error
        self._check_segmentation()
        n = len(table)
        audio_col = table[self.audio_col]
        # every window of every row is one request through the shared
        # bounded-concurrency pool (the continuous-recognition firehose)
        reqs: List[Optional[HTTPRequestData]] = []
        spans: List[Tuple[int, float]] = []  # (row, offset_ms) per request
        decode_errs: dict = {}
        for i in range(n):
            audio = audio_col[i]
            if audio is None:
                continue
            try:
                windows = self._windows(audio)
            except (ValueError, struct.error) as e:
                # one corrupt row must not fail the whole stage: route it
                # to error_col (SpeechToTextSDK.scala's per-row recognizer
                # failure isolation)
                decode_errs[i] = f"audio decode failed: {e}"
                continue
            for off, blob in windows:
                hdr = self._headers(table, i)
                hdr["Content-Type"] = ("audio/wav; codecs=audio/pcm; "
                                       "samplerate=16000")
                reqs.append(HTTPRequestData(
                    url=self._recognize_url(table, i), method="POST",
                    headers=hdr, entity=blob))
                spans.append((i, off))
        resps = self._client().send_all(reqs)

        per_row: List[List[dict]] = [[] for _ in range(n)]
        errs = np.empty(n, dtype=object)
        errs[:] = None
        for i, msg in decode_errs.items():
            errs[i] = msg
        for (row, off), resp in zip(spans, resps):
            if resp is None:
                continue
            if not resp.ok:
                errs[row] = f"{resp.status_code} {resp.reason}"
                continue
            try:
                seg = resp.json()
            except (ValueError, json.JSONDecodeError):
                seg = None
            if isinstance(seg, dict):
                seg = dict(seg)
                seg["StreamOffsetMs"] = off
                per_row[row].append(seg)

        if self.flatten_results:
            rows, segs = [], []
            for i, lst in enumerate(per_row):
                for seg in lst:
                    rows.append(i)
                    segs.append(seg)
            out = np.empty(len(segs), dtype=object)
            for j, s in enumerate(segs):
                out[j] = s
            flat = table.take(np.asarray(rows, np.int64))
            return flat.with_column(self.output_col, out)

        out = np.empty(n, dtype=object)
        for i, lst in enumerate(per_row):
            out[i] = lst
        result = table.with_column(self.output_col, out)
        if self.error_col:
            result = result.with_column(self.error_col, errs)
        return result

    def transform_schema(self, columns):
        return list(columns) + [self.output_col] + (
            [self.error_col] if self.error_col and not self.flatten_results
            else [])


@register_stage
class ConversationTranscription(SpeechToTextSDK):
    """Multi-speaker conversation transcription: the same windowed audio
    streaming as SpeechToTextSDK against the conversation-transcription
    endpoint, with the service's speaker attribution passed through on
    every utterance (reference SpeechToTextSDK.scala ConversationTranscription
    variant — there a different SDK recognizer class, same emitted schema
    plus speakerId)."""

    _path = ("/speech/recognition/conversation/cognitiveservices/v1"
             "?transcriptionMode=conversation")
