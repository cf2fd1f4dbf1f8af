"""Transcription pipeline: windows -> tokens -> timed segments -> exports
(counterpart of audiolab_tpu/pipelines/transcribe.py).

Whisper over 30 s windows (or over speech chunks from a VAD), timestamp
tokens -> segments, word timings from the wav2vec2 CTC aligner when one is
loaded (else the energy aligner), speaker labels from diarization turns,
and the JSON / TXT / SRT / VTT / LRC exports.  The tokenizer is injected;
without one the JAX package's toy detokenizer is used.  The model work runs
on the transcriber's device (the card unless the caller asks for the CPU);
the segmenting, aligning trellis and formatting are host code copied from
the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.models.pyannet import PyanNet, powerset_to_multilabel
from audiolab_tpu_torch.models.whisper import (
    WhisperConfig,
    WhisperModel,
    log_mel_30s,
    transcribe_window,
)
from audiolab_tpu_torch.pipelines.forced_align import energy_align_words
from audiolab_tpu_torch.utils.fast_init import fast_init


@dataclass
class Segment:
    start: float
    end: float
    text: str
    speaker: str | None = None
    words: list = field(default_factory=list)


def merge_vad_regions(regions: list[tuple[float, float]],
                      max_len: float = 30.0,
                      max_gap: float = 1.0) -> list[tuple[float, float]]:
    """WhisperX merge_chunks role: greedily merge speech regions into
    <= 30 s transcription chunks, splitting over-long regions."""
    chunks: list[tuple[float, float]] = []
    cur_s = cur_e = None
    for s, e in regions:
        while e - s > max_len:  # split a single over-long region
            if cur_s is not None:
                chunks.append((cur_s, cur_e))
                cur_s = cur_e = None
            chunks.append((s, s + max_len))
            s += max_len
        if cur_s is None:
            cur_s, cur_e = s, e
        elif e - cur_s <= max_len and s - cur_e <= max_gap:
            cur_e = e
        else:
            chunks.append((cur_s, cur_e))
            cur_s, cur_e = s, e
    if cur_s is not None:
        chunks.append((cur_s, cur_e))
    return [(s, e) for s, e in chunks if e - s > 0.05]


def pyannet_vad(model: PyanNet, threshold: float = 0.5, min_gap: float = 0.25,
                min_dur: float = 0.1, device: str | torch.device = "cuda"):
    """Speech-activity callable from the pyannote segmentation net
    (models/pyannet.py), moved to ``device`` (default the card; raises
    without one): 10 s windows, a frame is speech when any speaker is
    active.  Returns ``vad(x, sr) -> [(start_s, end_s), ...]``."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    win = 10 * 16000  # pyannote 10 s windows

    def vad(x: np.ndarray, sr: int) -> list[tuple[float, float]]:
        x = np.asarray(x, np.float32)
        if x.ndim > 1:
            x = x.mean(axis=0)
        if sr != 16000:
            x = resample_poly_np(x, sr, 16000)
        n = len(x)
        k = max(1, -(-n // win))
        xp = np.pad(x, (0, k * win - n))
        with torch.inference_mode():
            lp = model(torch.from_numpy(xp.reshape(k, win)).to(dev))
            active = powerset_to_multilabel(lp).amax(dim=-1).reshape(-1).cpu().numpy()
        frames_per_win = lp.shape[1]
        sec_per_frame = (win / 16000) / frames_per_win
        total_frames = int(np.ceil((n / 16000) / sec_per_frame))
        active = active[:total_frames] > threshold
        # frames -> regions, closing gaps < min_gap
        regions = []
        start = None
        for i, a in enumerate(active):
            if a and start is None:
                start = i
            elif not a and start is not None:
                regions.append((start * sec_per_frame, i * sec_per_frame))
                start = None
        if start is not None:
            regions.append((start * sec_per_frame, len(active) * sec_per_frame))
        merged = []
        for s, e in regions:
            if merged and s - merged[-1][1] < min_gap:
                merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        return [(s, e) for s, e in merged if e - s >= min_dur]

    return vad


def tokens_to_segments(
    tokens: np.ndarray, cfg: WhisperConfig, detokenize: Callable[[list[int]], str],
    window_offset: float = 0.0,
) -> list[Segment]:
    """Split one window's token stream at timestamp tokens
    (<|t|> text <|t|> pairs, whisper convention)."""
    segs: list[Segment] = []
    cur_start = None
    cur: list[int] = []
    for t in tokens.tolist():
        if t == cfg.eot:
            break
        if t >= cfg.timestamp_base:
            ts = (t - cfg.timestamp_base) * 0.02 + window_offset
            if cur_start is None:
                cur_start = ts
            else:
                text = detokenize(cur).strip()
                if text:
                    segs.append(Segment(cur_start, ts, text))
                cur_start, cur = ts, []
        elif t < cfg.sot and t != cfg.no_timestamps:
            cur.append(t)
    if cur and cur_start is not None:
        segs.append(Segment(cur_start, cur_start + 2.0, detokenize(cur).strip()))
    return [s for s in segs if s.text]


def assign_speakers(segments: list[Segment], turns: list[tuple[float, float, str]]
                    ) -> None:
    """Label each segment with the diarization turn of max overlap."""
    for s in segments:
        best, best_ov = None, 0.0
        for t0, t1, spk in turns:
            ov = max(0.0, min(s.end, t1) - max(s.start, t0))
            if ov > best_ov:
                best, best_ov = spk, ov
        s.speaker = best


# ------------------------------------------------------------------ exports

def _fmt_ts(t: float, comma: bool = True) -> str:
    h = int(t // 3600)
    m = int(t % 3600 // 60)
    s = t % 60
    sep = "," if comma else "."
    return f"{h:02d}:{m:02d}:{int(s):02d}{sep}{int(round((s % 1) * 1000)):03d}"


def to_txt(segments: list[Segment]) -> str:
    return "\n".join(
        (f"[{s.speaker}] " if s.speaker else "") + s.text for s in segments
    )


def to_json(segments: list[Segment]) -> str:
    return json.dumps(
        {"segments": [
            {"start": s.start, "end": s.end, "text": s.text,
             "speaker": s.speaker, "words": s.words or []}
            for s in segments
        ]}, indent=1)


def to_srt(segments: list[Segment]) -> str:
    out = []
    for i, s in enumerate(segments, 1):
        out.append(f"{i}\n{_fmt_ts(s.start)} --> {_fmt_ts(s.end)}\n{s.text}\n")
    return "\n".join(out)


def to_vtt(segments: list[Segment]) -> str:
    out = ["WEBVTT", ""]
    for s in segments:
        out.append(f"{_fmt_ts(s.start, False)} --> {_fmt_ts(s.end, False)}")
        out.append(s.text)
        out.append("")
    return "\n".join(out)


def to_lrc(segments: list[Segment]) -> str:
    out = []
    for s in segments:
        m = int(s.start // 60)
        sec = s.start % 60
        out.append(f"[{m:02d}:{sec:05.2f}]{s.text}")
    return "\n".join(out)


FORMATTERS = {"txt": to_txt, "json": to_json, "srt": to_srt, "vtt": to_vtt,
              "lrc": to_lrc}


# ------------------------------------------------------------------ engine

class Transcriber:
    """Whisper model + tokenizer behind the transcription backend protocol
    (serve/transcribe_api): ``.transcribe(samples, sr, **kw) -> dict``.

    ``model`` is moved to ``device`` (default the card; raises without
    one).  ``aligner``: a ``models.wav2vec2.CTCWordAligner`` for word
    timings (else the energy aligner); ``vad``: a speech-activity callable
    (``pyannet_vad``) whose merged chunks are decoded instead of blind 30 s
    tiling."""

    def __init__(self, model: WhisperModel, detokenize: Callable[[list[int]], str] | None = None,
                 aligner=None, vad=None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.model = model.to(self.device).eval()
        self.aligner = aligner
        self.vad = vad
        self.detokenize = detokenize or (
            lambda ids: "".join(chr(32 + (i % 90)) for i in ids))

    def __call__(self, samples, sr: int) -> str:
        """The text of ``samples``: the callable a cloning facade's
        ``transcriber`` is (Clone by TTS without a custom text)."""
        return self.transcribe(samples, sr)["text"]

    def _decode(self, mels: torch.Tensor, max_tokens: int) -> np.ndarray:
        return transcribe_window(self.model, mels, max_tokens=max_tokens,
                                 device=self.device).cpu().numpy()

    def transcribe(self, samples, sr: int | None = None, max_tokens: int = 64,
                   response_format: str = "json", diarize_turns=None, **_) -> dict:
        """``samples`` is a (n,) array + sr, or a path (serve protocol)."""
        if isinstance(samples, (str, bytes)):
            from audiolab_tpu_torch.core.audio_io import read_audio

            a = read_audio(str(samples)).to_mono()
            samples, sr = a.samples[0], a.sample_rate
        if sr is None:
            raise ValueError("sr required with array input")
        x = np.asarray(samples, np.float32)
        if x.ndim > 1:
            x = x.mean(axis=0)
        if sr != self.cfg.sr:
            x = resample_poly_np(x, sr, self.cfg.sr)
        chunks = merge_vad_regions(self.vad(x, self.cfg.sr)) if self.vad is not None else None
        segments: list[Segment] = []
        if chunks:
            # VAD-segmented decoding: one padded 30 s window per speech
            # chunk, timestamps offset by the chunk start
            win = 30 * self.cfg.sr
            slices = []
            for s0, e0 in chunks:
                seg = x[int(s0 * self.cfg.sr):int(e0 * self.cfg.sr)]
                slices.append(np.pad(seg, (0, max(0, win - len(seg))))[:win])
            mels = log_mel_30s(np.concatenate(slices), self.cfg, self.device)[: len(slices)]
            toks = self._decode(mels, max_tokens)
            for w, (s0, _e0) in enumerate(chunks):
                segments.extend(tokens_to_segments(toks[w], self.cfg, self.detokenize,
                                                   window_offset=s0))
        else:
            toks = self._decode(log_mel_30s(x, self.cfg, self.device), max_tokens)
            for w in range(toks.shape[0]):
                segments.extend(tokens_to_segments(toks[w], self.cfg, self.detokenize,
                                                   window_offset=30.0 * w))
        # word timings: the CTC aligner when loaded, else the energy heuristic
        for s in segments:
            if self.aligner is not None:
                s.words = self.aligner.align_words(x, self.cfg.sr, s.start, s.end,
                                                   s.text.split())
            else:
                s.words = energy_align_words(x, self.cfg.sr, s.start, s.end, s.text.split())
        if diarize_turns:
            assign_speakers(segments, diarize_turns)
        out = {"text": to_txt(segments),
               "segments": json.loads(to_json(segments))["segments"]}
        if response_format in FORMATTERS and response_format != "json":
            out["formatted"] = FORMATTERS[response_format](segments)
        return out


# the JAX package's tiny demo configuration (random_transcriber)
DEMO_CONFIG = WhisperConfig(n_mels=80, dim=64, n_heads=4, n_audio_layers=1, n_text_layers=1,
                            vocab_size=600, n_text_ctx=128, sot=520, eot=519,
                            no_timestamps=530, timestamp_base=531)


def random_transcriber(seed: int = 0, device: str | torch.device = "cuda") -> Transcriber:
    """Tiny random-weight engine (the JAX package's demo widths) on
    ``device`` (default the card), weights by utils/fast_init's rules from
    ``seed``."""
    dev = resolve_device(device)
    with dev:
        model = fast_init(WhisperModel(DEMO_CONFIG), seed)
    return Transcriber(model, device=dev)
