"""Voice-cloning facade: OpenVoice conversion, TTS cloning, diarization
(counterpart of audiolab_tpu/pipelines/cloning.py).

Reference surface (modules/cloning/main.py:19-149, SURVEY §2.3):
  - clone_voice_openvoice(src, ref): tone-color conversion in 10 s chunks
    with crossfade concat (openvoice.py:29-157)
  - clone_voice_tts(text, ref): routed to the Zonos engine with a speaker
    embedding from the reference
  - choose_speaker / split per speaker: a windowed-embedding k-means
    diarizer over the Zonos SpeakerEncoder (the fast path;
    :func:`neural_diarize` is the pyannote-class one)

Models run on their own device: the OpenVoice converter on the cloner's,
the speaker encoder on the one its parameters live on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audiolab_tpu_torch.core.chunking import extract_chunks, plan_chunks, stitch_chunks
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.kernels.stft import spectrogram
from audiolab_tpu_torch.models.openvoice import ToneColorConverter
from audiolab_tpu_torch.models.zonos import SpeakerEncoder
from audiolab_tpu_torch.retrieval.index import kmeans


# ------------------------------------------------------------------ openvoice

@dataclass
class OpenVoiceCloneConfig:
    chunk_seconds: float = 10.0
    overlap_seconds: float = 0.5


class OpenVoiceCloner:
    """A ToneColorConverter on ``device`` (default the card; raises without
    one): speaker embeddings and chunked tone-color conversion."""

    def __init__(self, model: ToneColorConverter, ccfg: OpenVoiceCloneConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.ccfg = ccfg or OpenVoiceCloneConfig()

    def _ref_spec(self, wav: torch.Tensor) -> torch.Tensor:
        # openvoice extracts speaker embeddings from the LINEAR spectrogram,
        # center=False as upstream extract_se (api.py:65-67)
        return spectrogram(wav, n_fft=self.cfg.n_fft, hop=self.cfg.hop, power=1.0,
                           center=False)

    @torch.inference_mode()
    def extract_se(self, wav: np.ndarray, sr: int) -> np.ndarray:
        x = np.asarray(wav, np.float32)
        if sr != self.cfg.sr:
            x = resample_poly_np(x, sr, self.cfg.sr)
        spec = self._ref_spec(torch.from_numpy(np.ascontiguousarray(x)).to(self.device)[None])
        return self.model.extract_se(spec)[0].cpu().numpy()

    @torch.inference_mode()
    def convert(self, src: np.ndarray, src_sr: int, ref: np.ndarray,
                ref_sr: int) -> tuple[np.ndarray, int]:
        """Tone-color conversion in chunked batches w/ crossfade stitch."""
        c = self.cfg
        x = np.asarray(src, np.float32)
        if src_sr != c.sr:
            x = resample_poly_np(x, src_sr, c.sr)
        dev = self.device
        g_src = torch.from_numpy(self.extract_se(x, c.sr)).to(dev)[None]
        g_tgt = torch.from_numpy(self.extract_se(ref, ref_sr)).to(dev)[None]

        chunk = int(self.ccfg.chunk_seconds * c.sr)
        chunk -= chunk % c.hop
        overlap = int(self.ccfg.overlap_seconds * c.sr)
        overlap -= overlap % c.hop
        plan = plan_chunks(len(x), chunk, overlap)
        chunks = extract_chunks(torch.from_numpy(np.ascontiguousarray(x)).to(dev), plan)
        spec = spectrogram(chunks, c.n_fft, c.hop, c.n_fft, center=True, power=1.0)
        frames = chunk // c.hop
        spec = spec[:, :frames]
        lengths = torch.full((plan.count,), frames, dtype=torch.long, device=dev)
        out = self.model.convert(spec, lengths, g_src.expand(plan.count, -1),
                                 g_tgt.expand(plan.count, -1))   # (count, frames * hop)
        y = stitch_chunks(out, plan)
        return y[: len(x)].float().cpu().numpy(), c.sr


# ------------------------------------------------------------------ diarization

def neural_diarize(wav: np.ndarray, sr: int, diarizer=None,
                   device: str | torch.device = "cuda") -> list[tuple[float, float, str]]:
    """pyannote-class two-stage diarization: EEND segmentation net +
    embedding clustering (models/diarize.py).  Pass a NeuralDiarizer with
    converted or trained weights for real accuracy; the default one has
    random weights on ``device``."""
    from audiolab_tpu_torch.models.diarize import NeuralDiarizer

    return (diarizer or NeuralDiarizer(device=device)).diarize(wav, sr)


def diarize(
    wav: np.ndarray, sr: int, spk_encoder: SpeakerEncoder,
    n_speakers: int = 2, window_s: float = 1.5, hop_s: float = 0.75,
) -> list[tuple[float, float, str]]:
    """Windowed speaker embeddings -> k-means -> merged turns (the fast
    fallback; neural_diarize is the pyannote-class path).  The encoder runs
    where its parameters are."""
    x = np.asarray(wav, np.float32)
    if sr != 16000:
        x = resample_poly_np(x, sr, 16000)
        sr = 16000
    win, hop = int(window_s * sr), int(hop_s * sr)
    if len(x) < win:
        return [(0.0, len(x) / sr, "SPEAKER_00")]
    starts = np.arange(0, len(x) - win + 1, hop)
    frames = np.stack([x[s: s + win] for s in starts])
    dev = next(spk_encoder.parameters()).device
    with torch.inference_mode():
        mel = log_mel(mel_spectrogram(torch.from_numpy(frames).to(dev), sr=sr, n_fft=1024,
                                      hop=256, n_mels=80, power=1.0))
        embs_t = spk_encoder(mel).float()
        cents = kmeans(embs_t, n_clusters=min(n_speakers, len(starts))).cpu().numpy()
    embs = embs_t.cpu().numpy()
    labels = np.argmax(embs @ cents.T, axis=-1)
    turns: list[tuple[float, float, str]] = []
    for i, lab in enumerate(labels):
        t0, t1 = starts[i] / sr, (starts[i] + win) / sr
        name = f"SPEAKER_{lab:02d}"
        if turns and turns[-1][2] == name and t0 <= turns[-1][1]:
            turns[-1] = (turns[-1][0], t1, name)
        else:
            turns.append((t0, t1, name))
    return turns


def split_speakers(wav: np.ndarray, sr: int, turns) -> dict[str, np.ndarray]:
    """Per-speaker concatenated audio (choose_speaker source material)."""
    out: dict[str, list[np.ndarray]] = {}
    for t0, t1, spk in turns:
        out.setdefault(spk, []).append(wav[int(t0 * sr): int(t1 * sr)])
    return {k: np.concatenate(v) for k, v in out.items() if v}


# ------------------------------------------------------------------ facade

class CloningFacade:
    """modules/cloning/main.py equivalent: method dispatch + voice store.
    ``tts`` is a ZonosTTS-compatible engine (``make_speaker_embedding``,
    ``synthesize``); ``transcriber`` a callable ``(samples, sr) -> text``
    (a ``pipelines.transcribe.Transcriber``) that Clone by TTS asks for the
    text when none is given."""

    methods = ["openvoice", "tts"]

    def __init__(self, openvoice: OpenVoiceCloner | None = None, tts=None,
                 spk_encoder: SpeakerEncoder | None = None, transcriber=None):
        self.openvoice = openvoice
        self.tts = tts
        self.spk_encoder = spk_encoder
        self.transcriber = transcriber
        self.voices: dict[str, np.ndarray] = {}

    def register_voice(self, name: str, wav: np.ndarray, sr: int) -> None:
        self.voices[name] = np.asarray(wav, np.float32)
        self.voices[name + "__sr"] = np.asarray([sr])

    def clone_voice_openvoice(self, src, src_sr, ref, ref_sr):
        if self.openvoice is None:
            raise NotImplementedError("openvoice converter not loaded")
        return self.openvoice.convert(src, src_sr, ref, ref_sr)

    def clone_voice_tts(self, text: str, ref, ref_sr):
        if self.tts is None:
            raise NotImplementedError("tts engine not loaded")
        spk = self.tts.make_speaker_embedding(ref, ref_sr)
        return self.tts.synthesize(text, speaker=spk)

    def choose_speaker(self, wav, sr, n_speakers=2, index=0):
        turns = diarize(wav, sr, self.spk_encoder, n_speakers)
        parts = split_speakers(np.asarray(wav, np.float32), sr, turns)
        names = sorted(parts)
        return parts[names[min(index, len(names) - 1)]], turns
