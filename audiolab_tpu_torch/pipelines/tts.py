"""TTS pipeline: the Zonos engine (counterpart of
audiolab_tpu/pipelines/tts.py:1-190,257-297).

Text is split into sentence chunks; ``[emotion]`` tags set the emotion
vector of the chunks that follow; the chunks are batched into one
``generate`` call (the CFG double batch inside, one captured decode step
replayed on the card), decoded by DAC together, and joined with short
silences.  The speaker embedding comes from a reference WAV through the
port's mel front-end and the speaker encoder.  Dia, XTTS and Chatterbox
come with their models.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.models.codecs import DACConfig, DACDecoder
from audiolab_tpu_torch.models.phonemize import phonemize_ids, phonemize_ipa
from audiolab_tpu_torch.models.zonos import (
    ZONOS_PHONEME_VOCAB,
    SpeakerEncoder,
    ZonosConfig,
    ZonosModel,
    generate,
    tokenize_phonemes_np,
    tokenize_text,
)
from audiolab_tpu_torch.utils.fast_init import fast_init

EMOTIONS = ("happiness", "sadness", "disgust", "fear", "surprise",
            "anger", "other", "neutral")

_TAG_RE = re.compile(r"\[(%s)\]" % "|".join(EMOTIONS), re.IGNORECASE)
_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def parse_emotion_chunks(text: str) -> list[tuple[str, np.ndarray]]:
    """Split text into (sentence, emotion_vector) chunks; ``[emotion]`` tags
    switch the 8-d emotion vector for subsequent text."""
    base = np.full(8, 0.05, np.float32)
    base[-1] = 1.0  # neutral default
    chunks: list[tuple[str, np.ndarray]] = []
    cur = base
    pos = 0
    for m in _TAG_RE.finditer(text):
        seg = text[pos: m.start()].strip()
        if seg:
            for s in _SENT_RE.split(seg):
                if s.strip():
                    chunks.append((s.strip(), cur))
        vec = np.full(8, 0.05, np.float32)
        vec[EMOTIONS.index(m.group(1).lower())] = 1.0
        cur = vec
        pos = m.end()
    tail = text[pos:].strip()
    if tail:
        for s in _SENT_RE.split(tail):
            if s.strip():
                chunks.append((s.strip(), cur))
    return chunks or [(text.strip() or " ", base)]


@dataclass
class ZonosTTSConfig:
    sr: int = 44100
    frame_rate: float = 86.0
    max_seconds: float = 30.0   # reference 30 s token cap (model.py:194)
    cfg_scale: float = 2.0
    # published sampling defaults (model.py:202, sampling.py:101-109)
    top_k: int = 0
    min_p: float = 0.1
    repetition_penalty: float = 3.0
    temperature: float = 1.0
    silence_ms: float = 120.0
    text_max_len: int = 256
    use_phonemes: bool = True   # rule-based G2P front-end; False = raw chars


class ZonosTTS:
    """The Zonos model, its DAC decoder and speaker encoder on one device
    (default the card; raises without one); synthesizes text."""

    voices = ["default"]

    def __init__(self, model: ZonosModel, dac: DACDecoder, spk_enc: SpeakerEncoder | None = None,
                 cfg: ZonosTTSConfig | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg or ZonosTTSConfig()
        self.model = model.to(self.device).eval()
        self.dac = dac.to(self.device).eval()
        self.spk_enc = None if spk_enc is None else spk_enc.to(self.device).eval()
        self._default_spk = np.zeros((model.cfg.spk_dim,), np.float32)
        # seconds of the last synthesize's stages (prefill_s, decode_s, dac_s)
        self.last_stats: dict = {}

    @torch.inference_mode()
    def make_speaker_embedding(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """Reference WAV -> speaker vector (model.py:70 equivalent)."""
        if self.spk_enc is None:
            return self._default_spk
        if sr != 16000:
            wav = resample_poly_np(np.asarray(wav, np.float32), sr, 16000)
        x = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)[None]
        mel = log_mel(mel_spectrogram(x, sr=16000, n_fft=1024, hop=256, n_mels=80))
        return self.spk_enc(mel)[0].cpu().numpy()

    def encode_text(self, chunks) -> tuple[np.ndarray, np.ndarray, int]:
        """(text ids (n, text_max_len), emotions (n, 8), frames) of the chunks."""
        c = self.cfg
        n, tmax = len(chunks), c.text_max_len
        text_ids = np.zeros((n, tmax), np.int32)
        emotions = np.zeros((n, 8), np.float32)
        for i, (s, em) in enumerate(chunks):
            if self.model.cfg.vocab_text == ZONOS_PHONEME_VOCAB:
                # converted checkpoint: ids from the espeak-IPA front-end and
                # the published symbol table (conditioning.py:148-158)
                ids = tokenize_phonemes_np([phonemize_ipa(s)])[0][:tmax]
            elif c.use_phonemes:
                ids = phonemize_ids(s, tmax)
            else:
                ids = tokenize_text(s, tmax)
            text_ids[i, : len(ids)] = ids
            emotions[i] = em
        # the frame budget follows the longest chunk (one static shape for the
        # batch; shorter chunks EOS out early)
        words = max(len(s.split()) for s, _ in chunks)
        secs = min(c.max_seconds, max(1.5, 0.45 * words + 0.8))
        return text_ids, emotions, int(secs * c.frame_rate)

    @torch.inference_mode()
    def synthesize(self, text: str, speaker: np.ndarray | None = None, seed: int = 0,
                   rate: float = 15.0, pitch: float = 20.0, draws=None,
                   timed: bool = False) -> tuple[np.ndarray, int]:
        """Text -> (waveform, sr).  Chunks are batched into one decode.

        ``draws`` goes to :func:`generate` (by default the draws come from a
        generator seeded with ``seed``).  ``timed`` synchronises the stages
        and records their seconds in ``last_stats``."""
        c = self.cfg
        chunks = parse_emotion_chunks(text)
        n = len(chunks)
        text_ids, emotions, frames = self.encode_text(chunks)
        spk = speaker if speaker is not None else self._default_spk
        stats = {} if timed else None
        codes = generate(
            self.model, text_ids, np.tile(np.asarray(spk, np.float32)[None], (n, 1)),
            max_frames=frames, emotion=emotions, rate=np.full((n, 1), rate, np.float32),
            pitch=np.full((n, 1), pitch, np.float32), cfg_scale=c.cfg_scale,
            temperature=c.temperature, top_k=c.top_k, min_p=c.min_p,
            repetition_penalty=c.repetition_penalty, seed=seed, draws=draws, stats=stats,
            device=self.device)
        t0 = time.perf_counter()
        codes = torch.clamp(codes, 0, self.model.cfg.codebook_size - 3)   # drop eos/mask
        audio = self.dac(codes).cpu().numpy()
        if stats is not None:
            stats.update(dac_s=time.perf_counter() - t0, batch=n, frames=frames)
            self.last_stats = stats
        sil = np.zeros(int(c.silence_ms / 1000.0 * c.sr), np.float32)
        parts = []
        for i in range(n):
            parts.append(audio[i])
            if i < n - 1:
                parts.append(sil)
        return np.concatenate(parts), c.sr

    # serve/tts_api backend protocol -------------------------------------
    def generate(self, text: str, voice: str = "default", speed: float = 1.0,
                 **kw) -> tuple[np.ndarray, int]:
        return self.synthesize(text, rate=15.0 * float(speed), **kw)


def register_default_backends(tts_api, zonos=None, dia=None, xtts=None,
                              chatterbox=None) -> None:
    """Engine table mirroring layouts/tts.py:570 generate_tts dispatch (zonos,
    coqui/XTTS, chatterbox, dia); where a dedicated engine is not supplied,
    the closest stack stands in so the endpoint stays live."""
    if zonos is not None:
        tts_api.register_backend("zonos", zonos)
    if xtts is not None:
        tts_api.register_backend("coqui", xtts)
    elif zonos is not None:
        tts_api.register_backend("coqui", zonos)
    if dia is not None:
        tts_api.register_backend("dia", dia)
    if chatterbox is not None:
        tts_api.register_backend("chatterbox", chatterbox)
    elif dia is not None:
        tts_api.register_backend("chatterbox", dia)


def random_zonos(model_cfg: ZonosConfig | None = None, seed: int = 0,
                 dac_cfg: DACConfig | None = None, device: str | torch.device = "cuda"):
    """Random-weight ZonosTTS on ``device`` (default the card), weights by
    utils/fast_init's rules from ``seed``.  Without configurations it is the
    JAX package's tiny demo model; ``dac_cfg`` defaults to a 64-wide DAC."""
    dev = resolve_device(device)
    mc = model_cfg or ZonosConfig(dim=64, n_layers=2, attn_every=2, n_heads=4, d_state=4,
                                  n_codebooks=9, codebook_size=1026, spk_dim=64)
    dac_cfg = dac_cfg or DACConfig(dim=64, rates=(8, 8, 4, 2), n_q=mc.n_codebooks,
                                   codebook_size=mc.codebook_size, codebook_dim=8)
    with dev:      # made on the device: torch's CPU initialisers are skipped
        model = fast_init(ZonosModel(mc), seed)
        dac = fast_init(DACDecoder(dac_cfg), seed + 1)
        spk = fast_init(SpeakerEncoder(mc.spk_dim), seed + 2)
    return ZonosTTS(model, dac, spk, device=dev)
