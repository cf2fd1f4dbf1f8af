"""TTS pipelines: the Zonos, Dia and XTTS engines (counterpart of
audiolab_tpu/pipelines/tts.py, Chatterbox aside).

Text is split into sentence chunks; ``[emotion]`` tags set the emotion
vector of the chunks that follow; the chunks are batched into one
``generate`` call (the CFG double batch inside, one captured decode step
replayed on the card), decoded by DAC together, and joined with short
silences.  The speaker embedding comes from a reference WAV through the
port's mel front-end and the speaker encoder.  ``DiaTTSEngine`` serves
Dia's dialogue model over a DAC decoder; ``XTTSEngine`` the capability XTTS
and ``XttsCheckpointEngine`` the XTTS-v2 stack, with ``XttsTokenizer`` for
its vocab.json.  ``ChatterboxCheckpointEngine`` serves Chatterbox: T3's
CFG decode over text, S3Gen's flow and HiFT to 24 kHz, voices from the
checkpoint's builtin conditionals or cloned from reference audio through
the voice encoder, CAMPPlus and the S3 tokenizer.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.mel import log_mel, mel_filterbank, mel_spectrogram
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.kernels.stft import spectrogram
from audiolab_tpu_torch.models.campplus import CAMPPlus, campplus_xvector
from audiolab_tpu_torch.models.chatterbox_s3gen import (
    FlowConfig,
    HiFTConfig,
    S3Token2Wav,
    s3gen_ref_mel,
)
from audiolab_tpu_torch.models.chatterbox_t3 import (
    T3,
    T3CkptConfig,
    VoiceEncoder,
    t3_generate,
    utterance_embedding,
)
from audiolab_tpu_torch.models.codecs import DACConfig, DACDecoder
from audiolab_tpu_torch.models.dia import DiaModel, tokenize_dialogue
from audiolab_tpu_torch.models.dia import generate as dia_generate
from audiolab_tpu_torch.models.lm import StageTimer
from audiolab_tpu_torch.models.phonemize import phonemize_ids, phonemize_ipa
from audiolab_tpu_torch.models.s3tokenizer import S3TokenizerV2, tokenize_wav
from audiolab_tpu_torch.models.xtts import (
    XTTS,
    XTTSConfig,
    XttsConditioningEncoder,
    XttsGPT2,
    XttsHifiganDecoder,
    XttsPerceiverResampler,
    XttsSpeakerEncoder,
    speaker_mel,
    xtts_gpt2_generate,
)
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


class DiaTTSEngine:
    """The Dia model and a DAC decoder behind the TTS backend protocol (the
    reference's fourth engine): dialogue text with [S1]/[S2] tags -> audio at
    ``sr``, on one device (default the card; raises without one).

    Before the DAC lookup every code outside the DAC's rows (0 ..
    ``dac.cfg.codebook_size`` - 1) becomes 0, as upstream Dia's
    ``_generate_output`` does.  The JAX engine clips to Dia's
    ``codebook_size - 4`` instead (pipelines/tts.py:217), which is past the
    end of a 1024-row DAC for Dia's 1028-way codebooks: its lookup returns
    NaN there, and in PyTorch it would index out of range (ROADMAP queue
    3)."""

    voices = ["default"]

    def __init__(self, model: DiaModel, dac: DACDecoder, sr: int = 44100,
                 frames_per_word: int = 12, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.dac = dac.to(self.device).eval()
        self.sr = sr
        self.frames_per_word = frames_per_word
        # seconds of the last timed generate's stages (prefill_s, decode_s, dac_s)
        self.last_stats: dict = {}

    def frames(self, text: str, speed: float = 1.0) -> int:
        return max(8, int(len(text.split()) * self.frames_per_word / speed))

    @torch.inference_mode()
    def codes_to_audio(self, codes: torch.Tensor) -> torch.Tensor:
        """(b, n_q, t) codes -> (b, t * hop) audio, out-of-range codes as 0."""
        codes = torch.as_tensor(codes, device=self.device)
        valid = (codes >= 0) & (codes < self.dac.cfg.codebook_size)
        return self.dac(torch.where(valid, codes, 0))

    @torch.inference_mode()
    def generate(self, text: str, voice: str = "default", speed: float = 1.0, seed: int = 0,
                 draws=None, timed: bool = False, **_) -> tuple[np.ndarray, int]:
        """Text -> (waveform, sr).  ``draws`` goes to ``models.dia.generate``;
        ``timed`` synchronises the stages and records their seconds in
        ``last_stats``."""
        ids = tokenize_dialogue(text)[None]
        stats = {} if timed else None
        codes = dia_generate(self.model, ids, max_frames=self.frames(text, speed), seed=seed,
                             draws=draws, stats=stats, device=self.device)
        t0 = time.perf_counter()
        audio = self.codes_to_audio(codes)[0].cpu().numpy()
        if stats is not None:
            stats["dac_s"] = time.perf_counter() - t0
            self.last_stats = stats
        return audio, self.sr


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


# ------------------------------------------------------------ XTTS engines

class XTTSEngine:
    """Coqui-XTTS-class engine ("coqui" in the TTS dispatch): the capability
    ``models.xtts.XTTS`` with voices cloned from reference audio."""

    def __init__(self, model: XTTS):
        self.model = model
        self._voices: dict[str, tuple[np.ndarray, int]] = {}

    @property
    def voices(self):
        return ["default"] + sorted(self._voices)

    def add_voice(self, name: str, wav: np.ndarray, sr: int) -> None:
        """Clone a voice from reference audio."""
        self._voices[name] = (np.asarray(wav, np.float32), sr)

    def _ref(self, voice: str) -> tuple[np.ndarray, int]:
        if voice in self._voices:
            return self._voices[voice]
        # deterministic built-in reference (shaped noise through a comb)
        rng = np.random.default_rng(7)
        x = rng.standard_normal(24000).astype(np.float32) * 0.1
        for d in (89, 131):
            x[d:] += 0.6 * x[:-d]
        return x * 0.2, 24000

    def generate(self, text: str, voice: str = "default", speed: float = 1.0, seed: int = 0,
                 draws=None, **_):
        ref, sr = self._ref(voice)
        n_codes = max(16, int(len(text.split()) * 18 / max(speed, 0.25)))
        return self.model.tts(text, ref, sr, max_codes=min(n_codes, 512), seed=seed,
                              draws=draws)


def random_xtts(seed: int = 0, device: str | torch.device = "cuda") -> XTTSEngine:
    """The JAX server's demo XTTS engine (dim 64, 2 layers, 4 heads, 4
    latents) with random weights by utils/fast_init's rules, on ``device``
    (default the card)."""
    cfg = XTTSConfig(dim=64, n_layers=2, n_heads=4, cond_latents=4, max_seq_len=1024)
    return XTTSEngine(XTTS.random_init(cfg, seed, device=device))


def xtts_cloning_mel(wav22k: torch.Tensor, mel_norms=None) -> torch.Tensor:
    """XTTS-v2's conditioning mel: 22.05 kHz, n_fft 2048, hop 256, win 1024
    Hann, power spectrogram, HTK mel 0..8 kHz x 80, log(clamp 1e-5), divided
    by the checkpoint's mel_stats.  (b, t) -> (b, frames, 80)."""
    spec = spectrogram(wav22k, n_fft=2048, hop=256, win_length=1024, center=True, power=2.0)
    fb = torch.from_numpy(mel_filterbank(22050, 2048, 80, 0.0, 8000.0, htk=True, norm=None))
    mel = torch.log(torch.clamp(spec @ fb.to(spec.device), min=1e-5))
    if mel_norms is not None:
        mel = mel / torch.as_tensor(mel_norms, dtype=mel.dtype, device=mel.device)[None, None]
    return mel


class XttsCheckpointEngine:
    """The XTTS-v2 stack behind one TTS-engine facade (Coqui path): reference
    audio -> per-6 s-chunk perceiver latents (meaned) and the H/ASP
    d-vector; text -> ids -> the cached AR decode -> final-norm latents ->
    the HiFi decoder at 24 kHz.  All modules on one device (default the
    card; raises without one)."""

    sr_out = 24000

    def __init__(self, gpt: XttsGPT2, cond_enc: XttsConditioningEncoder,
                 perceiver: XttsPerceiverResampler, spk_enc: XttsSpeakerEncoder,
                 decoder: XttsHifiganDecoder, mel_norms=None, tokenize=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.gpt, self.cond_enc, self.perceiver, self.spk_enc, self.decoder = (
            m.to(self.device).eval() for m in (gpt, cond_enc, perceiver, spk_enc, decoder))
        self.mel_norms = mel_norms
        # bytes as ids, cut to leave room for the [START]/[STOP] wrap (the JAX
        # engine cuts at max_text - 1, one past the text positions once wrapped)
        self.tokenize = tokenize or (lambda s: np.frombuffer(
            s.encode()[: self.gpt.max_text - 2], np.uint8).astype(np.int64) % self.gpt.n_text)
        self.voices: dict = {}
        # seconds of the last timed synthesize's stages
        self.last_stats: dict = {}

    def _latents(self, piece: np.ndarray) -> torch.Tensor:
        x = torch.as_tensor(piece, dtype=torch.float32, device=self.device)[None]
        return self.perceiver(self.cond_enc(xtts_cloning_mel(x, self.mel_norms)))

    @torch.inference_mode()
    def conditioning(self, ref_wav, sr: int):
        """(perceiver latents (1, L, dim), unit d-vector (1, d)) of a reference."""
        x = np.asarray(ref_wav, np.float32)
        w22 = resample_poly_np(x, sr, 22050) if sr != 22050 else x
        chunk = 22050 * 6
        embs = [self._latents(w22[i:i + chunk]) for i in range(0, len(w22), chunk)
                if len(w22[i:i + chunk]) >= 22050 * 0.33]
        if not embs:
            # shorter than the 0.33 s chunk floor: the clip zero-padded to it
            min_len = int(22050 * 0.33) + 1
            embs.append(self._latents(np.pad(w22, (0, max(0, min_len - len(w22))))))
        lat = torch.stack(embs).mean(dim=0)
        w16 = resample_poly_np(x, sr, 16000) if sr != 16000 else x
        mel = speaker_mel(torch.as_tensor(w16, device=self.device)[None])
        return lat, self.spk_enc(mel, l2_norm=True)

    @torch.inference_mode()
    def synthesize(self, text, ref_wav=None, ref_sr=None, cond=None, d_vector=None,
                   max_steps: int = 200, seed: int = 0, draws=None, timed: bool = False,
                   **kw) -> tuple[np.ndarray, int]:
        """Text -> (waveform, 24000).  ``draws`` goes to ``xtts_gpt2_generate``;
        ``timed`` records the stages' seconds in ``last_stats``."""
        if cond is None:
            cond, d_vector = self.conditioning(ref_wav, ref_sr)
        ids = np.asarray(self.tokenize(text))[None]
        max_steps = min(max_steps, self.gpt.max_mel - 1)
        stats = {} if timed else None
        _, latents, lengths = xtts_gpt2_generate(
            self.gpt, ids, cond, max_steps, seed=seed, draws=draws, stats=stats,
            device=self.device, **kw)
        t0 = time.perf_counter()
        wav = self.decoder(latents, torch.as_tensor(d_vector, device=self.device))
        # trimmed at the first stop: each latent frame vocodes to a fixed
        # number of samples
        n_valid = int(lengths[0])
        if n_valid < max_steps:
            per_frame = wav.shape[-1] // max_steps
            wav = wav[..., : max(per_frame * n_valid, per_frame)]
        out = wav[0].cpu().numpy()
        if stats is not None:
            stats["decoder_s"] = time.perf_counter() - t0
            self.last_stats = stats
        return out, self.sr_out

    # ---- serve/tts_api backend protocol (a voice store)

    def register_voice(self, name: str, wav, sr: int) -> None:
        self.voices[name] = self.conditioning(wav, sr)

    def generate(self, text: str, voice: str = "default", speed: float = 1.0, **_):
        if voice not in self.voices:
            if not self.voices:
                raise ValueError("no voices registered; call register_voice")
            voice = next(iter(self.voices))
        cond, d = self.voices[voice]
        return self.synthesize(text, cond=cond, d_vector=d)


def random_xtts_checkpoint(seed: int = 0,
                           device: str | torch.device = "cuda") -> XttsCheckpointEngine:
    """The JAX package's tiny XttsCheckpointEngine (GPT-2 2 x 32, speaker
    encoder filters 8-64 into 24, HiFi decoder rates 4, 4) with random
    weights by utils/fast_init's rules, on ``device`` (default the card)."""
    dev = resolve_device(device)
    dim, sdim = 32, 24
    with dev:
        mods = [fast_init(m, seed + i) for i, m in enumerate((
            XttsGPT2(layers=2, dim=dim, heads=2, n_text=40, n_audio=30, max_text=32,
                     max_mel=64, start_text=38, stop_text=0),
            XttsConditioningEncoder(dim=dim, heads=4, blocks=2),
            XttsPerceiverResampler(dim=dim, depth=1, num_latents=6, heads=2, dim_head=8),
            XttsSpeakerEncoder(layers=(1, 1, 1, 1), num_filters=(8, 16, 32, 64),
                               proj_dim=sdim),
            XttsHifiganDecoder(input_dim=dim, cond_dim=sdim, upsample_rates=(4, 4),
                               upsample_kernels=(8, 8), resblock_kernels=(3,),
                               resblock_dilations=((1, 3),), initial_channel=32)))]
    return XttsCheckpointEngine(*mods, device=dev)


# ------------------------------------------------------- XTTS tokenizer

_XTTS_EN_ABBREV = [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"),
    ("ft", "fort"),
]
_XTTS_EN_SYMBOLS = [("&", " and "), ("@", " at "), ("%", " percent "),
                    ("#", " hash "), ("$", " dollar "), ("£", " pound "),
                    ("°", " degree ")]
_ONES = ("zero one two three four five six seven eight nine ten eleven "
         "twelve thirteen fourteen fifteen sixteen seventeen eighteen "
         "nineteen").split()
_TENS = "twenty thirty forty fifty sixty seventy eighty ninety".split()


def _int_words(n: int) -> str:
    """English number words (num2words is not in the image)."""
    if n < 0:
        return "minus " + _int_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t = _TENS[n // 10 - 2]
        return t if n % 10 == 0 else f"{t} {_ONES[n % 10]}"
    for div, name in ((10 ** 9, "billion"), (10 ** 6, "million"),
                      (1000, "thousand"), (100, "hundred")):
        if n >= div:
            rest = n % div
            head = f"{_int_words(n // div)} {name}"
            return head if rest == 0 else f"{head} {_int_words(rest)}"
    return str(n)


class BpeTokenizer:
    """The part of a ``tokenizers`` JSON file that XTTS-v2's vocab.json
    uses, in Python: added tokens split out first (longest first), an
    optional ``Whitespace`` pre-tokenizer (``\\w+|[^\\w\\s]+``), BPE by merge
    rank over each word's characters, unknown pieces to ``unk_token``
    (fused when ``fuse_unk``); decode joins the tokens with spaces, as the
    library does without a decoder."""

    def __init__(self, path: str):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"{path}: a {model.get('type')} model, not BPE")
        self.vocab = dict(model["vocab"])
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens") or []}
        self.id_to_token = {i: t for t, i in {**self.vocab, **self.added}.items()}
        self.ranks = {tuple(m.split(" ") if isinstance(m, str) else m): r
                      for r, m in enumerate(model.get("merges") or [])}
        self.unk, self.fuse_unk = model.get("unk_token"), bool(model.get("fuse_unk"))
        pre = spec.get("pre_tokenizer") or {}
        if pre and pre.get("type") != "Whitespace":
            raise ValueError(f"{path}: pre-tokenizer {pre.get('type')} is not supported")
        self.whitespace = bool(pre)
        self._split = (re.compile("|".join(re.escape(t) for t in
                                           sorted(self.added, key=len, reverse=True)))
                       if self.added else None)

    def _bpe(self, word: str) -> list[int]:
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.ranks.get((a, b)), i) for i, (a, b) in
                     enumerate(zip(parts, parts[1:])) if (a, b) in self.ranks]
            if not pairs:
                break
            best = min(pairs)[0]
            merged, i = [], 0
            while i < len(parts):
                if (i + 1 < len(parts) and self.ranks.get((parts[i], parts[i + 1])) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids: list[int] = []
        for p in parts:
            if p in self.vocab:
                ids.append(self.vocab[p])
            elif self.unk is not None and not (self.fuse_unk and ids and ids[-1] == -1):
                ids.append(-1)
        unk = self.vocab.get(self.unk, -1)
        return [unk if i == -1 else i for i in ids]

    def _plain(self, text: str) -> list[int]:
        words = re.findall(r"\w+|[^\w\s]+", text) if self.whitespace else [text]
        return [i for w in words if w for i in self._bpe(w)]

    def encode(self, text: str) -> list[int]:
        if self._split is None:
            return self._plain(text)
        ids, pos = [], 0
        for m in self._split.finditer(text):
            ids += self._plain(text[pos:m.start()])
            ids.append(self.added[m.group()])
            pos = m.end()
        return ids + self._plain(text[pos:])

    def decode(self, ids) -> str:
        return " ".join(self.id_to_token[int(i)] for i in ids)


class XttsTokenizer:
    """XTTS-v2's VoiceBpeTokenizer: ``[lang]`` prefix, spaces to ``[SPACE]``,
    the checkpoint's vocab.json through :class:`BpeTokenizer`.  English text
    is cleaned first (lowercase, quotes dropped, numbers, abbreviations and
    symbols spelled out, whitespace collapsed); other languages pass through
    without number expansion, as in the JAX package."""

    def __init__(self, vocab_file: str):
        self.tokenizer = BpeTokenizer(vocab_file)

    def _clean_en(self, text: str) -> str:
        text = text.replace('"', "").lower()
        text = re.sub(r"\d+", lambda m: _int_words(int(m.group())), text)
        for abbr, full in _XTTS_EN_ABBREV:
            text = re.sub(rf"\b{abbr}\.", full, text)
        for sym, full in _XTTS_EN_SYMBOLS:
            text = text.replace(sym, full)
        return re.sub(r"\s+", " ", text).strip()

    def encode(self, text: str, lang: str = "en") -> list[int]:
        lang = lang.split("-")[0]
        if lang == "en":
            text = self._clean_en(text)
        lang = "zh-cn" if lang == "zh" else lang
        return self.tokenizer.encode(f"[{lang}]{text}".replace(" ", "[SPACE]"))

    def decode(self, ids) -> str:
        txt = self.tokenizer.decode(ids)
        return (txt.replace(" ", "").replace("[SPACE]", " ")
                .replace("[STOP]", "").replace("[UNK]", ""))


# ------------------------------------------- Chatterbox checkpoint engine

def chatterbox_punc_norm(text: str) -> str:
    """The published package's pre-tokenize normalisation (chatterbox tts.py
    punc_norm): capitalise the first letter, collapse whitespace, map exotic
    punctuation to plain ASCII, ensure a terminal period."""
    if not text:
        return "You need to add some text for me to talk."
    text = text[0].upper() + text[1:]
    text = " ".join(text.split())
    for old, new in (("...", ", "), ("…", ", "), (":", ","), (" - ", ", "),
                     (";", ", "), ("—", "-"), ("–", "-"), (" ,", ","),
                     ("“", '"'), ("”", '"'), ("‘", "'"), ("’", "'")):
        text = text.replace(old, new)
    if text[-1] not in {".", "!", "?", "-", ","}:
        text += "."
    return text


class ChatterboxTokenizer:
    """chatterbox EnTokenizer: the HF ``tokenizers`` BPE of the checkpoint's
    tokenizer.json (imported when one is loaded), spaces mapped to [SPACE]."""

    def __init__(self, vocab_file: str):
        from tokenizers import Tokenizer

        self.tokenizer = Tokenizer.from_file(vocab_file)

    def encode(self, text: str) -> list[int]:
        return self.tokenizer.encode(text.replace(" ", "[SPACE]")).ids


class ChatterboxCheckpointEngine:
    """The Chatterbox stack behind one TTS-engine facade: text -> punc_norm
    -> ids -> T3's CFG decode (exaggeration as the emotion input) -> 25 Hz
    speech tokens -> S3Gen's flow and HiFT -> 24 kHz audio, every module on
    one device (default the card; raises without one).

    The voice comes from ``builtin`` (the checkpoint's ``conds.pt``:
    speaker_emb, prompt_tokens, ref_tokens, ref_mel, ref_xvector) or, for
    cloning, from reference audio: the voice encoder's embedding for T3,
    and for S3Gen the CAMPPlus x-vector and the S3 tokenizer's ids (which
    also prompt T3, up to ``speech_cond_prompt_len``) with the 24 kHz
    prompt mel cut to two frames a token.  Without a tokenizer the text's
    UTF-8 bytes are the ids, as in the JAX engine; the ids are cut to the
    text position table's rows (``text_pos_size`` with the start and stop
    tokens)."""

    sr_out = 24000
    voices = ["default"]

    def __init__(self, t3: T3, s3gen: S3Token2Wav, ve: VoiceEncoder | None = None,
                 tokenizer=None, builtin: dict | None = None, campplus: CAMPPlus | None = None,
                 s3tok: S3TokenizerV2 | None = None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.t3 = t3.to(self.device).eval()
        self.s3gen = s3gen.to(self.device).eval()
        self.ve, self.campplus, self.s3tok = (
            None if m is None else m.to(self.device).eval() for m in (ve, campplus, s3tok))
        c = t3.cfg
        self.tokenize = tokenizer or (lambda s: list(
            np.frombuffer(s.encode()[:500], np.uint8).astype(np.int32)
            % (c.text_vocab - 2) + 1))
        self.builtin = builtin or {}
        self.voice_store: dict = {}
        # seconds of the last timed call's stages
        self.last_stats: dict = {}

    def conditioning(self, ref_wav, sr: int, stats: dict | None = None):
        """Reference audio -> (T3 speaker embedding, S3Gen ref dict with
        ref_xvector, ref_tokens and ref_mel as far as the encoders are
        loaded); ``stats`` gets each encoder's seconds."""
        if self.ve is None:
            raise ValueError("no voice encoder loaded; cannot embed reference audio")
        mark = StageTimer(stats, self.device)
        wav = np.asarray(ref_wav, np.float32)
        spk = utterance_embedding(self.ve, wav, sr)
        mark("ve_s")
        rd = {}
        w16 = resample_poly_np(wav, sr, 16000) if sr != 16000 else wav
        if self.campplus is not None:
            rd["ref_xvector"] = campplus_xvector(self.campplus, w16)
            mark("campplus_s")
        if self.s3tok is not None:
            tokens = tokenize_wav(self.s3tok, w16)
            mark("s3tokenizer_s")
            w24 = resample_poly_np(wav, sr, 24000) if sr != 24000 else wav
            with torch.inference_mode():
                mel = s3gen_ref_mel(torch.as_tensor(w24, device=self.device)[None])
            # 80 mels at checkpoint scale; sliced for narrow flows
            mel = mel[..., : self.s3gen.flow_cfg.mel_dim].cpu().numpy()
            # the cosyvoice front end aligns the mel to 2 frames a token
            n_tok = min(tokens.shape[1], mel.shape[1] // 2)
            rd["ref_tokens"] = tokens[:, :n_tok]
            rd["ref_mel"] = mel[:, : 2 * n_tok]
            mark("ref_mel_s")
        return spk, rd

    def synthesize(self, text, ref_wav=None, ref_sr=None, speaker_emb=None, ref_dict=None,
                   exaggeration=0.5, cfg_weight=0.5, temperature=0.8, max_tokens=500, seed=0,
                   draws=None, source_draws=None, timed: bool = False,
                   **_) -> tuple[np.ndarray, int]:
        """Text -> (waveform, 24000).  ``speaker_emb``: a T3 embedding or a
        (embedding, ref dict) pair from :meth:`conditioning`.  ``draws`` goes
        to ``t3_generate``, ``source_draws`` to HiFT; ``timed`` records the
        stages' seconds in ``last_stats``."""
        c = self.t3.cfg
        stats = {} if timed else None
        ref_rd = None
        if speaker_emb is None:
            if ref_wav is not None:
                speaker_emb, ref_rd = self.conditioning(ref_wav, ref_sr, stats)
            elif "speaker_emb" in self.builtin:
                speaker_emb = self.builtin["speaker_emb"]
            else:
                speaker_emb = np.zeros((c.speaker_embed_size,), np.float32)
        elif isinstance(speaker_emb, tuple):
            speaker_emb, ref_rd = speaker_emb
            if ref_rd is not None and not isinstance(ref_rd, dict):
                ref_rd = {"ref_xvector": ref_rd}
        # the text's ids, cut to the rows of the text position table (the JAX
        # engine reads NaN rows past it; ROADMAP queue 3)
        ids = list(self.tokenize(chatterbox_punc_norm(text)))[: c.text_pos_size - 2]
        ids = np.asarray([c.start_text_token] + ids + [c.stop_text_token], np.int64)[None]
        if ref_rd is not None and "ref_tokens" in ref_rd:
            # a cloned voice: the reference's speech tokens prompt T3 too
            prompt = np.asarray(ref_rd["ref_tokens"])[:, : c.speech_cond_prompt_len]
        else:
            prompt = self.builtin.get("prompt_tokens")
        tokens = t3_generate(
            self.t3, ids, speaker_emb, prompt_tokens=prompt, emotion_adv=float(exaggeration),
            max_new_tokens=max_tokens, cfg_weight=float(cfg_weight),
            temperature=float(temperature), seed=seed, draws=draws, stats=stats,
            device=self.device)
        fc = self.s3gen.flow_cfg
        # S3Gen's token vocabulary is the 6561 FSQ codes: the specials go
        tokens = tokens[:, tokens[0] < fc.token_vocab]
        if tokens.shape[1] == 0:
            tokens = np.zeros((1, 1), np.int32)
        rd = ref_dict if ref_dict is not None else ref_rd if ref_rd is not None else self.builtin
        xvec = np.asarray(rd.get("ref_xvector", np.zeros((fc.xvector_dim,), np.float32)),
                          np.float32).reshape(1, -1)
        ref_tokens, ref_mel = rd.get("ref_tokens"), rd.get("ref_mel")
        prompt_mel = None
        if ref_tokens is not None and ref_mel is not None:
            tokens = np.concatenate([np.asarray(ref_tokens, np.int32).reshape(1, -1), tokens],
                                    axis=1)
            prompt_mel = np.asarray(ref_mel, np.float32).reshape(1, -1, fc.mel_dim)
        wav = self.s3gen.tokens_to_wav(tokens, xvec, prompt_mel=prompt_mel, seed=seed,
                                       source_draws=source_draws, stats=stats)
        out = wav[0].cpu().numpy()
        if stats is not None:
            stats["tokens"] = int(tokens.shape[1])
            self.last_stats = stats
        return out, self.sr_out

    # ---- serve/tts_api backend protocol (a voice store)

    def register_voice(self, name: str, wav, sr: int) -> None:
        self.voice_store[name] = self.conditioning(wav, sr)

    def generate(self, text: str, voice: str = "default", speed: float = 1.0, seed: int = 0,
                 exaggeration: float = 0.5, cfg_weight: float = 0.5, **_):
        return self.synthesize(text, speaker_emb=self.voice_store.get(voice),
                               exaggeration=exaggeration, cfg_weight=cfg_weight, seed=seed)


def random_chatterbox(seed: int = 0, device: str | torch.device = "cuda"
                      ) -> ChatterboxCheckpointEngine:
    """The JAX package's tiny Chatterbox engine (T3 2 x 32, flow 32 wide,
    HiFT base 16) with random weights by utils/fast_init's rules, on
    ``device`` (default the card): the same T3 + S3Gen stack the published
    weights fill, at a width the demo backend and the tests run at once."""
    dev = resolve_device(device)
    t3_cfg = T3CkptConfig(text_vocab=40, speech_vocab=36, dim=32, n_layers=2, n_heads=4,
                          ffn_dim=64, max_text_tokens=64, max_speech_tokens=64,
                          speaker_embed_size=8, perceiver_tokens=4, perceiver_heads=2,
                          start_text_token=38, stop_text_token=0, start_speech_token=30,
                          stop_speech_token=31)
    flow_cfg = FlowConfig(token_vocab=30, dim=32, mel_dim=8, xvector_dim=12, heads=2,
                          ffn_dim=64, n_layers=2, n_up_layers=1, est_channels=16,
                          est_mid_blocks=2, est_n_blocks=1, est_heads=2, est_head_dim=4,
                          n_timesteps=2)
    hift_cfg = HiFTConfig(in_channels=8, base_channels=16, f0_cond_channels=12)
    with dev:
        t3 = fast_init(T3(t3_cfg, max_seq_len=256), seed)
        s3gen = fast_init(S3Token2Wav(flow_cfg, hift_cfg), seed + 1)
    return ChatterboxCheckpointEngine(t3, s3gen, device=dev)
