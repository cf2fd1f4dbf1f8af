"""ACE-Step pipelines (counterpart of audiolab_tpu/pipelines/acestep.py):
generate, retake, repaint, edit and extend on the in-repo base model, and
generation with the checkpoint-layout transformer (:class:`CheckpointACEStep`,
``models/acestep_dit.py``) and its UMT5 text encoder
(:class:`ACEStepTextEncoder`).  Every task is the same flow-matching solve
(``models/acestep.py::fm_sample``) with its own starting latents, repaint
mask or velocity functions; the base model's latents go through the DCAE
decoder to a mel and through Vocos to audio, the checkpoint model's through
``decode_fn`` (``models/music_dcae.py::MusicDCAE.decode``).

The pipeline runs on its ``device`` (the card unless the caller asks for
the CPU).  Its draws come from ``draws`` (``models/acestep.py::Draws``;
the tests pass one that gives JAX's): the starting latents from
``normal(seed)``, retake's re-noising from ``normal(seed + 1)``, repaint's
per-step noise from ``steps(seed)``, as the JAX pipeline keys them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram
from audiolab_tpu_torch.models.acestep import (
    ACEStepConfig,
    ACEStepModel,
    DCAEConfig,
    Draws,
    acestep_sigmas,
    fm_sample,
    lora_weights,
    tokenize_lyrics,
)
from audiolab_tpu_torch.models.acestep_dit import (
    ACEStepDiT,
    ACEStepDiTConfig,
    LyricConformerEncoder,
)
from audiolab_tpu_torch.models.codecs import Vocos, VocosConfig
from audiolab_tpu_torch.models.dit import DiTConfig
from audiolab_tpu_torch.models.stable_audio import tokenize_prompt
from audiolab_tpu_torch.models.t5 import T5Encoder
from audiolab_tpu_torch.utils.fast_init import fast_init
from audiolab_tpu_torch.utils.spm import SentencePieceProcessor


@dataclass
class ACEStepPipelineConfig:
    """The sampler's settings.  The checkpoint sampler's knobs (shift, omega,
    the guidance interval and its decay, ERG) are read by
    :class:`CheckpointACEStep` only; the base pipeline leaves them off."""
    steps: int = 27
    scheduler: str = "euler"
    guidance_scale: float = 7.5
    use_apg: bool = True
    shift: float | None = None            # 3.0 for the published sampler
    omega_scale: float | None = None      # 10.0 upstream
    guidance_interval: float = 1.0        # 0.5 upstream
    guidance_interval_decay: float = 0.0
    min_guidance_scale: float = 3.0
    use_erg_tag: bool = True
    use_erg_lyric: bool = True
    use_erg_diffusion: bool = True


def checkpoint_pcfg() -> ACEStepPipelineConfig:
    """The published ``ACEStepPipeline.__call__`` defaults
    (pipeline_ace_step.py:1425-1442): 60 steps, Euler with shift 3, APG
    15.0, omega 10, guidance on the middle half of the schedule, ERG on."""
    return ACEStepPipelineConfig(steps=60, scheduler="euler", guidance_scale=15.0,
                                 use_apg=True, shift=3.0, omega_scale=10.0,
                                 guidance_interval=0.5)


class ACEStepPipeline:
    """An :class:`ACEStepModel` and its Vocos on ``device``; ``lora`` (paths
    relative to the DiT, as ``lora_init``, ``train_lora`` and ``load_lora``
    give them) is merged into the DiT's weights.  The JAX pipeline merges
    such factors into its whole tree, where the paths do not exist, and
    raises (ROADMAP queue 3)."""

    def __init__(self, model: ACEStepModel, vocos: Vocos,
                 pcfg: ACEStepPipelineConfig | None = None, lora: dict | None = None,
                 lora_alpha: float = 1.0, device: str | torch.device = "cuda",
                 draws: Draws | None = None):
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.model = model.to(self.device).eval()
        if lora:
            self.model.dit.load_state_dict(lora_weights(self.model.dit, lora, lora_alpha))
        self.vocos = vocos.to(self.device).eval()
        self.pcfg = pcfg or ACEStepPipelineConfig()
        self.draws = draws or Draws(self.device)

    # -------------------------------------------------- internals

    def _context2(self, prompt: str, lyrics: str, b: int = 1) -> torch.Tensor:
        tag = torch.from_numpy(np.stack([tokenize_prompt(prompt, 64)] * b)).to(self.device)
        lyr = torch.from_numpy(np.stack([tokenize_lyrics(lyrics, 128)] * b)).to(self.device)
        ctx_c = self.model.encode_cond(tag, lyr)
        ctx_u = self.model.encode_cond(torch.zeros_like(tag), torch.zeros_like(lyr))
        return torch.cat([ctx_c, ctx_u])

    def _latents_of_audio(self, audio: np.ndarray) -> torch.Tensor:
        c = self.cfg
        x = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)[None]
        mel = log_mel(mel_spectrogram(x, sr=c.sr, n_fft=2048, hop=c.mel_hop,
                                      n_mels=c.dcae.n_mels, power=1.0, center=True))
        frames = (mel.shape[1] // c.dcae.hop) * c.dcae.hop
        return self.model.encode_mel(mel[:, :frames])

    def _decode(self, z: torch.Tensor) -> np.ndarray:
        return self.vocos(self.model.decode_latent(z))[0].cpu().numpy()

    def _frames(self, seconds: float) -> int:
        return max(1, int(round(seconds * self.cfg.latent_rate)))

    def _solve(self, ctx2, t_latent: int, seed: int, **kw) -> torch.Tensor:
        p = self.pcfg
        kw.setdefault("steps", p.steps)
        kw.setdefault("guidance_scale", p.guidance_scale)
        return fm_sample(self.model, ctx2, t_latent, use_apg=p.use_apg, seed=seed,
                         draws=self.draws, **kw)

    # -------------------------------------------------- tasks

    @torch.inference_mode()
    def generate(self, prompt: str, lyrics: str = "", duration: float = 30.0, seed: int = 0,
                 infer_step: int | None = None, guidance_scale: float | None = None,
                 scheduler_type: str | None = None, **kw) -> tuple[np.ndarray, int]:
        """Text (and lyrics) to music; ``infer_step``, ``guidance_scale`` and
        ``scheduler_type`` override the pipeline's settings for the call."""
        p = self.pcfg
        z = self._solve(self._context2(prompt, lyrics), self._frames(duration), seed,
                        steps=int(infer_step or p.steps),
                        scheduler=scheduler_type or p.scheduler,
                        guidance_scale=(p.guidance_scale if guidance_scale is None
                                        else float(guidance_scale)))
        return self._decode(z), self.cfg.sr

    @torch.inference_mode()
    def retake(self, audio: np.ndarray, prompt: str, lyrics: str = "", variance: float = 0.5,
               seed: int = 0) -> tuple[np.ndarray, int]:
        """Re-noise the clip's latents to ``variance`` and solve again."""
        z0 = self._latents_of_audio(audio)
        t0 = float(np.clip(variance, 0.05, 1.0))
        eps = self.draws.normal(seed + 1, tuple(z0.shape)).to(z0.dtype)
        z_init = (1.0 - t0) * z0 + t0 * eps
        z = self._solve(self._context2(prompt, lyrics), z0.shape[1], seed, z_init=z_init,
                        t_start=t0)
        return self._decode(z), self.cfg.sr

    @torch.inference_mode()
    def repaint(self, audio: np.ndarray, prompt: str, start_s: float, end_s: float,
                lyrics: str = "", seed: int = 0) -> tuple[np.ndarray, int]:
        """Regenerate [start_s, end_s] only; outside it the clip's latents are
        kept at every step's noise level."""
        z0 = self._latents_of_audio(audio)
        t = z0.shape[1]
        f0, f1 = self._frames(start_s), min(t, self._frames(end_s))
        mask = torch.zeros((1, t, 1), device=self.device)
        mask[:, f0:f1] = 1.0
        z = self._solve(self._context2(prompt, lyrics), t, seed, repaint_mask=mask, z_ref=z0)
        return self._decode(z), self.cfg.sr

    def edit(self, audio: np.ndarray, prompt: str, lyrics: str = "", strength: float = 0.7,
             seed: int = 0) -> tuple[np.ndarray, int]:
        """A whole-track edit: a retake at ``strength`` under the new prompt."""
        return self.retake(audio, prompt, lyrics, variance=strength, seed=seed)

    @torch.inference_mode()
    def extend(self, audio: np.ndarray, prompt: str, left_s: float = 0.0, right_s: float = 10.0,
               lyrics: str = "", seed: int = 0) -> tuple[np.ndarray, int]:
        """Pad the latents by ``left_s`` and ``right_s`` and repaint the pads."""
        z0 = self._latents_of_audio(audio)
        lf = self._frames(left_s) if left_s > 0 else 0
        rf = self._frames(right_s) if right_s > 0 else 0
        t_new = z0.shape[1] + lf + rf
        z_ref = torch.nn.functional.pad(z0, (0, 0, lf, rf))
        mask = torch.ones((1, t_new, 1), device=self.device)
        mask[:, lf: lf + z0.shape[1]] = 0.0
        z = self._solve(self._context2(prompt, lyrics), t_new, seed, repaint_mask=mask,
                        z_ref=z_ref)
        return self._decode(z), self.cfg.sr

    def __call__(self, prompt: str, **kw):
        return self.generate(prompt, **kw)


def random_acestep(cfg: ACEStepConfig | None = None, seed: int = 0,
                   vocos_cfg: VocosConfig | None = None,
                   device: str | torch.device = "cuda") -> ACEStepPipeline:
    """Random-weight pipeline on ``device`` (weights by utils/fast_init's
    rules from ``seed``); without ``cfg`` the JAX package's demo widths, and
    a Vocos of n_fft 4 * mel_hop over the DCAE's mels."""
    dev = resolve_device(device)
    cfg = cfg or ACEStepConfig(
        sr=8000, mel_hop=256,
        dcae=DCAEConfig(n_mels=32, latent_dim=4, base_ch=8, ratios=(2, 2)),
        dit=DiTConfig(dim=32, n_layers=2, n_heads=4, cond_dim=32, in_dim=4, out_dim=4,
                      dtype="float32"),
        text_dim=32, text_layers=1, lyric_vocab=300)
    vcfg = vocos_cfg or VocosConfig(dim=32, n_layers=1, n_fft=4 * cfg.mel_hop, hop=cfg.mel_hop)
    with dev:
        model = fast_init(ACEStepModel(cfg), seed)
        vocos = fast_init(Vocos(vcfg, in_dim=cfg.dcae.n_mels), seed + 1)
    return ACEStepPipeline(model, vocos, device=dev)


# ---------------------------------------------------- the checkpoint model

class CheckpointACEStep:
    """Generation with the checkpoint-layout transformer through the same
    flow-matching solve: latents (b, 8, 16, t) are the sampler's (b, t,
    128).  Conditioning as upstream's pipeline_ace_step.py:562-765: 768-d
    text states (UMT5), a 512-d speaker embedding, and lyric tokens through
    the conformer.  ``generate`` returns latents, or ``decode_fn(latents)``
    when one is given (``MusicDCAE.decode``).  The starting latents are
    ``draws.normal(seed, (b, t, c * 16))``."""

    def __init__(self, model: ACEStepDiT, lyric_enc: LyricConformerEncoder | None = None,
                 pcfg: ACEStepPipelineConfig | None = None, decode_fn=None,
                 latent_rate: float = 44100 / 512 / 8, text_encoder=None,
                 device: str | torch.device = "cuda", draws: Draws | None = None):
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.model = model.to(self.device).eval()
        self.lyric_enc = None if lyric_enc is None else lyric_enc.to(self.device).eval()
        self.pcfg = pcfg or checkpoint_pcfg()
        self.decode_fn = decode_fn
        self.latent_rate = latent_rate
        self.text_encoder = text_encoder
        self.draws = draws or Draws(self.device)

    def text_embeddings(self, texts: list[str], max_length: int = 256):
        """Prompts -> (hidden, mask) through ``text_encoder``."""
        if self.text_encoder is None:
            raise NotImplementedError("umt5 text encoder not loaded; pass text_encoder=")
        return self.text_encoder(texts, max_length)

    @torch.inference_mode()
    def encode_cond(self, text_hidden, text_mask, speaker, lyric_tokens=None, lyric_mask=None,
                    lyric_q_tau: float = 1.0):
        """(conditioning, mask); ``lyric_q_tau`` 0.01 is ERG-lyric: the real
        lyric tokens through the conformer with ``linear_q`` of blocks 4 and
        5 scaled."""
        lyric_hidden = None
        if lyric_tokens is not None and self.lyric_enc is not None:
            emb = self.model.embed_lyrics(lyric_tokens)
            lyric_hidden = self.lyric_enc(emb, lyric_mask, q_tau=lyric_q_tau,
                                          q_tau_layers=(4, 5) if lyric_q_tau != 1.0 else ())
        return self.model.encode(text_hidden, text_mask, speaker, lyric_hidden, lyric_mask)

    def _velocity(self, enc, enc_mask, q_tau: float = 1.0, q_tau_blocks: tuple = ()):
        """The velocity of one conditioning stream on the sampler's layout;
        ``q_tau``/``q_tau_blocks`` are ERG-diffusion for the unconditional one."""
        c = self.cfg

        def fn(zb, tb):
            b, t, _ = zb.shape
            lat = zb.reshape(b, t, c.in_channels, c.patch_height).permute(0, 2, 3, 1)
            v = self.model.decode(lat, torch.ones((b, t), device=zb.device), enc, enc_mask, tb,
                                  q_tau=q_tau, q_tau_blocks=q_tau_blocks)
            return v.permute(0, 3, 1, 2).reshape(b, t, -1)

        return fn

    @torch.inference_mode()
    def generate(self, text_hidden, text_mask, speaker, lyric_tokens=None, lyric_mask=None,
                 duration: float = 30.0, seed: int = 0, text_hidden_null=None, **kw):
        """Latents (b, 8, 16, t), or ``decode_fn`` of them.  The published
        text2music loop (pipeline_ace_step.py:848-1330): shift-3 sigmas with
        the DiT fed sigma * 1000, omega's mean-shifted Euler steps, APG per
        latent channel, guidance on the middle ``guidance_interval`` of the
        steps, and ERG for the unconditional forward.  ``text_hidden_null``
        is ERG-tag's null text (``ACEStepTextEncoder.null_embeddings``);
        zeros without it."""
        c, p = self.cfg, self.pcfg
        dev = self.device
        text_hidden, text_mask, speaker = (x.to(dev) for x in (text_hidden, text_mask, speaker))
        if lyric_tokens is not None:
            lyric_tokens, lyric_mask = lyric_tokens.to(dev), lyric_mask.to(dev)
        enc_c, m_c = self.encode_cond(text_hidden, text_mask, speaker, lyric_tokens, lyric_mask)
        t_null = (text_hidden_null.to(dev) if text_hidden_null is not None and p.use_erg_tag
                  else torch.zeros_like(text_hidden))
        if p.use_erg_lyric and lyric_tokens is not None:
            enc_u, m_u = self.encode_cond(t_null, text_mask, torch.zeros_like(speaker),
                                          lyric_tokens, lyric_mask, lyric_q_tau=0.01)
        else:
            enc_u, m_u = self.encode_cond(
                t_null, text_mask, torch.zeros_like(speaker),
                None if lyric_tokens is None else torch.zeros_like(lyric_tokens), lyric_mask)
        b = text_hidden.shape[0]
        frames = max(1, int(round(duration * self.latent_rate)))
        z0 = self.draws.normal(seed, (b, frames, c.in_channels * c.patch_height))
        erg = p.use_erg_diffusion
        z = fm_sample(
            None, torch.cat([enc_c, enc_u]), frames, steps=p.steps, scheduler=p.scheduler,
            guidance_scale=p.guidance_scale, use_apg=p.use_apg, z_init=z0,
            sigmas=acestep_sigmas(p.steps, p.shift) if p.shift else None, timestep_scale=1000.0,
            omega_scale=p.omega_scale, guidance_interval=p.guidance_interval,
            guidance_interval_decay=p.guidance_interval_decay,
            min_guidance_scale=p.min_guidance_scale,
            velocity_cond_fn=self._velocity(enc_c, m_c),
            velocity_uncond_fn=self._velocity(enc_u, m_u, q_tau=0.01 if erg else 1.0,
                                              q_tau_blocks=tuple(range(15, 20)) if erg else ()),
            apg_channels=c.in_channels, seed=seed, draws=self.draws, **kw)
        lat = z.reshape(b, frames, c.in_channels, c.patch_height).permute(0, 2, 3, 1)
        return self.decode_fn(lat) if self.decode_fn is not None else lat


def random_checkpoint_acestep(seed: int = 0, device: str | torch.device = "cuda"
                              ) -> CheckpointACEStep:
    """A tiny random-weight :class:`CheckpointACEStep` on ``device`` (the JAX
    package's widths, weights by utils/fast_init's rules from ``seed``)."""
    dev = resolve_device(device)
    cfg = ACEStepDiTConfig(
        num_layers=2, num_attention_heads=2, attention_head_dim=8, in_channels=2,
        out_channels=2, patch_height=4, speaker_embedding_dim=8, text_embedding_dim=8,
        lyric_vocab_size=32, lyric_hidden_size=16, ssl_latent_dims=(8,), ssl_encoder_depths=(0,))
    with dev:
        model = fast_init(ACEStepDiT(cfg), seed)
        lyr = fast_init(LyricConformerEncoder(dim=16, heads=2, ffn_dim=32, num_blocks=1), seed + 2)
    return CheckpointACEStep(model, lyr, latent_rate=2.0, device=dev)


class ACEStepTextEncoder:
    """UMT5 (``models/t5.py::T5Encoder`` at ``umt5_base()``) and its
    SentencePiece tokenizer (``utils/spm.py``): prompts -> (hidden, mask),
    upstream's get_text_embeddings (pipeline_ace_step.py:327-342).  Each
    prompt is cut to ``max_length - 1`` pieces and ends with EOS; rows are
    zero-padded to the longest."""

    def __init__(self, t5: T5Encoder, spm_model_path: str,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = t5.to(self.device).eval()
        self.sp = SentencePieceProcessor(spm_model_path)
        self._eos = self.sp.eos_id() if self.sp.eos_id() >= 0 else 1

    def _tokenize(self, texts: list[str], max_length: int):
        enc = [self.sp.encode_as_ids(t)[: max_length - 1] + [self._eos] for t in texts]
        n = max(len(e) for e in enc)
        ids = np.zeros((len(texts), n), np.int64)
        mask = np.zeros((len(texts), n), np.int64)
        for r, e in enumerate(enc):
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1
        return (torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(self.device))

    @torch.inference_mode()
    def __call__(self, texts: list[str], max_length: int = 256):
        ids, mask = self._tokenize(texts, max_length)
        return self.model(ids, mask), mask

    @torch.inference_mode()
    def null_embeddings(self, texts: list[str], max_length: int = 256, tau: float = 0.01):
        """ERG-tag's null text states (get_text_embeddings_null: the
        SelfAttention q scaled by ``tau`` on encoder blocks 8 and 9)."""
        ids, mask = self._tokenize(texts, max_length)
        return self.model(ids, mask, q_tau=tau, q_tau_layers=(8, 9))
