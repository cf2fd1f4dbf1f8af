"""ACE-Step pipeline: generate, retake, repaint, edit and extend on the
in-repo base model (counterpart of audiolab_tpu/pipelines/acestep.py).
Every task is the same flow-matching solve (``models/acestep.py::
fm_sample``) with its own starting latents or repaint mask; the latents go
through the DCAE decoder to a mel and through Vocos to audio.

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
    fm_sample,
    lora_apply,
    tokenize_lyrics,
)
from audiolab_tpu_torch.models.codecs import Vocos, VocosConfig
from audiolab_tpu_torch.models.dit import DiTConfig
from audiolab_tpu_torch.models.stable_audio import tokenize_prompt
from audiolab_tpu_torch.utils.fast_init import fast_init


@dataclass
class ACEStepPipelineConfig:
    """The base pipeline's sampler settings.  The checkpoint sampler's knobs
    (shift, omega, the guidance interval, ERG) and ``checkpoint_pcfg`` come
    with the checkpoint pipeline that reads them."""
    steps: int = 27
    scheduler: str = "euler"
    guidance_scale: float = 7.5
    use_apg: bool = True


class ACEStepPipeline:
    """An :class:`ACEStepModel` and its Vocos on ``device``; ``lora`` (see
    ``lora_apply``) is merged into the model's weights."""

    def __init__(self, model: ACEStepModel, vocos: Vocos,
                 pcfg: ACEStepPipelineConfig | None = None, lora: dict | None = None,
                 lora_alpha: float = 1.0, device: str | torch.device = "cuda",
                 draws: Draws | None = None):
        self.device = resolve_device(device)
        self.cfg = model.cfg
        self.model = model.to(self.device).eval()
        if lora:
            self.model.load_state_dict(lora_apply(self.model.state_dict(), lora, lora_alpha))
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
