"""Music generation pipelines behind the music API's backend protocol
(counterpart of audiolab_tpu/pipelines/music.py): ``.generate(prompt,
**settings) -> (samples (n,) or (channels, n), sr)``.

- :class:`StableAudioPipeline`: the in-repo Stable Audio model with
  ``generate``, ``variations`` and ``continue_audio``.
- :class:`StableAudioCheckpointPipeline`: stable-audio-open-1.0's
  structure (the SAO DiT, T5, the seconds embedders, the checkpoint Oobleck
  decoder) with the published sampler, DPM++ 3M SDE over polyexponential
  sigmas, and v-DDIM as the deterministic option.  It rejects
  ``init_audio``, as the JAX pipeline does.
- :class:`T5PromptTokenizer`: T5Conditioner's tokenization through the
  port's SentencePiece reader (``utils/spm.py``).

Every pipeline runs on its ``device`` (the card unless the caller asks for
the CPU); the starting latents and the SDE noise are drawn before the loop
from generators seeded with ``seed``, or passed in.
"""

from __future__ import annotations

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.models.ksampler import (
    linspace_f32,
    sample_dpmpp_3m_sde,
    sigmas_polyexponential,
    v_denoiser,
)
from audiolab_tpu_torch.models.stable_audio import (
    NumberEmbedder,
    OobleckConfig,
    StableAudioConfig,
    StableAudioModel,
    generate_audio,
    latent_frames,
    v_to_eps_x0,
)
from audiolab_tpu_torch.models.stable_audio_dit import OobleckConfig as CkptOobleckConfig
from audiolab_tpu_torch.models.stable_audio_dit import (
    OobleckDecoder,
    SAODiTConfig,
    StableAudioDiT,
)
from audiolab_tpu_torch.models.t5 import T5Config, T5Encoder
from audiolab_tpu_torch.utils.fast_init import fast_init


def _channels_first(audio: np.ndarray) -> np.ndarray:
    """(n, channels) -> (channels, n), a single channel as (n,)."""
    samples = np.asarray(audio).T
    return samples[0] if samples.shape[0] == 1 else samples


class StableAudioPipeline:
    """A :class:`StableAudioModel` on ``device`` behind the backend protocol."""

    def __init__(self, model: StableAudioModel, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg

    def generate(self, prompt: str, negative_prompt: str = "", seconds_total: float = 10.0,
                 seconds_start: float = 0.0, steps: int = 50, cfg_scale: float = 7.0,
                 seed: int = 0, init_audio=None, init_strength: float = 0.8, z=None, **_):
        out = generate_audio(
            self.model, prompt, negative_prompt=negative_prompt,
            seconds_total=seconds_total, seconds_start=seconds_start, steps=steps,
            cfg_scale=cfg_scale, seed=seed, init_audio=init_audio,
            init_strength=init_strength, z=z, device=self.device)
        return _channels_first(out[0]), self.cfg.sr

    def variations(self, audio: np.ndarray, prompt: str, strength: float = 0.6, **kw):
        """An img2img variation of ``audio`` (n,) or (n, channels)."""
        a = np.asarray(audio, np.float32)
        if a.ndim == 1:
            a = a[:, None]
        return self.generate(prompt, init_audio=a[None], init_strength=strength,
                             seconds_total=a.shape[0] / self.cfg.sr, **kw)

    def continue_audio(self, audio: np.ndarray, prompt: str, seconds_total: float = 10.0,
                       **kw):
        """``audio`` (n,), (channels, n) or (n, channels) followed by a new
        generation, joined with a 0.25 s linear crossfade, mono."""
        y, sr = self.generate(prompt, seconds_total=seconds_total, **kw)
        a = np.asarray(audio, np.float32)
        if a.ndim == 2:
            a = a.mean(axis=0) if a.shape[0] < a.shape[1] else a.mean(axis=1)
        fade = min(len(a), len(y), int(0.25 * sr))
        ramp = np.linspace(0.0, 1.0, fade, dtype=np.float32)
        if y.ndim == 2:
            y = y.mean(axis=0)
        joined = np.concatenate([a[: len(a) - fade],
                                 a[len(a) - fade:] * (1 - ramp) + y[:fade] * ramp, y[fade:]])
        return joined, sr


class T5PromptTokenizer:
    """T5Conditioner tokenization: SentencePiece ids cut to max_length - 1,
    ``</s>`` appended, padded with the pad id (0 when the model has none),
    and the mask of the real ids."""

    def __init__(self, spm_model_path: str, max_length: int = 128):
        from audiolab_tpu_torch.utils.spm import SentencePieceProcessor

        self.sp = SentencePieceProcessor(spm_model_path)
        self.max_length = max_length
        self.eos = self.sp.eos_id() if self.sp.eos_id() >= 0 else 1
        self.pad = max(self.sp.pad_id(), 0)

    def __call__(self, texts: list[str]):
        """-> (ids (b, max_length) int32, mask (b, max_length) int32)."""
        n = self.max_length
        ids = np.full((len(texts), n), self.pad, np.int32)
        mask = np.zeros((len(texts), n), np.int32)
        for r, t in enumerate(texts):
            e = self.sp.encode_as_ids(t)[: n - 1] + [self.eos]
            ids[r, : len(e)] = e
            mask[r, : len(e)] = 1
        return ids, mask


class StableAudioCheckpointPipeline:
    """stable-audio-open-1.0 end to end.  The cross-attention input is
    [T5(prompt), emb(seconds_start), emb(seconds_total)] (the T5 pad rows
    zeroed by the mask and attended to, as upstream's disabled cross mask
    does), the global conditioning concat(the two seconds embeddings).
    CFG's unconditional row is the zeroed cross sequence, or a negative
    prompt's, with the global embedding on both rows."""

    def __init__(self, dit: StableAudioDiT, decoder: OobleckDecoder, t5: T5Encoder,
                 seconds_start: NumberEmbedder, seconds_total: NumberEmbedder,
                 spm_model_path: str, sr: int = 44100, seconds_clamp: float = 512.0,
                 max_seconds: float = 47.0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.dit, self.decoder, self.t5 = (m.to(self.device).eval() for m in (dit, decoder, t5))
        self.ss = seconds_start.to(self.device).eval()
        self.st = seconds_total.to(self.device).eval()
        self.dit_cfg, self.vae_cfg, self.t5_cfg = dit.cfg, decoder.cfg, t5.cfg
        self.sr = sr
        self.seconds_clamp = seconds_clamp
        self.max_seconds = max_seconds
        self.tokenizer = T5PromptTokenizer(spm_model_path)

    def conditioning(self, prompts: list[str], seconds_start: float, seconds_total: float):
        """-> (cross tokens (b, 130, 768), global conditioning (b, 1536))."""
        ids, mask = self.tokenizer(prompts)
        text = self.t5(torch.from_numpy(ids).to(self.device),
                       torch.from_numpy(mask).to(self.device))
        b = len(prompts)

        def norm(v):
            return torch.full((b,), float(np.clip(v, 0.0, self.seconds_clamp))
                              / self.seconds_clamp, device=self.device)

        ss, st = self.ss(norm(seconds_start)), self.st(norm(seconds_total))
        return (torch.cat([text, ss[:, None, :], st[:, None, :]], dim=1),
                torch.cat([ss, st], dim=-1))

    def latent_frames(self, seconds_total: float) -> int:
        return latent_frames(float(np.clip(seconds_total, 1.0, self.max_seconds)), self.sr,
                             int(np.prod(self.vae_cfg.strides)))

    @torch.inference_mode()
    def generate(self, prompt: str, negative_prompt: str = "", seconds_total: float = 10.0,
                 seconds_start: float = 0.0, steps: int = 100, cfg_scale: float = 7.0,
                 seed: int = 0, init_audio=None, init_strength: float = 0.8,
                 sampler_type: str = "dpmpp-3m-sde", sigma_min: float = 0.3,
                 sigma_max: float = 500.0, noise=None, sde_draws=None, **_):
        """The published sampler (``sampler_type="dpmpp-3m-sde"``: sigmas
        0.3-500, rho 1, k-diffusion's VDenoiser) or the cosine v-DDIM
        (``"v-ddim"``).  ``noise``: the starting latents (1, t_lat, 64) before
        the sigma scaling, else standard normals from a generator seeded with
        ``seed``; ``sde_draws``: the SDE's (steps, 1, t_lat, 64), else drawn
        from a generator seeded with ``seed + 1``."""
        seconds_total = float(np.clip(seconds_total, 1.0, self.max_seconds))
        t_lat = self.latent_frames(seconds_total)
        cross_c, glob = self.conditioning([prompt], seconds_start, seconds_total)
        if negative_prompt and negative_prompt.strip():
            cross_u, _ = self.conditioning([negative_prompt], seconds_start, seconds_total)
        else:
            cross_u = torch.zeros_like(cross_c)
        cross2, glob2 = torch.cat([cross_c, cross_u]), torch.cat([glob, glob])
        shape = (1, t_lat, self.vae_cfg.latent_dim)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise = torch.randn(shape, generator=gen, device=self.device)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=self.device)
        if tuple(noise.shape) != shape:
            raise ValueError(f"noise {tuple(noise.shape)}, expected {shape}")
        if init_audio is not None:
            raise NotImplementedError("init audio needs the Oobleck encoder")

        def v_guided(x, t: float):
            v = self.dit(torch.cat([x, x]), torch.full((2,), t, device=self.device),
                         cross2, glob2)
            vc, vu = v[:1], v[1:]
            return vu + cfg_scale * (vc - vu)

        if sampler_type == "dpmpp-3m-sde":
            sig = sigmas_polyexponential(steps, sigma_min, sigma_max)
            if sde_draws is not None:
                sde_draws = torch.as_tensor(sde_draws, dtype=torch.float32, device=self.device)
            z = sample_dpmpp_3m_sde(v_denoiser(v_guided), noise * float(sig[0]), sig, eta=1.0,
                                    draws=sde_draws, seed=seed + 1)
        else:
            ts = torch.from_numpy(linspace_f32(1.0, 0.0, steps + 1)).to(self.device)
            z = noise
            for i in range(steps):
                t_cur, t_next = ts[i], ts[i + 1]
                eps, x0 = v_to_eps_x0(v_guided(z, float(t_cur)), z, t_cur.expand(1))
                z = torch.cos(t_next * np.pi / 2) * x0 + torch.sin(t_next * np.pi / 2) * eps
        samples = self.decoder(z)[0].cpu().numpy()          # (out_ch, n)
        return (samples[0] if samples.shape[0] == 1 else samples), self.sr


def random_stable_audio(cfg: StableAudioConfig | None = None, seed: int = 0,
                        device: str | torch.device = "cuda") -> StableAudioPipeline:
    """Random-weight pipeline on ``device`` (weights by utils/fast_init's
    rules from ``seed``); without ``cfg`` the JAX package's demo widths."""
    from audiolab_tpu_torch.models.dit import DiTConfig

    dev = resolve_device(device)
    cfg = cfg or StableAudioConfig(
        sr=16000, max_seconds=10.0,
        vae=OobleckConfig(channels=1, latent_dim=16, base_ch=16, ratios=(4, 4, 4)),
        dit=DiTConfig(dim=64, n_layers=2, n_heads=4, cond_dim=64, in_dim=16, out_dim=16,
                      dtype="float32"),
        text_dim=64, text_layers=1)
    with dev:
        model = fast_init(StableAudioModel(cfg), seed)
    return StableAudioPipeline(model, device=dev)


def random_stable_audio_checkpoint(spm_model_path: str, dit_cfg: SAODiTConfig | None = None,
                                   vae_cfg: CkptOobleckConfig | None = None,
                                   t5_cfg: T5Config | None = None, seed: int = 0,
                                   device: str | torch.device = "cuda"
                                   ) -> StableAudioCheckpointPipeline:
    """A :class:`StableAudioCheckpointPipeline` with random weights (utils/
    fast_init's rules from ``seed``) at the given configurations, by
    default stable-audio-open-1.0's and T5-base's."""
    dev = resolve_device(device)
    t5_cfg = t5_cfg or T5Config()
    with dev:
        dit = fast_init(StableAudioDiT(dit_cfg or SAODiTConfig()), seed)
        dec = fast_init(OobleckDecoder(vae_cfg or CkptOobleckConfig()), seed + 1)
        t5 = fast_init(T5Encoder(t5_cfg), seed + 2)
        ss = fast_init(NumberEmbedder(features=t5_cfg.dim), seed + 3)
        st = fast_init(NumberEmbedder(features=t5_cfg.dim), seed + 4)
    return StableAudioCheckpointPipeline(dit, dec, t5, ss, st, spm_model_path, device=dev)
