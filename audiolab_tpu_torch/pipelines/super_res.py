"""Audio super-resolution pipeline (counterpart of
audiolab_tpu/pipelines/super_res.py:1-120; reference: wrappers/super_res.py).

Reference behaviors reproduced:
  - 10.24 s chunks with overlap + crossfade            (:42-50, 264-295)
  - Butterworth crossover splice: keep the original's lows, take the
    enhancer's highs above the crossover                (:222-320)
  - loudness match to the input (pyloudnorm role)       (:300-320)
  - output at 48 kHz

The enhancer slot is pluggable: a neural enhancer is called on the
``(count, ch, n)`` chunk tensor on the device; the built-in default is a
DSP band-replicator (:func:`sbr_enhance`).  The resample, the chunking and
the enhancer run on ``device``; the crossover (scipy ``filtfilt``) and the
loudness match are host numpy.  The learned enhancers are a trained WaveGrad
(:func:`make_wavegrad_enhancer`, train/super_res.py) and the AudioSR stack
(:class:`AudioSRCheckpointPipeline`), both fp32 with TF32 off on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps

from audiolab_tpu_torch.core.chunking import extract_chunks, plan_chunks, stitch_chunks
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.dsp.loudness import integrated_loudness
from audiolab_tpu_torch.kernels.mel import mel_spectrogram
from audiolab_tpu_torch.kernels.resample import resample
from audiolab_tpu_torch.kernels.stft import istft, stft


def sbr_enhance(chunk48: torch.Tensor) -> torch.Tensor:
    """Default DSP enhancer: spectral band replication above the source
    band — copies 4-12 kHz content up an octave with -12 dB tilt."""
    n_fft, hop = 2048, 512
    real, imag = stft(chunk48, n_fft=n_fft, hop=hop)
    n_bins = n_fft // 2 + 1
    half = n_bins // 2
    # shift low half up one octave (bin doubling approximation)
    rep_r = torch.zeros_like(real)
    rep_i = torch.zeros_like(imag)
    rep_r[..., half: 2 * half] = real[..., :half] * 0.25
    rep_i[..., half: 2 * half] = imag[..., :half] * 0.25
    return istft(real + rep_r, imag + rep_i, n_fft=n_fft, hop=hop,
                 length=chunk48.shape[-1])


def crossover_splice(
    original48: np.ndarray, enhanced48: np.ndarray, sr: int = 48000, fc: float = 10000.0
) -> np.ndarray:
    """Butterworth crossover: original lows + enhanced highs (:222-320)."""
    n = min(original48.shape[-1], enhanced48.shape[-1])
    lo_b, lo_a = sps.butter(8, fc, btype="low", fs=sr)
    hi_b, hi_a = sps.butter(8, fc, btype="high", fs=sr)
    lows = sps.filtfilt(lo_b, lo_a, original48[..., :n])
    highs = sps.filtfilt(hi_b, hi_a, enhanced48[..., :n])
    return (lows + highs).astype(np.float32)


def make_wavegrad_enhancer(model, wt_cfg, schedule=None, seed: int = 0, draws=None):
    """Learned diffusion enhancer (the reference's AudioSR slot,
    wrappers/super_res.py:42): conditions a trained WaveGrad (a module on the
    chunks' device) on each chunk's own mel and re-synthesises it; the
    crossover splice in super_resolve then keeps only the generated highband.
    ``draws`` are :func:`~audiolab_tpu_torch.models.wavegrad.sample`'s for
    the flattened chunk batch (default from ``seed``)."""
    from audiolab_tpu_torch.models.wavegrad import FAST_6, sample
    from audiolab_tpu_torch.train.wavetransfer import _mel_of

    sched = schedule or FAST_6

    def enhance(chunks: torch.Tensor) -> torch.Tensor:
        # chunks (count, ch, n) -> channels flattened into the batch
        count, ch, n = chunks.shape
        flat = chunks.reshape(count * ch, n)
        out = sample(model, _mel_of(flat, wt_cfg), sched, seed=seed, draws=draws)
        pad = n - out.shape[-1]
        if pad > 0:
            out = F.pad(out, (0, pad))
        return out[:, :n].reshape(count, ch, n)

    return enhance


def super_resolve(
    audio: np.ndarray,
    sr: int,
    enhancer_fn=None,
    chunk_seconds: float = 10.24,
    overlap_seconds: float = 0.64,
    crossover_hz: float | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, int]:
    """(ch, n)@sr -> (ch, m)@48k with enhanced highband; the resample,
    chunks and enhancer on ``device`` (default the card; raises without
    one)."""
    dev = resolve_device(device)
    if audio.ndim == 1:
        audio = audio[None]
    target_sr = 48000
    x48_t = resample(torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(dev),
                     sr, target_sr)
    x48 = x48_t.cpu().numpy()

    plan = plan_chunks(x48.shape[-1], int(chunk_seconds * target_sr),
                       int(overlap_seconds * target_sr))
    chunks = extract_chunks(x48_t, plan)  # (count, ch, chunk)
    fn = enhancer_fn or sbr_enhance
    enhanced = torch.as_tensor(fn(chunks), device=dev)
    y = stitch_chunks(enhanced, plan).cpu().numpy()

    # crossover: keep original lows below the source Nyquist-ish corner
    fc = crossover_hz if crossover_hz is not None else min(0.4 * sr, 20000.0)
    y = crossover_splice(x48, y, target_sr, fc=fc)

    # loudness match to the (resampled) input
    li = integrated_loudness(x48, target_sr)
    lo = integrated_loudness(y, target_sr)
    if np.isfinite(li) and np.isfinite(lo):
        y = y * 10.0 ** ((li - lo) / 20.0)
    peak = np.abs(y).max() if y.size else 0.0
    if peak > 0.99:
        y = y * (0.99 / peak)
    return y.astype(np.float32), target_sr


# ------------------------------------------- AudioSR checkpoint pipeline

def cosine_alphas_cumprod(n_timesteps: int = 1000, s: float = 8e-3) -> np.ndarray:
    """The audiosr cosine schedule (diffusionmodules/util.py:31-39):
    alphas_cumprod[t] = prod(1 - betas[:t+1]), float64."""
    ts = np.arange(n_timesteps + 1, dtype=np.float64) / n_timesteps + s
    al = np.cos(ts / (1 + s) * np.pi / 2) ** 2
    al = al / al[0]
    betas = 1 - al[1:] / al[:-1]
    return np.cumprod(1.0 - betas)


# the constant unconditional VAE latent upstream uses for CFG
# (audiosr encoders/modules.py VAEFeatureExtract.forward:
#  unconditional_cond = -11.4981 + vae_embed * 0.0)
_AUDIOSR_UNCOND_LATENT = -11.4981


def ddim_timesteps(n_timesteps: int, steps: int) -> list[int]:
    """The DDIM step sequence: ``steps`` fp32 points from n_timesteps - 1
    down to 0, rounded half to even."""
    return [int(t) for t in np.round(np.linspace(n_timesteps - 1, 0, steps, dtype=np.float32))]


class AudioSRCheckpointPipeline:
    """DDIM (eta 0) super-resolution with the AudioSR stack
    (models/audiosr_{vae,unet,vocoder}.py, modules holding their weights on
    one device; sampler semantics from ddpm.py register_schedule + ddim.py,
    v-parameterisation):

      lowpass fbank -> VAE mean latents -> x scale_factor (DiffusionWrapper
      concat conditioning, ddpm.py:1658) -> classifier-free-guided DDIM
      v-prediction denoise (guidance_scale 3.5, pipeline.py:155; the
      unconditional branch is the constant -11.4981 latent,
      encoders/modules.py:146; both branches in one batched UNet call) ->
      / scale_factor (decode_first_stage, ddpm.py:930) -> VAE decode ->
      48 kHz vocoder.

    ``scale_factor`` is a checkpoint buffer (ddpm.py:672 register_buffer,
    set by scale_by_std at :747).  The starting latent is a draw: ``z`` or
    a generator seeded with ``seed`` on the modules' device.
    """

    def __init__(self, vae, unet, vocoder, n_timesteps: int = 1000,
                 scale_factor: float = 1.0, guidance_scale: float = 3.5, n_mels: int = 256):
        self.vae, self.unet, self.vocoder = vae, unet, vocoder
        self.device = resolve_device(next(unet.parameters()).device)
        self.acp = torch.tensor(cosine_alphas_cumprod(n_timesteps), dtype=torch.float32,
                                device=self.device)
        self.n_timesteps = n_timesteps
        self.scale_factor = float(scale_factor)
        self.guidance_scale = float(guidance_scale)
        self.n_mels = int(n_mels)

    @torch.inference_mode()
    def ddim_step(self, z: torch.Tensor, cond: torch.Tensor, t: int,
                  t_next: int | None) -> torch.Tensor:
        """One DDIM (eta 0) v-prediction step from timestep ``t`` to
        ``t_next`` (None: the last step, to alpha 1).  ``cond`` is the scaled
        concat conditioning, followed by the unconditional rows when the
        guidance scale is not 1 (both branches in one batched UNet call,
        merged like ddim.py:311 on the raw v output)."""
        a = self.acp[t]
        a_next = self.acp[t_next] if t_next is not None else torch.ones((), device=z.device)
        b = z.shape[0]
        tt = torch.full((cond.shape[0],), float(t), device=z.device)
        if self.guidance_scale != 1.0:
            v2 = self.unet(torch.cat([torch.cat([z, z], dim=0), cond], dim=1), tt)
            v = v2[b:] + self.guidance_scale * (v2[:b] - v2[b:])
        else:
            v = self.unet(torch.cat([z, cond], dim=1), tt)
        # v-param: x0 = sqrt(a) z - sqrt(1-a) v ; eps = sqrt(1-a) z + sqrt(a) v
        x0 = torch.sqrt(a) * z - torch.sqrt(1 - a) * v
        eps = torch.sqrt(1 - a) * z + torch.sqrt(a) * v
        return torch.sqrt(a_next) * x0 + torch.sqrt(1 - a_next) * eps

    @torch.inference_mode()
    def super_resolve(self, lowpass_fbank: torch.Tensor, steps: int = 50, seed: int = 0,
                      z: torch.Tensor | None = None) -> torch.Tensor:
        """(b, 1, t, mel) normalised lowpass fbank -> (b, t * 480) at 48 kHz.
        ``z`` (b, 16, t/8, mel/8) is the starting latent."""
        cond, _ = self.vae.encode(lowpass_fbank)
        # DiffusionWrapper scales the concat cond into the diffusion's latent
        # space (ddpm.py:1658); the CFG unconditional branch likewise
        cond = cond * self.scale_factor
        uncond = torch.full_like(cond, _AUDIOSR_UNCOND_LATENT * self.scale_factor)
        if z is None:
            gen = torch.Generator(device=cond.device).manual_seed(seed)
            z = torch.randn(cond.shape, generator=gen, device=cond.device)
        if tuple(z.shape) != tuple(cond.shape):
            raise ValueError(f"z {tuple(z.shape)}, expected {tuple(cond.shape)}")
        t_seq = ddim_timesteps(self.n_timesteps, steps)
        if self.guidance_scale != 1.0:
            cond = torch.cat([cond, uncond], dim=0)
        for i, t in enumerate(t_seq):
            z = self.ddim_step(z, cond, t, t_seq[i + 1] if i + 1 < steps else None)
        # decode_first_stage divides by scale_factor (ddpm.py:930)
        mel = self.vae.decode(z / self.scale_factor)[:, 0]          # (b, t, mel)
        return self.vocoder(mel.transpose(1, 2))

    def enhance_chunks(self, chunks: torch.Tensor, steps: int = 50, seed: int = 0,
                       z: torch.Tensor | None = None) -> torch.Tensor:
        """(count, ch, n) 48 kHz chunks -> enhanced, same shape: the
        ``enhancer_fn`` contract of ``super_resolve``.  Each channel runs as
        an independent batch row (upstream processes mono, pipeline.py:123)."""
        count, ch, n = chunks.shape
        x = torch.as_tensor(chunks, device=self.device).reshape(count * ch, n)
        # utils.normalize_wav: zero mean, peak 0.5 (audiosr utils.py:186)
        x = x - x.mean(dim=-1, keepdim=True)
        peak = x.abs().amax(dim=-1, keepdim=True) + 1e-8
        fbank = audiosr_fbank(x / peak * 0.5, n_mels=self.n_mels)   # (b, t, mel)
        pad = (-fbank.shape[1]) % 64                    # the VAE's 8x and even frames
        if pad:
            fbank = F.pad(fbank, (0, 0, 0, pad))
        wav = self.super_resolve(fbank[:, None], steps=steps, seed=seed, z=z)
        wav = wav[..., :n] * (peak / 0.5)               # undo the input scaling
        if wav.shape[-1] < n:
            wav = F.pad(wav, (0, n - wav.shape[-1]))
        return wav.reshape(count, ch, n)


def audiosr_fbank(x: torch.Tensor, n_mels: int = 256) -> torch.Tensor:
    """The audiosr log-mel front end (utils.mel_spectrogram_train, audiosr
    utils.py:110-155): 48 kHz, n_fft 2048, hop 480, 256 slaney mels fmin 20
    / fmax 24000, a reflect pad of (n_fft - hop) / 2 with center=False,
    ln(clamp(mel, 1e-5)).  ``x`` (b, n) -> (b, t, 256)."""
    pad = (2048 - 480) // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    m = mel_spectrogram(xp, sr=48000, n_fft=2048, hop=480, n_mels=n_mels, fmin=20.0,
                        fmax=24000.0, htk=False, norm="slaney", power=1.0, center=False)
    return torch.log(torch.clamp(m, min=1e-5))
