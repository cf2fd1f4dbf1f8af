"""ACE-Step's audio <-> latent chain with upstream's constants (counterpart
of audiolab_tpu/models/music_dcae.py; upstream
acestep/music_dcae/music_dcae_pipeline.py:30-150 and music_log_mel.py).

- ``log_mel_44k``: 44.1 kHz, n_fft 2048, hop 512, no centring after a
  manual (n_fft - hop) / 2 reflect pad, sqrt(power + 1e-6), a slaney
  filterbank over 40..16000 Hz, log(clamp(1e-5)); on the port's
  ``kernels/stft.py`` and ``kernels/mel.py``.
- Mel normalisation to [-1, 1]: (mel + 11) / 14, then Normalize(0.5, 0.5).
- Latent scaling z' = (z - shift) * scale, scale 0.1786, shift -1.9091.
- Mel -> audio through :class:`~audiolab_tpu_torch.models.adamos_vocoder.AdamosVocoder`,
  one channel at a time as upstream does, 512 samples a frame.

``encoder_fn``/``decoder_fn`` are any mel <-> latent pair:
:func:`dcae_codec_fns` builds it from an
:class:`~audiolab_tpu_torch.models.dcae.AutoencoderDC`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audiolab_tpu_torch.kernels.mel import mel_filterbank
from audiolab_tpu_torch.kernels.stft import spectrogram

MIN_MEL = -11.0
MAX_MEL = 3.0
SCALE_FACTOR = 0.1786
SHIFT_FACTOR = -1.9091
SR = 44100
HOP = 512
N_FFT = 2048
TIME_MULTIPLE = 8  # the DCAE's temporal downsampling: a latent frame is 8 mel frames


def log_mel_44k(audio: torch.Tensor) -> torch.Tensor:
    """(..., t) at 44.1 kHz -> (..., frames, 128) log-mel."""
    pad_l, pad_r = (N_FFT - HOP) // 2, (N_FFT - HOP + 1) // 2
    lead = audio.shape[:-1]
    x = F.pad(audio.float().reshape(-1, 1, audio.shape[-1]), (pad_l, pad_r), mode="reflect")
    spec = spectrogram(x[:, 0], n_fft=N_FFT, hop=HOP, center=False, power=1.0, eps=1e-6)
    fb = torch.from_numpy(mel_filterbank(SR, N_FFT, 128, 40.0, 16000.0, htk=False,
                                         norm="slaney")).to(spec.device)
    mel = torch.log(torch.clamp(spec @ fb, min=1e-5))
    return mel.reshape(*lead, *mel.shape[-2:])


def normalize_mel(mel: torch.Tensor) -> torch.Tensor:
    """log-mel -> [-1, 1]."""
    m = (mel - MIN_MEL) / (MAX_MEL - MIN_MEL)
    return (m - 0.5) / 0.5


def denormalize_mel(mel: torch.Tensor) -> torch.Tensor:
    m = mel * 0.5 + 0.5
    return m * (MAX_MEL - MIN_MEL) + MIN_MEL


def dcae_codec_fns(model):
    """An :class:`AutoencoderDC` -> MusicDCAE's ``encoder_fn``/``decoder_fn``:
    normalised mels (b, ch, T, 128) to latents (b, 8, 16, t) and back.  The
    DCAE's image is (b, ch, 128 bins, T), upstream's NCHW orientation.  Each
    function holds the model as ``.model``."""

    @torch.inference_mode()
    def encoder_fn(mel):
        return model.encode(mel.transpose(2, 3))

    @torch.inference_mode()
    def decoder_fn(z):
        return model.decode(z).transpose(2, 3)

    encoder_fn.model = decoder_fn.model = model
    return encoder_fn, decoder_fn


class MusicDCAE:
    """Audio (b, ch, t) at 44.1 kHz <-> scaled latents, and latents -> audio."""

    def __init__(self, encoder_fn=None, decoder_fn=None, vocoder=None):
        self.encoder_fn = encoder_fn    # normalised mel (b, ch, T, 128) -> latent
        self.decoder_fn = decoder_fn    # latent -> normalised mel (b, ch, T, 128)
        self.vocoder = vocoder          # AdamosVocoder

    @torch.inference_mode()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """(b, ch, t) -> scaled latents; t padded to a multiple of 8 * 512."""
        t = audio.shape[-1]
        block = TIME_MULTIPLE * HOP
        if t % block:
            audio = F.pad(audio, (0, block - t % block))
        z = self.encoder_fn(normalize_mel(log_mel_44k(audio)))
        return (z - SHIFT_FACTOR) * SCALE_FACTOR

    def latent_frames(self, audio_len: int, sr: int = SR) -> int:
        """Audio samples -> latent frames (upstream's latent_lengths)."""
        return int(audio_len / sr * SR / HOP / TIME_MULTIPLE)

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> np.ndarray:
        """Scaled latents -> (b, ch, t) audio, the vocoder one channel at a time."""
        mel = denormalize_mel(self.decoder_fn(latents / SCALE_FACTOR + SHIFT_FACTOR))
        return np.stack([self.vocoder(mel[:, ch]).float().cpu().numpy()
                         for ch in range(mel.shape[1])], axis=1)
