"""Kaldi-compatible log-mel fbank front end (counterpart of
audiolab_tpu/kernels/kaldi.py; ``torchaudio.compliance.kaldi.fbank`` at
num_mel_bins=80, dither=0, sample_frequency=16000).

Kaldi framing: snip-edges strided frames, per-frame DC removal,
pre-emphasis 0.97 with the first sample replicated, the "povey" window
(hann**0.85), zero-pad to the next power of two, power spectrum, and
triangular mel banks linear in the mel domain over 20 Hz .. Nyquist with
the Nyquist bin dropped; log(max(x, float eps)).  The DFT is the JAX
package's pair of cos/sin bases as two fp32 matrix products, and the
bank the same numpy table.  This is plain PyTorch, not a hand-written
kernel (the JAX function is not a Pallas kernel).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_EPS = 1.1920928955078125e-07  # float32 machine epsilon (kaldi EPSILON)


def povey_window(n: int) -> np.ndarray:
    """Kaldi 'povey' window: hann(n, periodic=False) ** 0.85."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * i / (n - 1))) ** 0.85


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


@lru_cache(maxsize=None)
def kaldi_mel_banks(n_mels: int, padded_window: int, sr: int, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi mel banks (feat/mel-computations.cc): triangles linear in mel
    over fft bins 0 .. padded_window/2 - 1; (n_bins + 1, n_mels) float64
    with a zero Nyquist row appended."""
    if high_freq <= 0.0:
        high_freq = sr / 2.0 + high_freq
    n_bins = padded_window // 2
    fft_bin_width = sr / padded_window
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)
    left = mel_low + np.arange(n_mels)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    mel_of_bin = _mel(fft_bin_width * np.arange(n_bins))[None, :]
    up = (mel_of_bin - left) / (center - left)
    down = (right - mel_of_bin) / (right - center)
    w = np.maximum(0.0, np.minimum(up, down))
    w = np.concatenate([w, np.zeros((n_mels, 1))], axis=1)
    return w.T


@lru_cache(maxsize=None)
def _tables(sr: int, n_mels: int, frame_length: int) -> tuple[np.ndarray, ...]:
    """(window, cos basis, sin basis, mel bank) in float32."""
    padded = 1 << (frame_length - 1).bit_length()
    k = np.arange(padded // 2 + 1)
    t = np.arange(frame_length)
    ang = 2.0 * np.pi * k[None, :] * t[:, None] / padded
    return (povey_window(frame_length).astype(np.float32), np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32),
            kaldi_mel_banks(n_mels, padded, sr).astype(np.float32))


def kaldi_fbank(x: torch.Tensor, sr: int = 16000, n_mels: int = 80, frame_length: int = 400,
                frame_shift: int = 160, preemph: float = 0.97,
                remove_dc_offset: bool = True) -> torch.Tensor:
    """(b, n) 16 kHz waveform -> (b, frames, n_mels) kaldi log-fbank
    (dither 0, snip_edges, povey window, power spectrum), in fp32."""
    x = x.float()
    frames = x.unfold(-1, frame_length, frame_shift)           # (b, frames, flen)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    win, cos_b, sin_b, fb = (torch.from_numpy(a).to(x.device)
                             for a in _tables(sr, n_mels, frame_length))
    frames = (frames - preemph * prev) * win
    re = frames @ cos_b
    im = -(frames @ sin_b)
    power = re * re + im * im
    return torch.log(torch.clamp(power @ fb, min=_EPS))
