"""Mel filterbank and (log-)mel spectrogram in fp32 (counterpart of
audiolab_tpu/kernels/mel.py; the filterbank is the same numpy code)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from audiolab_tpu_torch.kernels.stft import spectrogram


def _hz_to_mel(f, htk: bool = False) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    safe = np.maximum(f, 1e-10)
    return np.where(f >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) / logstep, mels)


def _mel_to_hz(m, htk: bool = False) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank ``(n_bins, n_mels)`` (librosa.filters.mel.T)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    elif norm == "inf":
        peak = np.maximum(weights.max(axis=1, keepdims=True), 1e-12)
        weights = weights / peak
    return weights.T.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sr: int = 48000, n_fft: int = 2048, hop: int = 480,
                    win_length: int | None = None, n_mels: int = 128, fmin: float = 0.0,
                    fmax: float | None = None, htk: bool = False,
                    norm: str | None = "slaney", power: float = 1.0,
                    center: bool = True) -> torch.Tensor:
    """Mel spectrogram ``(..., T, n_mels)``; power=1 is the mel of |STFT|."""
    spec = spectrogram(x, n_fft, hop, win_length, center=center, power=power)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk, norm))
    return spec @ fb.to(spec.device)


def log_mel(mel: torch.Tensor, clip_val: float = 1e-5, c: float = 1.0) -> torch.Tensor:
    """Dynamic-range compression log(clamp(x) * C)."""
    return torch.log(torch.clamp(mel, min=clip_val) * c)
