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
loudness match are host numpy.  The learned enhancers (WaveGrad, the AudioSR
checkpoint pipeline) come with their models.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import signal as sps

from audiolab_tpu_torch.core.chunking import extract_chunks, plan_chunks, stitch_chunks
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.dsp.loudness import integrated_loudness
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
