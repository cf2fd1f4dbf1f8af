"""Auto-tune + key detection (counterpart of audiolab_tpu/dsp/autotune.py;
reference: handlers/autotune.py).

Behavioral parity with the reference's `auto_tune_track`:
  1. resample to 16 kHz, extract f0                       (:92-114)
  2. snap f0 to nearest semitone (+optional humanize)     (:116-124)
  3. per-frame shift factors, grouped into segments       (:126-132)
  4. pitch-shift + strength blend                          (:134-158)
  5. Krumhansl–Schmuckler key detection on chroma          (:37-79)

Instead of the reference's host loop of librosa.pitch_shift calls per
segment, the grouped (piecewise-constant) shift contour is expanded back to
per-frame factors and applied in ONE ``pitch_shift_granular`` pass over the
whole track on the device; the grouping and the key search stay on the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.dsp.f0 import f0_autocorr
from audiolab_tpu_torch.dsp.pitch import autotune_f0, pitch_shift_granular
from audiolab_tpu_torch.kernels.resample import resample
from audiolab_tpu_torch.kernels.stft import spectrogram

_KEYS = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
# Krumhansl & Kessler (1982) profiles — same constants as handlers/autotune.py:55-56
_MAJOR = np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
_MINOR = np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 2.88, 2.75])


@lru_cache(maxsize=None)
def chroma_filterbank(sr: int, n_fft: int) -> np.ndarray:
    """(n_bins, 12) map from FFT bins to pitch classes (gaussian weighting,
    octave-summed) — the role of librosa.feature.chroma_stft's filterbank."""
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_bins)
    fb = np.zeros((n_bins, 12), dtype=np.float32)
    midi = 69.0 + 12.0 * np.log2(np.maximum(freqs, 1e-6) / 440.0)
    for pc in range(12):
        # distance of each bin to the nearest octave of this pitch class
        dist = np.abs(((midi - (pc + 60)) + 6.0) % 12.0 - 6.0)
        fb[:, pc] = np.exp(-0.5 * (dist / 0.75) ** 2)
    fb[freqs < 30.0] = 0.0
    # column-normalize so loud octaves don't dominate
    fb /= fb.sum(axis=1, keepdims=True) + 1e-9
    return fb


def detect_key(audio: np.ndarray, sr: int,
               device: str | torch.device = "cuda") -> tuple[str, str]:
    """Krumhansl–Schmuckler key/scale estimate (handlers/autotune.py:37-79)."""
    dev = resolve_device(device)
    n_fft = 4096
    x = torch.from_numpy(np.asarray(audio, dtype=np.float32)).to(dev)
    spec = spectrogram(x, n_fft=n_fft, hop=n_fft // 4, power=1.0)
    fb = torch.from_numpy(chroma_filterbank(sr, n_fft)).to(dev)
    chroma = (spec @ fb).cpu().numpy()  # (T, 12)
    chroma_mean = chroma.mean(axis=0)
    # pitch-class 0 of the filterbank corresponds to C (midi 60)
    best = (-np.inf, "C", "major")
    for i in range(12):
        for name, prof in (("major", _MAJOR), ("minor", _MINOR)):
            c = np.corrcoef(chroma_mean, np.roll(prof, i))[0, 1]
            if c > best[0]:
                best = (c, _KEYS[i], name)
    return best[1], best[2]


def group_pitch_shift_factors(
    time_axis: np.ndarray, shift_factors: np.ndarray, tolerance: float = 0.02
) -> list[tuple[float, float, float]]:
    """Contiguous frames with similar shift -> (t0, t1, median_shift)
    segments (handlers/autotune.py:16-34)."""
    groups = []
    if len(shift_factors) == 0:
        return groups
    start = 0
    current = shift_factors[0]
    for i in range(1, len(shift_factors)):
        if abs(shift_factors[i] - current) > tolerance:
            groups.append((time_axis[start], time_axis[i - 1], float(np.median(shift_factors[start:i]))))
            start = i
            current = shift_factors[i]
    groups.append((time_axis[start], time_axis[-1], float(np.median(shift_factors[start:]))))
    return groups


def auto_tune_track(
    audio: np.ndarray,
    sr: int,
    strength: float = 0.5,
    humanize: bool = False,
    f0_fn=None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, str, str]:
    """Auto-tune ``(n,)`` or ``(channels, n)`` audio; returns
    (corrected, key, scale) — same contract as handlers/autotune.py:165-223.

    f0_fn: optional callable(audio16k)->f0 Hz array (e.g. the RMVPE model);
    defaults to the YIN estimator.
    """
    dev = resolve_device(device)
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        channels = audio[None]
    else:
        channels = audio

    hop16 = 160  # 10 ms at 16 kHz, matching the reference's extraction hop
    out = []
    rng = np.random.default_rng(seed)
    for ch in channels:
        x = torch.from_numpy(np.ascontiguousarray(ch)).to(dev)
        x16 = resample(x, sr, 16000)
        if f0_fn is None:
            f0, _ = f0_autocorr(x16, sr=16000, hop=hop16)
            f0 = f0.cpu().numpy()
        else:
            f0 = np.asarray(f0_fn(x16.cpu().numpy()))
        tuned = autotune_f0(torch.tensor(np.asarray(f0), dtype=torch.float32)).numpy()
        if humanize:
            cents = rng.uniform(-0.05, 0.05, size=tuned.shape)
            tuned = tuned * (2.0 ** (cents / 12.0))

        with np.errstate(divide="ignore", invalid="ignore"):
            shift = np.where(f0 > 1.0, tuned / np.maximum(f0, 1e-6), 1.0)
        frame_dur = hop16 / 16000.0
        t_axis = np.arange(len(shift)) * frame_dur
        groups = group_pitch_shift_factors(t_axis, shift)

        # expand grouped medians back to a per-output-frame factor contour
        out_hop = 512
        n = ch.shape[-1]
        t_out = n // out_hop + 1
        factors = np.ones(t_out, dtype=np.float32)
        for t0, t1, med in groups:
            if med <= 0 or (t1 - t0) < 0.02:  # skip <20ms segments (ref :143)
                continue
            i0 = int(t0 * sr / out_hop)
            i1 = min(t_out, int(t1 * sr / out_hop) + 1)
            factors[i0:i1] = med
        # source period per output frame (for phase-locked grains)
        f0_idx = np.clip(
            np.round(np.arange(t_out) * out_hop / sr / frame_dur).astype(int),
            0,
            len(f0) - 1,
        )
        f0_at_out = f0[f0_idx]
        periods = np.where(f0_at_out > 0, sr / np.maximum(f0_at_out, 1e-3), 0.0)
        shifted = pitch_shift_granular(
            x,
            torch.from_numpy(factors).to(dev),
            periods=torch.from_numpy(periods.astype(np.float32)).to(dev),
            hop=out_hop,
        ).cpu().numpy()
        out.append((1.0 - strength) * ch + strength * shifted)

    corrected = np.stack(out) if audio.ndim == 2 else out[0]
    key, scale = detect_key(corrected if corrected.ndim == 1 else corrected.mean(0), sr,
                            device=dev)
    return corrected.astype(np.float32), key, scale
