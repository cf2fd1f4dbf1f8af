"""ITU-R BS.1770-4 loudness measurement + normalization (counterpart of
audiolab_tpu/dsp/loudness.py, a copy of its host numpy/scipy code).

Replaces the reference's pyloudnorm dependency (handlers/noise_removal.py:3,
112-123; wrappers/super_res.py loudness match): K-weighting (shelving +
RLB high-pass biquads), 400 ms blocks at 75 % overlap, −70 LUFS absolute
gate then −10 LU relative gate.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps


def _k_weighting(sr: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The two BS.1770 pre-filter biquads, bilinear-matched to sr."""
    # stage 1: high-shelf (+4 dB above ~1.5 kHz)
    f0, g_db, q = 1681.9744509555319, 3.99984385397, 0.7071752369554193
    k = np.tan(np.pi * f0 / sr)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh**0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b = np.array([(vh + vb * k / q + k * k), 2.0 * (k * k - vh), (vh - vb * k / q + k * k)]) / a0
    a = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    stage1 = (b, a)
    # stage 2: RLB high-pass
    f0, q = 38.13547087602444, 0.5003270373238773
    k = np.tan(np.pi * f0 / sr)
    a0 = 1.0 + k / q + k * k
    b = np.array([1.0, -2.0, 1.0]) / a0
    a = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    return [stage1, (b, a)]


def integrated_loudness(audio: np.ndarray, sr: int) -> float:
    """Gated integrated loudness in LUFS of ``(n,)`` or ``(channels, n)``."""
    x = np.atleast_2d(np.asarray(audio, dtype=np.float64))
    for b, a in _k_weighting(sr):
        x = sps.lfilter(b, a, x, axis=-1)

    block = int(0.400 * sr)
    hop = int(0.100 * sr)
    n = x.shape[-1]
    if n < block:
        ms = np.mean(x**2, axis=-1).sum()
        return float(-0.691 + 10.0 * np.log10(ms + 1e-12))
    t = 1 + (n - block) // hop
    idx = np.arange(t)[:, None] * hop + np.arange(block)[None, :]
    # per-block mean square, channel-summed (unit channel weights)
    z = np.einsum("ctb->tc", x[:, idx] ** 2) / block  # (T, c)
    lk = -0.691 + 10.0 * np.log10(z.sum(axis=-1) + 1e-12)  # (T,)

    gated = lk > -70.0
    if not gated.any():
        return -np.inf
    rel_thresh = -0.691 + 10.0 * np.log10(z[gated].sum(axis=-1).mean() + 1e-12) - 10.0
    final = gated & (lk > rel_thresh)
    if not final.any():
        return -np.inf
    return float(-0.691 + 10.0 * np.log10(z[final].sum(axis=-1).mean() + 1e-12))


def normalize_loudness(audio: np.ndarray, sr: int, target_lufs: float) -> np.ndarray:
    """Gain to hit target LUFS (pyln.normalize.loudness equivalent)."""
    current = integrated_loudness(audio, sr)
    if not np.isfinite(current):
        return np.asarray(audio)
    gain = 10.0 ** ((target_lufs - current) / 20.0)
    return np.asarray(audio) * gain
