"""Polyphase sample-rate conversion on the device (counterpart of
audiolab_tpu/kernels/resample.py::resample).

Same FIR as the JAX package (scipy.signal.resample_poly's default: a
Kaiser(5.0)-windowed sinc, 10 taps per phase, cutoff min(1/L, 1/M)), same
output: y[m] = sum_n x[n] h[n*up - m*down + half], n_out = ceil(n*up/down).
The JAX package dilates the input by ``up`` inside one convolution; here the
``up`` output phases are the output channels of one strided conv1d over the
undilated input, so no zero-stuffed signal is ever built.
:func:`resample_poly_np` is the host resampler (scipy's resample_poly).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps


@lru_cache(maxsize=None)
def _poly_filter(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for polyphase up/down conversion."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = sps.firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float32)


@lru_cache(maxsize=None)
def _phase_bank(up: int, down: int) -> tuple[np.ndarray, int]:
    """(up, 1, W) filters, one per output phase p, and the input offset s0:
    y[p + up*i] = sum_j bank[p, 0, j] * x[down*i + s0 + j]."""
    h = _poly_filter(up, down)
    n_taps = len(h)
    half = (n_taps - 1) // 2
    s_lo = [-((half - p * down) // up) for p in range(up)]          # ceil((p*down-half)/up)
    s_hi = [(p * down - half + n_taps - 1) // up for p in range(up)]
    s0, s1 = min(s_lo), max(s_hi)
    bank = np.zeros((up, 1, s1 - s0 + 1), np.float32)
    for p in range(up):
        for s in range(s_lo[p], s_hi[p] + 1):
            bank[p, 0, s - s0] = h[s * up - p * down + half]
    return bank, s0


def resample(x: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Polyphase resample ``(..., n) -> (..., ceil(n*target/orig))`` in fp32."""
    if orig_sr == target_sr:
        return x
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    bank, s0 = _phase_bank(up, down)
    width = bank.shape[-1]
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    n_per_phase = -(-n_out // up)
    lead = x.shape[:-1]
    xr = x.float().reshape(-1, 1, n_in)
    right = max(0, down * (n_per_phase - 1) + s0 + width - n_in)
    xr = F.pad(xr, (-s0, right))
    w = torch.from_numpy(bank).to(xr.device)
    y = F.conv1d(xr, w, stride=down)[..., :n_per_phase]   # (N, up, n_per_phase)
    y = y.transpose(1, 2).reshape(xr.shape[0], -1)[:, :n_out]
    return y.reshape(*lead, n_out)


def resample_poly_np(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Host resample (numpy in and out, float32 out) by scipy's
    resample_poly along the last axis."""
    if orig_sr == target_sr:
        return np.asarray(x)
    g = math.gcd(orig_sr, target_sr)
    return sps.resample_poly(np.asarray(x), target_sr // g, orig_sr // g, axis=-1).astype(
        np.float32)
