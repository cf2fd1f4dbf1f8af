"""STFT / iSTFT in fp32 (counterpart of audiolab_tpu/kernels/stft.py).

Conventions match the JAX package (and librosa/torch.stft): periodic Hann
window, reflect center-padding, onesided bins n_fft//2+1, the imaginary part
with the -sin sign.  Spectra are returned as a (real, imag) pair shaped
``(..., T, n_bins)``.  The transform is torch's FFT; this is plain code, not
a hand-written kernel (the JAX package's STFT is not a Pallas kernel).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann, identical to torch.hann_window / scipy hann(sym=False)."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1))
    return w[:win_length].astype(np.float32)


@lru_cache(maxsize=None)
def _window(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """The analysis/synthesis window zero-padded (centred) to n_fft."""
    if window == "hann":
        win = hann_window(win_length)
    elif window == "hamming":
        win = (0.54 - 0.46 * np.cos(
            2.0 * np.pi * np.arange(win_length) / win_length)).astype(np.float32)
    elif window == "ones":
        win = np.ones(win_length, dtype=np.float32)
    else:
        raise ValueError(f"unknown window {window}")
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        win = np.pad(win, (pad, n_fft - win_length - pad))
    return win


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """``(..., n) -> (..., T, frame_length)`` overlapping frames (a view)."""
    n = x.shape[-1]
    if n < frame_length:
        raise ValueError(f"signal length {n} < frame {frame_length}")
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int = 2048, hop: int = 512,
         win_length: int | None = None, window: str = "hann",
         center: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Real STFT of ``(..., n)`` -> (real, imag), each ``(..., T, n_bins)``."""
    win_length = win_length or n_fft
    x = x.float()
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if center:
        pad = n_fft // 2
        flat = F.pad(flat[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(flat, n_fft, hop)  # (B, T, n_fft)
    win = torch.from_numpy(_window(n_fft, win_length, window)).to(x.device)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    spec = spec.reshape(*lead, *spec.shape[-2:])
    return spec.real.contiguous(), spec.imag.contiguous()


def spectrogram(x: torch.Tensor, n_fft: int = 2048, hop: int = 512,
                win_length: int | None = None, window: str = "hann",
                center: bool = True, power: float = 2.0,
                eps: float = 1e-9) -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram ``(..., T, n_bins)``."""
    real, imag = stft(x, n_fft, hop, win_length, window, center)
    p = real * real + imag * imag
    if power == 2.0:
        return p
    if power == 1.0:
        return torch.sqrt(p + eps)
    return torch.pow(p + eps, power / 2.0)


@lru_cache(maxsize=None)
def _wsum(n_fft: int, win_length: int, window: str, t_frames: int, hop: int) -> np.ndarray:
    """Overlap-added squared synthesis window, 1 where it vanishes."""
    if window != "hann":
        window = "ones"
    w2 = _window(n_fft, win_length, window) ** 2
    out_len = (t_frames - 1) * hop + n_fft
    wsum = np.zeros(out_len, dtype=np.float32)
    for i in range(t_frames):
        wsum[i * hop: i * hop + n_fft] += w2
    return np.where(wsum > 1e-10, wsum, 1.0).astype(np.float32)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int = 2048, hop: int = 512,
          win_length: int | None = None, window: str = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT of (real, imag) ``(..., T, n_bins)`` -> ``(..., n)``:
    windowed inverse DFT, overlap-add, division by the squared-window sum
    (any hop, including hops that do not divide n_fft)."""
    win_length = win_length or n_fft
    syn = "hann" if window == "hann" else "ones"
    lead = real.shape[:-2]
    t_frames = real.shape[-2]
    spec = torch.complex(real.float(), imag.float()).reshape(-1, t_frames, real.shape[-1])
    win = torch.from_numpy(_window(n_fft, win_length, syn)).to(real.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win  # (B, T, n_fft)
    out_len = (t_frames - 1) * hop + n_fft
    sig = F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                 kernel_size=(1, n_fft), stride=(1, hop))[:, 0, 0]
    sig = sig / torch.from_numpy(_wsum(n_fft, win_length, window, t_frames, hop)).to(
        sig.device)
    if center:
        sig = sig[..., n_fft // 2:]
        if length is not None:
            sig = sig[..., :length]
        else:
            sig = sig[..., : sig.shape[-1] - n_fft // 2]
    elif length is not None:
        sig = sig[..., :length]
    return sig.reshape(*lead, sig.shape[-1])
