"""Signal processing of the plain reference, fp32: STFT and inverse, mel,
polyphase resampling, fixed-size chunks and their crossfade stitch, the
coarse pitch bins and the converter's high-pass.  Written from the published
conventions (librosa / torch.stft: periodic Hann, reflect centre padding,
onesided bins; scipy's resample_poly filter; RVC's 1-255 mel-scale pitch
bins); it shares no code with the program."""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps


# ---------------------------------------------------------------- STFT

def hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft(x: torch.Tensor, n_fft: int, hop: int, center: bool = True):
    """(..., n) -> (real, imag), each (..., T, n_fft // 2 + 1)."""
    lead = x.shape[:-1]
    flat = x.float().reshape(-1, x.shape[-1])
    if center:
        flat = F.pad(flat[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = flat.unfold(-1, n_fft, hop)
    win = torch.from_numpy(hann(n_fft)).to(x.device)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    spec = spec.reshape(*lead, *spec.shape[-2:])
    return spec.real.contiguous(), spec.imag.contiguous()


def magnitude(x: torch.Tensor, n_fft: int, hop: int, center: bool = True,
              eps: float = 1e-9) -> torch.Tensor:
    re, im = stft(x, n_fft, hop, center)
    return torch.sqrt(re * re + im * im + eps)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop: int,
          length: int) -> torch.Tensor:
    """Centred inverse STFT by windowed overlap-add over the squared-window
    sum; the DC and Nyquist imaginary parts are taken as 0 (a real signal's
    spectrum has none)."""
    lead, t = real.shape[:-2], real.shape[-2]
    imag = imag.clone()
    imag[..., 0] = 0.0
    imag[..., n_fft // 2] = 0.0
    spec = torch.complex(real.float(), imag.float()).reshape(-1, t, real.shape[-1])
    win = torch.from_numpy(hann(n_fft)).to(real.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    out_len = (t - 1) * hop + n_fft
    sig = F.fold(frames.transpose(1, 2), output_size=(1, out_len), kernel_size=(1, n_fft),
                 stride=(1, hop))[:, 0, 0]
    wsum = _window_sum(n_fft, hop, t)
    sig = sig / torch.from_numpy(wsum).to(sig.device)
    sig = sig[..., n_fft // 2:][..., :length]
    return sig.reshape(*lead, sig.shape[-1])


@lru_cache(maxsize=None)
def _window_sum(n_fft: int, hop: int, t: int) -> np.ndarray:
    w2 = hann(n_fft).astype(np.float64) ** 2
    out = np.zeros((t - 1) * hop + n_fft)
    for i in range(t):
        out[i * hop:i * hop + n_fft] += w2
    return np.where(out > 1e-10, out, 1.0).astype(np.float32)


# ---------------------------------------------------------------- mel

def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    lin = f / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep, lin)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), m * 200.0 / 3)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False) -> np.ndarray:
    """Slaney-normalised triangular filters, (n_fft // 2 + 1, n_mels)."""
    fmax = sr / 2.0 if fmax is None else fmax
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2), htk)
    ramps = hz[:, None] - freqs[None, :]
    fd = np.diff(hz)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None], ramps[2:] / fd[1:, None]))
    w *= (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return w.T.astype(np.float32)


def mel(x: torch.Tensor, sr: int, n_fft: int, hop: int, n_mels: int, fmin: float = 0.0,
        fmax: float | None = None, htk: bool = False, center: bool = True) -> torch.Tensor:
    """Mel of the STFT magnitude, (..., T, n_mels)."""
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk)).to(x.device)
    return magnitude(x, n_fft, hop, center) @ fb


# ---------------------------------------------------------------- resampling

@lru_cache(maxsize=None)
def _poly_filter(up: int, down: int) -> np.ndarray:
    m = max(up, down)
    return (sps.firwin(20 * m + 1, 1.0 / m, window=("kaiser", 5.0)) * up).astype(np.float32)


def resample(x: torch.Tensor, orig: int, target: int) -> torch.Tensor:
    """resample_poly's output, y[m] = sum_n x[n] h[n*up - m*down + half],
    length ceil(n*up/down).  Output m = p + up*i reads inputs
    n = first[p] + down*i + j with the taps of phase p, so each phase is one
    strided correlation; all phases run as the channels of one conv1d."""
    g = math.gcd(orig, target)
    up, down = target // g, orig // g
    h = _poly_filter(up, down)
    taps, half = len(h), (len(h) - 1) // 2
    first = [-((half - p * down) // up) for p in range(up)]    # ceil((p*down - half) / up)
    last = [(p * down - half + taps - 1) // up for p in range(up)]
    lo = min(first)
    bank = np.zeros((up, 1, max(last) - lo + 1), np.float32)
    for p in range(up):
        for n in range(first[p], last[p] + 1):
            bank[p, 0, n - lo] = h[n * up - p * down + half]
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    per_phase = -(-n_out // up)
    lead = x.shape[:-1]
    xs = x.float().reshape(-1, 1, n_in)
    right = max(0, down * (per_phase - 1) + lo + bank.shape[-1] - n_in)
    xs = F.pad(xs, (-lo, right))
    y = F.conv1d(xs, torch.from_numpy(bank).to(x.device), stride=down)[..., :per_phase]
    y = y.transpose(1, 2).reshape(xs.shape[0], -1)[:, :n_out]
    return y.reshape(*lead, n_out)


# ---------------------------------------------------------------- chunks

@dataclass(frozen=True)
class Plan:
    chunk: int
    hop: int
    n: int
    count: int
    padded: int


def plan(n: int, chunk: int, overlap: int) -> Plan:
    hop = chunk - overlap
    count = max(1, -(-max(n - overlap, 1) // hop))
    return Plan(chunk, hop, n, count, (count - 1) * hop + chunk)


def chunks(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """(..., n) -> (count, ..., chunk), zero-padded at the end."""
    x = F.pad(x, (0, p.padded - p.n))
    return torch.stack([x[..., i * p.hop:i * p.hop + p.chunk] for i in range(p.count)])


def stitch(parts: torch.Tensor, p: Plan) -> torch.Tensor:
    """Overlap-add (count, ..., chunk) -> (..., n), linear crossfades over
    each overlap."""
    ov = p.chunk - p.hop
    out = parts.new_zeros(parts.shape[1:-1] + (p.padded,))
    fade = torch.linspace(0.0, 1.0, ov + 2, device=parts.device)[1:-1] if ov else None
    for i in range(p.count):
        w = torch.ones(p.chunk, device=parts.device)
        if ov and p.count > 1:
            if i > 0:
                w[:ov] = fade
            if i < p.count - 1:
                w[p.chunk - ov:] = fade.flip(0)
        out[..., i * p.hop:i * p.hop + p.chunk] += parts[i] * w
    return out[..., :p.n]


# ---------------------------------------------------------------- pitch

def coarse_f0(f0: torch.Tensor, f0_min: float = 50.0, f0_max: float = 1100.0) -> torch.Tensor:
    """RVC's 1-255 mel-scale pitch bins of f0 in Hz (0 Hz -> 1)."""
    lo = 1127.0 * np.log(1.0 + f0_min / 700.0)
    hi = 1127.0 * np.log(1.0 + f0_max / 700.0)
    m = 1127.0 * torch.log(1.0 + f0 / 700.0)
    s = torch.where(m > 0, (m - lo) * 254.0 / (hi - lo) + 1.0, torch.ones_like(m))
    return torch.clamp(torch.round(s), 1, 255).long()


def highpass16k(x: torch.Tensor) -> torch.Tensor:
    """The converter's zero-phase 257-tap 48 Hz FIR high-pass at 16 kHz,
    reflect-padded."""
    taps = sps.firwin(257, 48, fs=16000, pass_zero=False).astype(np.float32)
    w = torch.from_numpy(taps[::-1].copy()).to(x.device)
    y = F.pad(x.float().reshape(-1, 1, x.shape[-1]), (128, 128), mode="reflect")
    return F.conv1d(y, w[None, None]).reshape(x.shape)
