"""Reverb IR extraction / application (counterpart of
audiolab_tpu/dsp/reverb.py; reference: handlers/reverb.py).

- ``extract_reverb_params``: pre-delay via FFT cross-correlation (:57-68,127-133),
  RT60 via exponential fit of the dB envelope (:71-91), IR via Wiener
  deconvolution (:94-105), early/late energy split + diffusion + spectral
  centroid (:144-157).
- ``apply_reverb``: FFT convolution with the stored IR, pre-delay pad,
  dry + 0.7·wet mix, clip (:179-209).
- ``generate_ir``: synthetic IR for simulation/tests (:229-300).

The FFT work (cross-correlation, deconvolution, convolution over full
songs) runs in torch on the given device; the RT60 curve fit, the IR
descriptors and the IR synthesis stay on the host (numpy/scipy, copied).
"""

from __future__ import annotations

import json

import numpy as np
import torch
from scipy.optimize import curve_fit

from audiolab_tpu_torch.core.device import resolve_device


def fft_xcorr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross-correlation corr[k] = sum a[n] b[n-k] via FFT (handlers/reverb.py:57-68)."""
    n = a.shape[-1] + b.shape[-1] - 1
    nfft = int(2 ** np.ceil(np.log2(n)))
    fa = torch.fft.rfft(a, n=nfft)
    fb = torch.fft.rfft(b, n=nfft)
    return torch.fft.irfft(fa * torch.conj(fb), n=nfft)[..., :n]


def wiener_deconvolution(signal: torch.Tensor, kernel: torch.Tensor,
                         epsilon: float = 1e-6) -> torch.Tensor:
    """Stable deconvolution H*Y/(|H|²+ε) (handlers/reverb.py:94-105)."""
    n = signal.shape[-1]
    h = torch.fft.rfft(kernel, n=n)
    y = torch.fft.rfft(signal, n=n)
    return torch.fft.irfft(torch.conj(h) * y / (torch.abs(h) ** 2 + epsilon), n=n)


def estimate_rt60(signal: np.ndarray, sr: int, maxfev: int = 5000) -> float:
    """RT60-style decay time from an exponential fit of the dB envelope
    (handlers/reverb.py:71-91; decay_time = 3/b of a·exp(-b t)+c)."""
    eps = 1e-10
    sig = np.asarray(signal)
    env = (np.sqrt(np.sum(sig**2, axis=-1 if sig.ndim == 1 else 0)) + eps) if sig.ndim == 2 else np.abs(sig) + eps
    if sig.ndim == 2:
        env = np.sqrt(np.sum(sig**2, axis=0)) + eps
    env_db = 20.0 * np.log10(env)
    t = np.linspace(0, len(env_db) / sr, len(env_db))

    def exp_decay(x, a, b, c):
        return a * np.exp(-b * x) + c

    try:
        popt, _ = curve_fit(exp_decay, t, env_db, maxfev=maxfev)
        decay = 3.0 / popt[1] if popt[1] != 0 else 0.5
    except Exception:
        decay = 0.5
    return max(float(decay), 0.01)


def extract_reverb_params(
    dry: np.ndarray,
    wet: np.ndarray,
    sr: int,
    wiener_epsilon: float = 1e-6,
    curve_fit_maxfev: int = 5000,
    device: str | torch.device = "cuda",
) -> dict:
    """Estimate IR + descriptors from a dry/wet pair; arrays are ``(n,)`` or
    ``(channels, n)`` (handlers/reverb.py:112-172 with in-memory I/O)."""
    dev = resolve_device(device)
    dry_m = torch.from_numpy(np.asarray(dry if dry.ndim == 1 else dry.mean(axis=0),
                                        np.float32)).to(dev)
    wet_m = torch.from_numpy(np.asarray(wet if wet.ndim == 1 else wet.mean(axis=0),
                                        np.float32)).to(dev)

    corr = fft_xcorr(wet_m, dry_m).cpu().numpy()
    best_shift = max(int(np.argmax(corr)) - (dry_m.shape[-1] - 1), 0)
    pre_delay = best_shift / sr

    decay_time = estimate_rt60(np.asarray(wet), sr, maxfev=curve_fit_maxfev)

    ir = wiener_deconvolution(wet_m, dry_m, epsilon=wiener_epsilon).cpu().numpy()
    ir = ir[: int(sr * 2)]

    early = int(0.05 * sr)
    early_e = float(np.sum(ir[:early] ** 2))
    total_e = float(np.sum(ir**2)) + 1e-10
    fft_ir = np.abs(np.fft.rfft(ir))
    freqs = np.fft.rfftfreq(len(ir), d=1.0 / sr)

    return {
        "sample_rate": sr,
        "pre_delay": float(pre_delay),
        "decay_time": float(decay_time),
        "early_reflection_ratio": early_e / total_e,
        "late_reverb_ratio": (total_e - early_e) / total_e,
        "diffusion": float(np.var(np.abs(ir))),
        "spectral_centroid": float(np.sum(freqs * fft_ir) / (np.sum(fft_ir) + 1e-10)),
        "impulse_response": ir.tolist(),
    }


def _convolve_mix(dry: torch.Tensor, ir: torch.Tensor, pre_delay_samples: int) -> torch.Tensor:
    n = dry.shape[-1]
    m = ir.shape[-1]
    nfft = int(2 ** np.ceil(np.log2(n + m - 1)))
    wet = torch.fft.irfft(torch.fft.rfft(dry, n=nfft) * torch.fft.rfft(ir, n=nfft), n=nfft)
    if pre_delay_samples:
        wet = torch.nn.functional.pad(wet, (pre_delay_samples, 0))
    wet = wet[..., :n]
    return torch.clamp(dry + 0.7 * wet, -1.0, 1.0)


def apply_reverb(dry: np.ndarray, params: dict,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Convolve dry ``(n,)``/``(channels, n)`` with the stored IR
    (handlers/reverb.py:179-209)."""
    dev = resolve_device(device)
    sr = params["sample_rate"]
    ir = torch.from_numpy(np.asarray(params["impulse_response"], dtype=np.float32)).to(dev)
    pre = int(params["pre_delay"] * sr)
    x = torch.from_numpy(np.asarray(dry, np.float32)).to(dev)
    return _convolve_mix(x, ir, pre).cpu().numpy()


def save_params(params: dict, path: str) -> str:
    with open(path, "w") as f:
        json.dump(params, f)
    return path


def load_params(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def generate_ir(
    sr: int,
    pre_delay: float,
    decay_time: float,
    early_reflection_ratio: float,
    diffusion: float,
    spectral_centroid: float,
    length: float = 2.0,
    seed: int = 0,
) -> np.ndarray:
    """Synthetic IR: pre-delay + sparse early reflections + noisy exponential
    tail with crude centroid-matched lowpass (handlers/reverb.py:229-300)."""
    rng = np.random.default_rng(seed)
    total = int(sr * length)
    pre = int(pre_delay * sr)
    early_len = int(0.05 * sr)
    tail_len = total - pre - early_len

    ir = np.zeros(total, dtype=np.float32)
    early = np.zeros(early_len, dtype=np.float32)
    for _ in range(rng.integers(3, 7)):
        early[rng.integers(0, early_len)] += rng.uniform(0.1, 1.0)
    e = np.sum(early**2)
    if e > 0:
        early *= np.sqrt(early_reflection_ratio / e)
    ir[pre : pre + early_len] = early

    t = np.linspace(0, tail_len / sr, tail_len, endpoint=False)
    tail = np.exp(-t / decay_time) + diffusion * rng.standard_normal(tail_len)
    alpha = max(0.0, (spectral_centroid - 4000) / 10000)
    if alpha > 0:
        k = max(1, int(sr * 0.005))
        kern = np.exp(-np.linspace(0, k - 1, k) / (alpha * k))
        kern /= kern.sum()
        tail = np.convolve(tail, kern, mode="same")
    te = np.sum(tail**2)
    if te > 0:
        tail *= np.sqrt((1 - early_reflection_ratio) / te)
    ir[pre + early_len :] = tail
    peak = np.max(np.abs(ir))
    return ir / peak if peak > 0 else ir
