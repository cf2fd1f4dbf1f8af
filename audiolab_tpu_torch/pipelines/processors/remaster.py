"""Remaster processor — reference-track mastering (counterpart of
audiolab_tpu/pipelines/processors/remaster.py; reference:
wrappers/remaster.py:14-88, which wraps Matchering 2.0).

Matchering's full recipe:
  1. mid/side decomposition
  2. piece-wise RMS analysis: split both tracks into ~1 s pieces, keep the
     "loudest" pieces (RMS >= mean RMS), match the mid-channel RMS of the
     loudest pieces (matchering's level stage)
  3. match the smoothed magnitude spectrum of the loudest pieces via an
     FFT-designed matching EQ, mid and side filtered separately
  4. iterative RMS correction after the EQ (matchering runs 4 steps)
  5. lookahead peak limiter with attack/release smoothing to the ceiling
     (matchering's Hyrax limiter role)

The matching EQ (:func:`match_spectrum`: two smoothed spectra, the FIR
design and one FFT product over the whole track) runs in torch on the
processor's device; the level analysis and the limiter are host numpy,
copied from the JAX module.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from audiolab_tpu_torch.core.audio_io import read_audio, write_audio
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.core.project import ProjectFiles
from audiolab_tpu_torch.dsp.loudness import integrated_loudness
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.kernels.stft import real_edges, spectrogram
from audiolab_tpu_torch.pipelines.base import (
    BaseProcessor,
    ProgressFn,
    TypedInput,
    audio_inputs,
    null_progress,
    register_processor,
)


def ms_encode(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Stereo (2, n) -> (mid, side); mono passes through as (mid, zeros)."""
    if x.ndim == 1:
        x = x[None]
    if x.shape[0] == 1:
        return x[0], np.zeros_like(x[0])
    return (x[0] + x[1]) * 0.5, (x[0] - x[1]) * 0.5


def ms_decode(mid: np.ndarray, side: np.ndarray, channels: int) -> np.ndarray:
    if channels == 1:
        return mid[None]
    return np.stack([mid + side, mid - side])


def loudest_pieces(x: np.ndarray, sr: int, piece_s: float = 1.0) -> np.ndarray:
    """Boolean mask over ~1 s pieces with RMS >= mean RMS (matchering's
    loudest-piece selection; analysis runs on these pieces only)."""
    p = max(1, int(sr * piece_s))
    n_pieces = max(1, len(x) // p)
    pieces = x[: n_pieces * p].reshape(n_pieces, p)
    rms = np.sqrt((pieces * pieces).mean(axis=1))
    return rms >= rms.mean()


def piece_rms(x: np.ndarray, sr: int, mask: np.ndarray,
              piece_s: float = 1.0) -> float:
    p = max(1, int(sr * piece_s))
    pieces = x[: len(mask) * p].reshape(len(mask), p)
    sel = pieces[mask] if mask.any() else pieces
    return float(np.sqrt((sel * sel).mean()) + 1e-12)


def _smooth_spectrum(x: torch.Tensor, n_fft: int = 4096) -> torch.Tensor:
    """Time-averaged 1/3-octave-smoothed magnitude spectrum (n_bins,)."""
    mono = x.mean(dim=0) if x.dim() == 2 else x
    spec = spectrogram(mono, n_fft=n_fft, hop=n_fft // 2, power=1.0)
    mag = spec.mean(dim=0)                                   # (n_bins,)
    # log-domain smoothing with a running boxcar ~1/3 octave:
    # np.convolve(mode="same") keeps the full convolution's centre n_bins
    n_bins = mag.shape[0]
    k = max(3, n_bins // 96)
    kern = torch.full((1, 1, k), 1.0 / k, dtype=mag.dtype, device=mag.device)
    full = F.conv1d(torch.log(mag + 1e-8)[None, None], kern, padding=k - 1)[0, 0]
    lo = (k - 1) // 2
    return torch.exp(full[lo:lo + n_bins])


def match_spectrum(target: torch.Tensor, reference: torch.Tensor,
                   n_fft: int = 4096) -> torch.Tensor:
    """EQ ``target`` (ch, n) so its smoothed spectrum matches
    ``reference``'s; fp32 on the tensors' device."""
    target, reference = target.float(), reference.float()
    ts = _smooth_spectrum(target, n_fft)
    rs = _smooth_spectrum(reference, n_fft)
    gain = torch.clamp(rs / (ts + 1e-8), 0.1, 10.0)          # (n_bins,)
    # zero-phase FIR via irfft of the gain curve, windowed
    h = torch.fft.irfft(torch.complex(gain, torch.zeros_like(gain)), n=n_fft)
    h = torch.roll(h, n_fft // 2)
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(h.device)
    h = h * win
    n = target.shape[-1]
    nfft2 = int(2 ** np.ceil(np.log2(n + n_fft)))
    H = torch.fft.rfft(h, n=nfft2)
    Y = torch.fft.rfft(target, n=nfft2) * H                  # H broadcasts over channels
    # cuFFT's real inverse reads the DC and Nyquist imaginary parts, which
    # the CPU ignores: zero them so both devices compute the same function
    Y = torch.complex(Y.real, real_edges(Y.imag, nfft2))
    return torch.fft.irfft(Y, n=nfft2)[..., n_fft // 2: n_fft // 2 + n]


def matchering_master(
    target: np.ndarray, reference: np.ndarray, sr: int,
    rms_steps: int = 4, ceiling: float = 0.985,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Full matchering pipeline on (ch, n) arrays at a common rate; the EQ
    runs on ``device`` (default the card; raises without one)."""
    dev = resolve_device(device)
    channels = target.shape[0] if target.ndim == 2 else 1
    tm, tsd = ms_encode(target)
    rm, rsd = ms_encode(reference)

    # level stage: match loudest-piece mid RMS
    t_mask = loudest_pieces(tm, sr)
    r_mask = loudest_pieces(rm, sr)
    coeff = piece_rms(rm, sr, r_mask) / piece_rms(tm, sr, t_mask)
    tm, tsd = tm * coeff, tsd * coeff

    # frequency stage: loudest pieces only, mid and side separately
    def sel(x, mask):
        p = max(1, int(sr * 1.0))
        pieces = x[: len(mask) * p].reshape(len(mask), p)
        return pieces[mask].reshape(-1) if mask.any() else x

    def eq(x, ref):
        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)[None]).to(dev)

        return match_spectrum(on(x), on(ref))[0].cpu().numpy()

    tm = eq(tm, sel(rm, r_mask))
    if channels == 2 and np.abs(rsd).max() > 1e-6 and np.abs(tsd).max() > 1e-6:
        tsd = eq(tsd, sel(rsd, r_mask))

    # iterative RMS correction after the EQ (matchering's 4 steps)
    for _ in range(rms_steps):
        c = piece_rms(rm, sr, r_mask) / piece_rms(tm, sr, loudest_pieces(tm, sr))
        if abs(1.0 - c) < 1e-3:
            break
        tm, tsd = tm * c, tsd * c

    y = ms_decode(tm, tsd, channels).astype(np.float32)
    return limiter_lookahead(y, sr, ceiling)


def limiter_lookahead(
    x: np.ndarray, sr: int, ceiling: float = 0.985,
    attack_ms: float = 1.0, release_ms: float = 60.0,
    control_block: int = 32,
) -> np.ndarray:
    """Lookahead peak limiter (matchering Hyrax role).

    Gain = ceiling / attack-smeared peak envelope with instant attack and
    exponential release, computed at a ~1.4 kHz control rate (block minima)
    and linearly interpolated back to audio rate — the recurrence runs over
    n/32 control points, so a 4-minute track limits in well under a second.
    """
    peak = np.abs(x).max(axis=0) if x.ndim == 2 else np.abs(x)
    if peak.max() <= ceiling:
        return np.asarray(x, np.float32)
    la = max(1, int(sr * attack_ms / 1000.0))
    n = len(peak)
    pad = np.concatenate([peak, np.full(la, peak[-1])])
    win = np.lib.stride_tricks.sliding_window_view(pad, la + 1)[:n]
    env = win.max(axis=1)
    need = np.minimum(1.0, ceiling / np.maximum(env, 1e-9))

    nb = -(-n // control_block)
    need_pad = np.pad(need, (0, nb * control_block - n), constant_values=1.0)
    need_c = need_pad.reshape(nb, control_block).min(axis=1)
    rel = np.exp(-control_block / (sr * release_ms / 1000.0))
    g_c = np.empty(nb)
    acc = 1.0
    for i in range(nb):
        acc = 1.0 - (1.0 - acc) * rel       # recover toward unity
        acc = min(acc, need_c[i])           # instant attack
        g_c[i] = acc
    centers = np.arange(nb) * control_block + control_block // 2
    g = np.interp(np.arange(n), centers, g_c)
    g = np.minimum(g, need)                 # never exceed the ceiling
    return (x * g).astype(np.float32)


def soft_limit(x: np.ndarray, ceiling: float = 0.985) -> np.ndarray:
    """tanh-knee brickwall at the ceiling (fallback limiter)."""
    over = np.abs(x) > ceiling * 0.9
    if not over.any():
        return x
    return np.tanh(x / ceiling) * ceiling


class Remaster(BaseProcessor):
    title = "Remaster"
    priority = 7
    description = "Master the track to match a reference recording."
    allowed_kwargs = {
        "reference_file": TypedInput(
            default=None, description="Reference track to match", type=str
        ),
        "target_lufs": TypedInput(
            default=-14.0, description="Fallback loudness when no reference given",
            type=float, ge=-36.0, le=-6.0,
        ),
        "use_source_track_as_reference": TypedInput(
            default=True,
            description="Master against the project's ORIGINAL source"
                        " track (wrappers/remaster.py:19) instead of an"
                        " uploaded reference", type=bool,
        ),
        "reference_track": TypedInput(
            default=None, description="Alias of reference_file", type=str,
        ),
    }

    def process_audio(
        self, inputs: list[ProjectFiles], callback: ProgressFn = null_progress,
        device: str | torch.device = "cuda", **kw
    ) -> list[ProjectFiles]:
        ref_path = kw.get("reference_file") or kw.get("reference_track")
        target_lufs = float(kw.get("target_lufs", -14.0))
        ref = read_audio(ref_path) if ref_path else None

        for proj in inputs:
            if (ref is None
                    and kw.get("use_source_track_as_reference", True)
                    and os.path.exists(getattr(proj, "src_file", ""))):
                ref = read_audio(proj.src_file)
            outputs = []
            stage = proj.stage_dir("remastered")
            targets = audio_inputs(proj.last_outputs)
            for i, f in enumerate(targets):
                callback(i, f"Remastering {os.path.basename(f)}", len(targets))
                a = read_audio(f)
                x = a.samples
                if ref is not None:
                    rx = ref.samples
                    if ref.sample_rate != a.sample_rate:
                        rx = resample_poly_np(rx, ref.sample_rate, a.sample_rate)
                    y = matchering_master(np.asarray(x, np.float32),
                                          np.asarray(rx, np.float32),
                                          a.sample_rate, device=device)
                else:
                    ly = integrated_loudness(x, a.sample_rate)
                    y = x * 10.0 ** ((target_lufs - ly) / 20.0) if np.isfinite(ly) else x
                    y = soft_limit(np.asarray(y, dtype=np.float32))
                base = os.path.splitext(os.path.basename(f))[0]
                out = os.path.join(stage, f"{base}_remastered.wav")
                write_audio(out, y, a.sample_rate)
                outputs.append(out)
            proj.add_output("remastered", outputs)
        return inputs


register_processor(Remaster())
