"""Pitch shifting / time stretching (counterpart of audiolab_tpu/dsp/pitch.py),
on the input tensor's device.

The workhorse is ``pitch_shift_granular``: one pass that applies a
*per-frame* pitch ratio with windowed-grain resampling + overlap-add, so
the shift contour can vary continuously (what autotune needs).  The grains
are overlap-added with ``F.fold``, which sums each output sample's grains
in a fixed order (the JAX package scatter-adds).  A phase-vocoder
``time_stretch`` / ``pitch_shift`` pair keeps librosa's semantics.
"""

from __future__ import annotations

import numpy as np
import torch

from audiolab_tpu_torch.dsp.f0 import f0_autocorr
from audiolab_tpu_torch.dsp.silence import overlap_add
from audiolab_tpu_torch.kernels.stft import hann_window, istft, stft

_NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


def note_to_hz(note: str) -> float:
    """'A4' -> 440.0 (12-TET, A4=440)."""
    name = note[:-1]
    octave = int(note[-1])
    semis = _NOTE_NAMES.index(name) + (octave + 1) * 12  # MIDI number
    return 440.0 * 2.0 ** ((semis - 69) / 12.0)


def hz_to_note(hz: float) -> str:
    midi = int(round(69 + 12 * np.log2(max(hz, 1e-6) / 440.0)))
    return f"{_NOTE_NAMES[midi % 12]}{midi // 12 - 1}"


def autotune_f0(f0: torch.Tensor) -> torch.Tensor:
    """Snap voiced f0 values to the nearest 12-TET semitone (behavioral
    equivalent of modules/rvc/infer/lib/audio.py autotune_f0)."""
    midi = 69.0 + 12.0 * torch.log2(torch.clamp(f0, min=1e-6) / 440.0)
    snapped = 440.0 * 2.0 ** ((torch.round(midi) - 69.0) / 12.0)
    return torch.where(f0 > 1.0, snapped, f0)


def pitch_shift_granular(
    x: torch.Tensor,
    factors: torch.Tensor,
    periods: torch.Tensor | None = None,
    frame: int = 2048,
    hop: int = 512,
) -> torch.Tensor:
    """Duration-preserving, time-varying pitch shift in one device pass.

    x:       ``(n,)`` signal
    factors: ``(T,)`` per-frame pitch ratio (>1 = shift up), T = n // hop + 1
    periods: optional ``(T,)`` local pitch period in samples (sr/f0, 0 where
             unvoiced).  When given, each grain's read position is advanced
             by a period-locked offset so adjacent grains overlap in phase
             (TD-PSOLA-style); without it, plain SOLA grains carry a phase
             mismatch of hop·(1-factor) per grain which skews the output
             pitch for tonal content.

    Each output grain t re-reads the input around its own center at sample
    spacing ``factors[t]`` (local resampling ⇒ pitch scales by the factor,
    global timing unchanged), then hann-windowed grains overlap-add with
    window-sum normalization.
    """
    n = x.shape[-1]
    dev = x.device
    t_frames = n // hop + 1
    win = torch.from_numpy(hann_window(frame)).to(dev)

    centers = torch.arange(t_frames, device=dev) * hop  # grain centers in samples
    offs = torch.arange(frame, device=dev) - frame // 2
    factors = torch.clamp(factors[:t_frames].float(), 0.25, 4.0)
    if factors.shape[0] < t_frames:
        factors = torch.nn.functional.pad(factors, (0, t_frames - factors.shape[0]), value=1.0)

    if periods is not None:
        p = periods[:t_frames].float()
        # phase-continuity: delta_{t+1} - delta_t = -hop(1-f_t)  (mod period)
        drift = torch.cumsum(-hop * (1.0 - factors), dim=0)
        drift = torch.cat([drift.new_zeros(1), drift[:-1]])
        delta = torch.where(p > 0, torch.remainder(drift, torch.clamp(p, min=1e-3)), 0.0)
    else:
        delta = torch.zeros(t_frames, device=dev)

    # read positions rounded once from the exact sum (XLA contracts this to
    # an FMA; two fp32 roundings put 1 in 20 positions an ulp away)
    start = (centers + delta).double()
    pos = (start[:, None] + offs[None, :].double() * factors.double()[:, None]).float()
    pos = torch.clamp(pos, 0.0, n - 1.001)  # (T, frame)
    i0 = torch.floor(pos).long()
    frac = pos - i0
    # n - 1.001 rounds to n - 1 in fp32 once n passes 2**14: XLA clamps the read
    grains = x[i0] * (1.0 - frac) + x[(i0 + 1).clamp(max=n - 1)] * frac
    grains = grains * win[None, :]

    # grain t covers output samples t * hop - frame // 2 ... + frame
    pad_lo = frame // 2
    out = overlap_add(grains[None], hop, pad_lo + n)[0]
    wsum = overlap_add(win.expand(1, t_frames, frame), hop, pad_lo + n)[0]
    out = out / torch.where(wsum > 1e-8, wsum, 1.0)
    return out[pad_lo: pad_lo + n]


def time_stretch(x: torch.Tensor, rate: float, n_fft: int = 2048, hop: int = 512) -> torch.Tensor:
    """Phase-vocoder time stretch: output duration = input / rate.

    The output phases accumulate frame by frame in fp32 in the order of the
    JAX package's ``lax.scan`` (acc + advance, then + the wrapped phase
    difference): at 60 s they reach 1e6-1e7 rad, where a sum in another
    order moves a phase by a sizeable fraction of a radian.
    """
    real, imag = stft(x, n_fft=n_fft, hop=hop)
    mag = torch.sqrt(real * real + imag * imag + 1e-12)
    phase = torch.atan2(imag, real)
    t_in = mag.shape[-2]
    n_bins = n_fft // 2 + 1

    steps = np.arange(0, t_in, rate)
    phi_advance = torch.from_numpy(
        np.linspace(0, np.pi * hop, n_bins, dtype=np.float32)).to(x.device)

    i0 = np.clip(np.floor(steps).astype(np.int64), 0, t_in - 1)
    i1 = np.clip(i0 + 1, 0, t_in - 1)
    alpha = torch.from_numpy((steps - i0).astype(np.float32)).to(x.device)[:, None]
    i0, i1 = torch.from_numpy(i0).to(x.device), torch.from_numpy(i1).to(x.device)
    mag_out = mag[..., i0, :] * (1 - alpha) + mag[..., i1, :] * alpha

    dphase = phase[..., i1, :] - phase[..., i0, :] - phi_advance
    dphase = dphase - 2.0 * torch.pi * torch.round(dphase / (2.0 * torch.pi))

    acc = phase[..., i0[0], :]
    phases = []
    for d in dphase.unbind(dim=-2):
        phases.append(acc)
        acc = acc + phi_advance + d
    phase_out = torch.stack(phases, dim=-2)

    out_len = int(round(x.shape[-1] / rate))
    return istft(
        mag_out * torch.cos(phase_out),
        mag_out * torch.sin(phase_out),
        n_fft=n_fft,
        hop=hop,
        length=out_len,
    )


def pitch_shift(
    x: torch.Tensor, sr: int, n_steps: float, n_fft: int = 2048, hop: int = 512
) -> torch.Tensor:
    """librosa.effects.pitch_shift semantics: constant shift, same length.

    Implemented via the granular engine with period-locked grains.  Local
    periods come from the YIN tracker so tonal content stays phase-coherent
    across grains.
    """
    n = x.shape[-1]
    t_frames = n // hop + 1
    factor = 2.0 ** (float(n_steps) / 12.0)
    f0, _ = f0_autocorr(
        x, sr=sr, hop=hop, fmin=50.0, fmax=min(1100.0, sr / 4), frame_length=min(n_fft, n)
    )
    periods = torch.where(f0 > 0, sr / torch.clamp(f0, min=1e-3), 0.0)
    return pitch_shift_granular(
        x, torch.full((t_frames,), factor, device=x.device), periods=periods,
        frame=n_fft, hop=hop
    )
