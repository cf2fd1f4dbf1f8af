"""Harmony recreation (counterpart of audiolab_tpu/dsp/harmony.py;
reference: handlers/harmony.py:56-113).

Pipeline parity: estimate the background track's pitch contour, pick a
representative note per fixed window, then pitch-shift the main vocal toward
each window's note relative to a C4 reference.  The per-window
librosa.pitch_shift host loop (:92-109) is one ``pitch_shift_granular``
pass with a piecewise-constant factor contour; the resampling, YIN and the
shift run on ``device``, the note picking on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.dsp.f0 import f0_autocorr
from audiolab_tpu_torch.dsp.pitch import hz_to_note, note_to_hz, pitch_shift_granular
from audiolab_tpu_torch.kernels.resample import resample


def detect_chord_notes(
    f0: np.ndarray, sr: int, hop: int, window_sec: float = 1.0
) -> list[str | None]:
    """Median voiced pitch per window -> note name (handlers/harmony.py:23-46)."""
    frames_per_sec = sr / hop
    wsize = int(window_sec * frames_per_sec)
    notes: list[str | None] = []
    for i in range(0, len(f0), wsize):
        window = f0[i: i + wsize]
        voiced = window[window > 0]
        notes.append(hz_to_note(float(np.median(voiced))) if len(voiced) else None)
    return notes


def recreate_harmonies(
    background: np.ndarray,
    main_vocal: np.ndarray,
    sr: int,
    hop_length: int = 512,
    window_sec: float = 1.0,
    ref_note: str = "C4",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Shift the main vocal toward the background's windowed chord notes;
    the signal work on ``device`` (default the card; raises without one)."""
    dev = resolve_device(device)
    bg = np.asarray(background, dtype=np.float32)
    main = np.asarray(main_vocal, dtype=np.float32)
    if bg.ndim == 2:
        bg = bg.mean(axis=0)
    if main.ndim == 2:
        main = main.mean(axis=0)

    bg16 = resample(torch.from_numpy(bg).to(dev), sr, 16000)
    f0, _ = f0_autocorr(bg16, sr=16000, hop=160, fmin=note_to_hz("C2"), fmax=note_to_hz("C7"))
    # express f0 frames back in source-rate hop units for windowing parity
    notes = detect_chord_notes(f0.cpu().numpy(), 16000, 160, window_sec)

    ref_hz = note_to_hz(ref_note)
    out_hop = 512
    t_out = main.shape[-1] // out_hop + 1
    factors = np.ones(t_out, dtype=np.float32)
    seg_frames = int(window_sec * sr / out_hop)
    for i, note in enumerate(notes):
        if note is None:
            continue
        factor = note_to_hz(note) / ref_hz
        i0 = i * seg_frames
        factors[i0: i0 + seg_frames] = np.clip(factor, 0.25, 4.0)

    # main-vocal periods for phase-locked grains
    main_t = torch.from_numpy(main).to(dev)
    mf0, _ = f0_autocorr(resample(main_t, sr, 16000), sr=16000, hop=160)
    mf0 = mf0.cpu().numpy()
    idx = np.clip(
        np.round(np.arange(t_out) * out_hop / sr * 100).astype(int), 0, len(mf0) - 1
    )
    f0_out = mf0[idx]
    periods = np.where(f0_out > 0, sr / np.maximum(f0_out, 1e-3), 0.0).astype(np.float32)
    return pitch_shift_granular(
        main_t, torch.from_numpy(factors).to(dev), periods=torch.from_numpy(periods).to(dev),
        hop=out_hop).cpu().numpy()
