"""AudioSR-class super-resolution training (counterpart of
audiolab_tpu/train/super_res.py; reference wrappers/super_res.py:42-50: a
pretrained diffusion model upscales to 48 kHz; here the model trains in the
package instead).

As in AudioSR, the diffusion enhancer (WaveGrad) is conditioned on the mel
of a band-limited version of the segment and denoises toward the fullband
waveform; the cutoff is drawn per batch (2-12 kHz) so one model serves any
input bandwidth.  Training reuses the WaveTransfer loop (Adam, EMA,
checkpoints, cancellation) through its ``segment_gen`` hook; inference plugs
the EMA weights into pipelines/super_res.make_wavegrad_enhancer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from audiolab_tpu_torch.core.audio_io import read_audio
from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.train.wavetransfer import (
    CancellationToken,
    WTConfig,
    _mel_of,
    load_ema,
    train_model,
)


@dataclass
class SRTrainConfig:
    wt: WTConfig = field(default_factory=lambda: WTConfig(sr=48000))
    cutoff_lo_hz: float = 2000.0
    cutoff_hi_hz: float = 12000.0


def band_limit(wav: np.ndarray, sr: int, cutoff_hz: float) -> np.ndarray:
    """Brickwall FFT low-pass (the degradation AudioSR trains against); host
    numpy."""
    spec = np.fft.rfft(wav, axis=-1)
    freqs = np.fft.rfftfreq(wav.shape[-1], 1.0 / sr)
    return np.fft.irfft(np.where(freqs <= cutoff_hz, spec, 0.0),
                        wav.shape[-1], axis=-1).astype(np.float32)


def _pair_batches(files: list[str], cfg: SRTrainConfig, rng: np.random.Generator,
                  device: torch.device):
    """Yields (fullband audio (b, n), band-limited mel (b, t, n_mels)) on
    ``device``; the batches and cutoffs are the JAX package's for the same
    ``rng``."""
    wt = cfg.wt
    seg = wt.seg_frames * wt.model.hop
    tracks = []
    for f in files:
        a = read_audio(f)
        x = a.samples.mean(axis=0) if a.samples.ndim == 2 else a.samples
        if a.sample_rate != wt.sr:
            x = resample_poly_np(np.asarray(x, np.float32), a.sample_rate, wt.sr)
        if len(x) >= seg:
            tracks.append(np.asarray(x, np.float32))
    if not tracks:
        raise ValueError("no usable training audio (all shorter than one "
                         f"segment of {seg} samples)")
    while True:
        full = np.stack([
            t[(s := rng.integers(0, len(t) - seg + 1)): s + seg]
            for t in (tracks[i] for i in rng.integers(0, len(tracks), wt.batch_size))
        ])
        cut = float(rng.uniform(cfg.cutoff_lo_hz, cfg.cutoff_hi_hz))
        low = torch.from_numpy(band_limit(full, wt.sr, cut)).to(device)
        yield torch.from_numpy(full).to(device), _mel_of(low, wt)


def train_superres(
    data_dir: str,
    cfg: SRTrainConfig | None = None,
    token: CancellationToken | None = None,
    callback=None,
    device: str | torch.device = "cuda",
) -> dict:
    """Train the enhancer on every audio file under ``data_dir`` on
    ``device`` (default the card); checkpoints land in ``data_dir``/ckpt
    (resumable)."""
    cfg = cfg or SRTrainConfig()
    dev = resolve_device(device)
    files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir)
                   if f.lower().endswith((".wav", ".flac")))
    gen = _pair_batches(files, cfg, np.random.default_rng(0), dev)
    return train_model(data_dir, cfg.wt, token, callback, segment_gen=gen, device=dev)


def load_enhancer(data_dir: str, cfg: SRTrainConfig | None = None, schedule=None,
                  device: str | torch.device = "cuda"):
    """The newest checkpoint's EMA weights -> an ``enhancer_fn`` for
    super_resolve, on ``device``."""
    from audiolab_tpu_torch.pipelines.super_res import make_wavegrad_enhancer

    cfg = cfg or SRTrainConfig()
    model = load_ema(os.path.join(data_dir, "ckpt"), cfg.wt.model, device)
    return make_wavegrad_enhancer(model, cfg.wt, schedule=schedule)
