"""Multiband spectrogram front end and windowed inference for the VR nets
(counterpart of audiolab_tpu/models/separation/vr_bands.py).

A UVR VR checkpoint reads a "combined" spectrogram stitched from per-band
STFTs of progressively downsampled audio (vocal-remover spec_utils), each
band described by a published param json; ``BAND_PARAMS`` holds the
standard sets, and any dict with the same fields works.  Everything runs in
fp32 on the separator's device: the band resampling is the port's
polyphase ``resample``, the STFTs its ``stft``/``istft``, and every
inference window goes through the net in one batched forward.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.resample import resample
from audiolab_tpu_torch.kernels.stft import istft, stft

# published vocal-remover model param sets (modelparams/*.json)
BAND_PARAMS: dict[str, dict] = {
    "1band_sr44100_hl512": {
        "bins": 1024, "sr": 44100,
        "pre_filter_start": 1023, "pre_filter_stop": 1024,
        "band": {
            1: {"sr": 44100, "hl": 512, "n_fft": 2048,
                "crop_start": 0, "crop_stop": 1024},
        },
    },
    "1band_sr44100_hl1024": {
        "bins": 1024, "sr": 44100,
        "pre_filter_start": 1023, "pre_filter_stop": 1024,
        "band": {
            1: {"sr": 44100, "hl": 1024, "n_fft": 2048,
                "crop_start": 0, "crop_stop": 1024},
        },
    },
    "4band_v3": {
        "bins": 672, "sr": 44100,
        "pre_filter_start": 668, "pre_filter_stop": 672,
        "band": {
            1: {"sr": 7350, "hl": 80, "n_fft": 640,
                "crop_start": 0, "crop_stop": 85,
                "lpf_start": 25, "lpf_stop": 53},
            2: {"sr": 7350, "hl": 80, "n_fft": 320,
                "crop_start": 4, "crop_stop": 87,
                "hpf_start": 25, "hpf_stop": 12,
                "lpf_start": 31, "lpf_stop": 62},
            3: {"sr": 14700, "hl": 160, "n_fft": 512,
                "crop_start": 17, "crop_stop": 216,
                "hpf_start": 48, "hpf_stop": 24,
                "lpf_start": 139, "lpf_stop": 210},
            4: {"sr": 44100, "hl": 480, "n_fft": 960,
                "crop_start": 78, "crop_stop": 383,
                "hpf_start": 130, "hpf_stop": 86},
        },
    },
}


def _gain(spec: torch.Tensor, g: np.ndarray) -> torch.Tensor:
    return spec * torch.from_numpy(g.astype(np.float32)).to(spec.device)[None, :, None]


def _lp_filter(spec: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """spec_utils.fft_lp_filter: linear fade start -> stop over the bins,
    zero above."""
    idx = np.arange(spec.shape[1])
    g = np.ones(spec.shape[1])
    if stop > start:
        g = np.where((idx >= start) & (idx < stop), 1.0 - (idx - start + 1) / (stop - start), g)
    g[stop:] = 0.0
    return _gain(spec, g)


def _hp_filter(spec: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """spec_utils.fft_hp_filter: fade from start down to stop, zero at and
    below stop."""
    idx = np.arange(spec.shape[1])
    g = np.ones(spec.shape[1])
    if start > stop:
        g = np.where((idx <= start) & (idx > stop), 1.0 - (start - idx + 1) / (start - stop), g)
    g[: max(stop + 1, 0)] = 0.0
    return _gain(spec, g)


def wave_to_combined_spec(audio: torch.Tensor, mp: dict) -> torch.Tensor:
    """(2, n) at mp['sr'] -> complex combined spectrogram (2, bins + 1, T)."""
    bands = mp["band"]
    n_bands = len(bands)
    specs = {}
    wave = audio.float()
    sr = mp["sr"]
    for d in range(n_bands, 0, -1):
        bp = bands[d]
        if bp["sr"] != sr:
            wave = resample(wave, sr, bp["sr"])
            sr = bp["sr"]
        re, im = stft(wave, n_fft=bp["n_fft"], hop=bp["hl"])
        specs[d] = torch.complex(re, im).transpose(1, 2)        # (2, bins, T)
    t = min(s.shape[2] for s in specs.values())
    parts = [specs[d][:, bands[d]["crop_start"]:bands[d]["crop_stop"], :t]
             for d in range(1, n_bands + 1)]
    used = sum(p.shape[1] for p in parts)
    out = torch.cat(parts + [parts[0].new_zeros((2, mp["bins"] + 1 - used, t))], dim=1)
    if mp.get("pre_filter_start", 0) > 0:
        if n_bands == 1:
            out = _lp_filter(out, mp["pre_filter_start"], mp["pre_filter_stop"])
        else:
            g = np.ones(out.shape[1])
            gp = 1.0
            for b in range(mp["pre_filter_start"] + 1, mp["pre_filter_stop"]):
                gp = g[b] = math.pow(10, -(b - mp["pre_filter_start"]) * (3.5 - gp) / 20.0)
            out = _gain(out, g)
    return out


def _band_istft(s: torch.Tensor, bp: dict) -> torch.Tensor:
    x = s.transpose(1, 2)                                       # (2, T, bins)
    return istft(x.real, x.imag, n_fft=bp["n_fft"], hop=bp["hl"],
                 length=(s.shape[2] - 1) * bp["hl"])


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = min(a.shape[-1], b.shape[-1])
    return a[..., :n] + b[..., :n]


def combined_spec_to_wave(spec: torch.Tensor, mp: dict) -> torch.Tensor:
    """complex (2, bins + 1, T) -> (2, n) at mp['sr'] (spec_utils
    cmb_spectrogram_to_wave: per-band crossover fades, upsample and sum)."""
    bands = mp["band"]
    n_bands = len(bands)
    offset = 0
    wave, sr = None, None
    for d in range(1, n_bands + 1):
        bp = bands[d]
        h = bp["crop_stop"] - bp["crop_start"]
        s = spec.new_zeros((2, bp["n_fft"] // 2 + 1, spec.shape[2]))
        s[:, bp["crop_start"]:bp["crop_stop"]] = spec[:, offset:offset + h]
        offset += h
        if d == n_bands:
            if mp.get("pre_filter_start", 0) > 0 and n_bands == 1:
                s = _lp_filter(s, mp["pre_filter_start"], mp["pre_filter_stop"])
            if "hpf_start" in bp:
                s = _hp_filter(s, bp["hpf_start"], bp["hpf_stop"] - 1)
            w = _band_istft(s, bp)
            wave = w if wave is None else _add(resample(wave, sr, bp["sr"]), w)
        elif d == 1:
            wave = _band_istft(_lp_filter(s, bp["lpf_start"], bp["lpf_stop"]), bp)
        else:
            if "hpf_start" in bp:
                s = _hp_filter(s, bp["hpf_start"], bp["hpf_stop"] - 1)
            s = _lp_filter(s, bp["lpf_start"], bp["lpf_stop"])
            wave = _add(resample(wave, sr, bp["sr"]), _band_istft(s, bp))
        sr = bp["sr"]
    return wave


class VRSeparator:
    """A VR net as a primary/complement split on one device.

    Windowed inference as in lib_v5: the net sees ``window_size``-frame
    windows and keeps each window's middle ``window_size - 2 * offset``
    frames; all windows run in one batched forward.  ``primary`` names the
    stem the mask keeps; ``aggressiveness`` raises the mask to
    1 + aggressiveness / 3 below the first band's top bin and to
    1 + aggressiveness above it."""

    def __init__(self, model: torch.nn.Module, band_params="1band_sr44100_hl1024",
                 primary: str = "primary", window_size: int = 512,
                 aggressiveness: float = 0.0, offset: int | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.mp = BAND_PARAMS[band_params] if isinstance(band_params, str) else band_params
        self.primary = primary
        self.window = window_size
        self.agg = aggressiveness
        cfg = model.cfg
        self.offset = min(cfg.offset if offset is None else offset, (window_size - 2) // 2)
        self.split_bin = self.mp["band"][1]["crop_stop"]

    def _masks(self, mag: torch.Tensor) -> torch.Tensor:
        """(2, bins, T) magnitude -> (2, output_bin, T) mask."""
        roi = self.window - 2 * self.offset
        t = mag.shape[2]
        n_win = -(-t // roi)
        pad_t = self.offset * 2 + n_win * roi - t
        x = F.pad(mag[:, : self.model.cfg.max_bin],
                                    (self.offset, pad_t - self.offset))
        wins = x.unfold(2, self.window, roi).permute(2, 0, 1, 3)   # (k, 2, bins, window)
        mask = self.model(wins)[..., self.offset:self.offset + roi]
        mask = mask.permute(1, 2, 0, 3).reshape(2, mask.shape[2], -1)[..., :t]
        if self.agg:
            mask = torch.cat([mask[:, : self.split_bin] ** (1 + self.agg / 3),
                              mask[:, self.split_bin:] ** (1 + self.agg)], dim=1)
        return mask

    @torch.inference_mode()
    def __call__(self, audio, as_numpy: bool = True) -> dict:
        """(2, n) at mp['sr'] (numpy or tensor) -> {primary, "complement"},
        each (2, n)."""
        x = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        n = x.shape[-1]
        spec = wave_to_combined_spec(x, self.mp)
        mag = spec.abs()
        coef = mag.max()
        mask = self._masks(mag / torch.where(coef > 0, coef, torch.ones_like(coef)))
        y = combined_spec_to_wave(spec * mask, self.mp)
        v = combined_spec_to_wave(spec * (1.0 - mask), self.mp)

        def fit(w):
            w = w[:, :n] if w.shape[-1] >= n else F.pad(
                w, (0, n - w.shape[-1]))
            return w.float().cpu().numpy() if as_numpy else w

        return {self.primary: fit(y), "complement": fit(v)}
