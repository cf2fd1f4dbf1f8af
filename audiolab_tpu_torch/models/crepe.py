"""CREPE pitch estimator (counterpart of audiolab_tpu/models/crepe.py;
reference: torchcrepe, used by the crepe/mangio-crepe f0 methods at
modules/rvc/pitch_extraction.py:88-155).

Architecture and parameter names of torchcrepe's Crepe('full'|'tiny')
(conv1..conv6, conv{i}_BN, classifier), so the published crepe.pth fills
it and the JAX package's ``convert_crepe`` reads its state_dict:

  1024-sample frames @16 kHz, per-frame mean/std normalization
  conv1 k(512,1) s4 pad(254,254) -> 5x conv k(64,1) pad(31,32)
  each: conv -> relu -> BN -> maxpool(2,1); classifier Linear -> sigmoid
  360 20-cent bins, same cents mapping as RMVPE

BatchNorm runs from its running statistics with flax's epsilon (1e-5), as
the JAX module does.  All frames of a call go through the conv stack in
batches of ``FRAME_BATCH`` (at full width conv1 alone writes 1 MB a frame).

Decode: triangle-transition Viterbi over the 360 bins (torchcrepe's default
decoder).  The forward pass is a loop over frames on the device, all rows
of the call at once (four small kernels a frame, no host sync); the
back-pointers come to the host once and the backtrack runs there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.utils.fast_init import fast_init

WINDOW = 1024
N_CLASS = 360
_CHANNELS = {
    "full": (1024, 128, 128, 128, 256, 512),
    "tiny": (128, 16, 16, 16, 32, 64),
}
_BN_EPS = 1e-5
FRAME_BATCH = 1024           # frames a call of the net takes at once


class Crepe(nn.Module):
    def __init__(self, model: str = "full"):
        super().__init__()
        self.model = model
        cin = 1
        for i, ch in enumerate(_CHANNELS[model]):
            k, s = ((512, 1), (4, 1)) if i == 0 else ((64, 1), (1, 1))
            setattr(self, f"conv{i + 1}", nn.Conv2d(cin, ch, k, stride=s))
            setattr(self, f"conv{i + 1}_BN", nn.BatchNorm2d(ch, eps=_BN_EPS))
            cin = ch
        self.classifier = nn.Linear(cin * 4, N_CLASS)

    def forward(self, frames):
        """Normalized frames (b, 1024) -> salience (b, 360).  The (k, 1)
        kernels of the checkpoint's Conv2d run as 1-d convolutions over the
        frame axis: the same sums, where cuDNN's 2-d call with (k, 1)
        kernels at full width picks algorithms several times slower that
        take tens of GB of workspace (PERF.md §6)."""
        x = frames[:, None, :]                             # (b, 1, 1024)
        for i in range(len(_CHANNELS[self.model])):
            conv = getattr(self, f"conv{i + 1}")
            x = F.pad(x, (254, 254) if i == 0 else (31, 32))
            x = torch.relu(F.conv1d(x, conv.weight[..., 0], conv.bias, stride=conv.stride[0]))
            bn = getattr(self, f"conv{i + 1}_BN")
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             False, 0.0, bn.eps)
            x = F.max_pool1d(x, 2, 2)
        # torch flattens (b, c, h, 1) -> permute -> (b, h*c): h-major
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


_CENTS = 20.0 * np.arange(N_CLASS) + 1997.3794084376191


def _transition() -> np.ndarray:
    """torchcrepe viterbi transition: triangle of width 12, row-normalized."""
    idx = np.arange(N_CLASS)
    t = np.maximum(12.0 - np.abs(idx[:, None] - idx[None, :]), 0.0)
    return t / t.sum(axis=1, keepdims=True)


def viterbi_bins(probs: torch.Tensor) -> torch.Tensor:
    """(..., t, 360) salience -> decoded bin path (..., t) via log-space
    Viterbi; every leading row decodes at once."""
    dev = probs.device
    lead, t = probs.shape[:-2], probs.shape[-2]
    p = probs.float().reshape(-1, t, N_CLASS)
    b = p.shape[0]
    log_trans = torch.from_numpy(np.log(_transition() + 1e-12).astype(np.float32)).to(dev)
    obs = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-12)
    log_obs = torch.log(obs + 1e-12)
    score = torch.full((b, N_CLASS), float(-np.log(N_CLASS)), device=dev) + log_obs[:, 0]
    ptrs = torch.empty((max(t - 1, 0), b, N_CLASS), dtype=torch.int16, device=dev)
    for i in range(1, t):
        best, ptr = (score[:, :, None] + log_trans).max(dim=1)     # over the source bin
        score = best + log_obs[:, i]
        ptrs[i - 1] = ptr
    state = score.argmax(dim=-1).cpu().numpy()
    back = ptrs.cpu().numpy()
    path = np.empty((b, t), np.int64)
    path[:, t - 1] = state
    rows = np.arange(b)
    for i in range(t - 2, -1, -1):
        state = back[i, rows, state]
        path[:, i] = state
    return torch.from_numpy(path).to(dev).reshape(*lead, t)


def bins_to_f0(bins: torch.Tensor) -> torch.Tensor:
    cents = torch.from_numpy(_CENTS.astype(np.float32)).to(bins.device)[bins]
    return 10.0 * torch.pow(2.0, cents / 1200.0)


def _medfilt3(x: torch.Tensor) -> torch.Tensor:
    p = F.pad(x[None], (1, 1), mode="replicate")[0]
    return torch.stack([p[..., :-2], p[..., 1:-1], p[..., 2:]]).median(dim=0).values


def _meanfilt3(x: torch.Tensor) -> torch.Tensor:
    p = F.pad(x[None], (1, 1), mode="replicate")[0]
    return (p[..., :-2] + p[..., 1:-1] + p[..., 2:]) / 3.0


class CrepePredictor:
    """Audio -> f0, the torchcrepe.predict flow used by the reference:
    viterbi decode, median-filtered periodicity, mean-filtered f0,
    periodicity < 0.1 -> unvoiced (pitch_extraction.py:129-155).  The net
    runs on ``device`` (default the card; raises without one); without one
    given, a ``Crepe(model)`` with weights by bench.py's rules from
    ``seed``."""

    def __init__(self, net: Crepe | None = None, model: str = "full", seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if net is None:
            with self.device:
                net = fast_init(Crepe(model), seed)
        self.net = net.to(self.device).eval()

    def _probs(self, x: torch.Tensor, hop: int, fmin: float, fmax: float) -> torch.Tensor:
        """(b, n) 16 kHz -> salience (b, t, 360), zero outside [fmin, fmax]."""
        b, n = x.shape
        t_frames = 1 + n // hop
        xp = F.pad(x, (WINDOW // 2, WINDOW // 2 + hop))
        frames = xp.unfold(-1, WINDOW, hop)[:, :t_frames].reshape(-1, WINDOW)
        mu = frames.mean(dim=-1, keepdim=True)
        sd = frames.std(dim=-1, keepdim=True)
        frames = (frames - mu) / torch.clamp(sd, min=1e-10)
        probs = torch.cat([self.net(frames[i:i + FRAME_BATCH])
                           for i in range(0, frames.shape[0], FRAME_BATCH)])
        # restrict to [fmin, fmax] bins (torchcrepe.postprocess)
        fhz = 10.0 * torch.pow(2.0, torch.from_numpy(_CENTS.astype(np.float32)).to(x.device)
                               / 1200.0)
        probs = torch.where((fhz >= fmin) & (fhz <= fmax), probs, torch.zeros_like(probs))
        return probs.reshape(b, t_frames, N_CLASS)

    def _rows(self, audio16k) -> tuple[torch.Tensor, bool]:
        x = torch.as_tensor(audio16k, dtype=torch.float32, device=self.device)
        return (x[None], True) if x.dim() == 1 else (x, False)

    @torch.inference_mode()
    def predict(self, audio16k, hop: int = 160, fmin: float = 50.0, fmax: float = 1100.0,
                threshold: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
        """(n,) or (b, n) 16 kHz audio -> (f0 (..., t), periodicity (..., t))
        on the device, t = 1 + n // hop."""
        x, single = self._rows(audio16k)
        probs = self._probs(x, hop, fmin, fmax)
        bins = viterbi_bins(probs)
        pd = torch.gather(probs, -1, bins[..., None])[..., 0]
        pd = _medfilt3(pd)
        f0 = _meanfilt3(bins_to_f0(bins))
        f0 = torch.where(pd >= threshold, f0, torch.zeros_like(f0))
        return (f0[0], pd[0]) if single else (f0, pd)

    @torch.inference_mode()
    def predict_mangio(self, audio16k, hop: int = 160, fmin: float = 50.0,
                       fmax: float = 1100.0) -> torch.Tensor:
        """The fork's "mangio-crepe" flow (pitch_extraction.py:89-127):
        0.999-quantile peak normalization, plain viterbi decode with NO
        periodicity gating or f0/pd filters, then the curve linearly
        resampled to ``n // hop`` frames with unvoiced (< 1 mHz) samples
        zeroed.  (n,) or (b, n) -> (..., n // hop) on the device."""
        x = np.asarray(audio16k.cpu() if torch.is_tensor(audio16k) else audio16k, np.float32)
        single = x.ndim == 1
        x = np.atleast_2d(x)
        q = np.quantile(np.abs(x), 0.999, axis=-1, keepdims=True)
        x = x / np.where(q > 0, q, 1.0)
        probs = self._probs(torch.from_numpy(x.astype(np.float32)).to(self.device), hop,
                            fmin, fmax)
        source = bins_to_f0(viterbi_bins(probs)).cpu().numpy().astype(np.float64)
        source[source < 0.001] = np.nan
        n = x.shape[-1]
        p_len = max(n // hop, 1)
        t = source.shape[-1]
        pos = np.arange(0, t * p_len, t) / p_len
        out = np.stack([np.nan_to_num(np.interp(pos, np.arange(t), row)) for row in source])
        f0 = torch.from_numpy(out.astype(np.float32)).to(self.device)
        return f0[0] if single else f0
