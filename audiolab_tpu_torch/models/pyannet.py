"""PyanNet, pyannote segmentation-3.0's model (counterpart of
audiolab_tpu/models/pyannet.py), under the checkpoint's names.

  SincNet front end: InstanceNorm over the waveform, a parametrised sinc
  band-pass filterbank (asteroid ParamSincFB: 80 filters, kernel 251,
  stride 10; learned ``low_hz_`` / ``band_hz_``), |.|, then two Conv1d(5)
  stages, each stage followed by MaxPool(3) + affine InstanceNorm +
  leaky ReLU
  -> 4-layer bidirectional LSTM (hidden 128, torch's ``nn.LSTM``)
  -> 2 leaky-ReLU Linear(128) layers
  -> classifier Linear(7) + log-softmax over the powerset classes
     {none, s0, s1, s2, s0s1, s0s2, s1s2} (3 speakers, at most 2 a frame)

The sinc filters are built in fp32 in the forward from the 160 learned
scalars, with the JAX package's numpy window and time axis, so both build
the same kernel.  Frames: stride 10 then three max-pools of 3, 270 samples
(16.875 ms at 16 kHz).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class PyanNetConfig:
    sample_rate: int = 16000
    n_filters: int = 80
    kernel_size: int = 251
    stride: int = 10
    min_low_hz: float = 50.0
    min_band_hz: float = 50.0
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_dim: int = 128
    num_classes: int = 7        # powerset(3 speakers, max 2 per frame)

    @property
    def frame_hop(self) -> int:
        return self.stride * 27  # three MaxPool(3) stages


# powerset class -> member speakers (pyannote.audio utils/powerset.py,
# combinations ordered by size then lexicographically)
POWERSET_3_2 = ((), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2))


def powerset_to_multilabel(log_probs: torch.Tensor, n_speakers: int = 3) -> torch.Tensor:
    """(..., 7) log-probs -> hard per-speaker activity (..., 3) in {0, 1}
    (Powerset.to_multilabel: argmax then class membership)."""
    mapping = np.zeros((len(POWERSET_3_2), n_speakers), np.float32)
    for ci, members in enumerate(POWERSET_3_2):
        for s in members:
            mapping[ci, s] = 1.0
    return torch.from_numpy(mapping).to(log_probs.device)[log_probs.argmax(dim=-1)]


class SincFilterbank(nn.Module):
    """asteroid ParamSincFB as pyannote's SincNet uses it: learned
    ``low_hz_`` / ``band_hz_`` -> band-pass sinc kernels, a stride-10 valid
    convolution."""

    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        c = self.cfg = cfg
        self.low_hz_ = nn.Parameter(torch.zeros(c.n_filters, 1))
        self.band_hz_ = nn.Parameter(torch.zeros(c.n_filters, 1))
        half = c.kernel_size // 2
        # the JAX package's numpy constants, the same fp32 values
        n_lin = np.linspace(0, half - 1, half, dtype=np.float32)
        window = 0.54 - 0.46 * np.cos(2 * np.pi * n_lin / c.kernel_size)
        n_ = (2 * np.pi * np.arange(-half, 0, dtype=np.float32) / c.sample_rate)[None]
        self.register_buffer("window", torch.tensor(window[None]), persistent=False)
        self.register_buffer("n_", torch.tensor(n_), persistent=False)

    def filters(self) -> torch.Tensor:
        """(n_filters, kernel_size) fp32 band-pass kernels."""
        c = self.cfg
        low = c.min_low_hz + self.low_hz_.abs()
        high = torch.clamp(low + c.min_band_hz + self.band_hz_.abs(), c.min_low_hz,
                           c.sample_rate / 2)
        band = (high - low)[:, 0]
        left = ((torch.sin(high * self.n_) - torch.sin(low * self.n_)) / (self.n_ / 2)
                ) * self.window
        center = 2 * band[:, None]
        filt = torch.cat([left, center, left.flip(1)], dim=1)
        return filt / (2 * band[:, None])

    def forward(self, x):
        """(b, 1, n) -> (b, n_filters, t)."""
        return F.conv1d(x, self.filters()[:, None, :], stride=self.cfg.stride)


class _SincEncoder(nn.Module):
    """asteroid's Encoder: holds the filterbank (the checkpoint's
    ``conv1d.0.filterbank`` names)."""

    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        self.filterbank = SincFilterbank(cfg)

    def forward(self, x):
        return self.filterbank(x)


class SincNet(nn.Module):
    def __init__(self, cfg: PyanNetConfig):
        super().__init__()
        self.wav_norm1d = nn.InstanceNorm1d(1, affine=True)
        self.conv1d = nn.ModuleList([_SincEncoder(cfg), nn.Conv1d(cfg.n_filters, 60, 5),
                                     nn.Conv1d(60, 60, 5)])
        self.norm1d = nn.ModuleList([nn.InstanceNorm1d(cfg.n_filters, affine=True),
                                     nn.InstanceNorm1d(60, affine=True),
                                     nn.InstanceNorm1d(60, affine=True)])

    def forward(self, wav):
        """(b, n) 16 kHz -> (b, t, 60)."""
        x = self.wav_norm1d(wav[:, None, :])
        for i, (conv, norm) in enumerate(zip(self.conv1d, self.norm1d)):
            x = conv(x)
            if i == 0:
                x = x.abs()
            # MaxPool(3) truncates the tail frames
            x = F.leaky_relu(norm(F.max_pool1d(x, 3, 3)), 0.01)
        return x.transpose(1, 2)


class PyanNet(nn.Module):
    def __init__(self, cfg: PyanNetConfig = PyanNetConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.sincnet = SincNet(c)
        self.lstm = nn.LSTM(60, c.lstm_hidden, num_layers=c.lstm_layers, bidirectional=True,
                            batch_first=True)
        self.linear = nn.ModuleList([nn.Linear(2 * c.lstm_hidden, c.linear_dim),
                                     nn.Linear(c.linear_dim, c.linear_dim)])
        self.classifier = nn.Linear(c.linear_dim, c.num_classes)

    def forward(self, wav):
        """(b, n) -> (b, t, num_classes) powerset log-probs."""
        x = self.lstm(self.sincnet(wav))[0]
        for lin in self.linear:
            x = F.leaky_relu(lin(x), 0.01)
        return torch.log_softmax(self.classifier(x), dim=-1)
