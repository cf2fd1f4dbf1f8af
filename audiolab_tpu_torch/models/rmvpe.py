"""RMVPE f0 estimator (counterpart of audiolab_tpu/models/rmvpe.py).

  mel (128 bins, n_fft 1024, hop 160, 30-8000 Hz, htk, log)
  DeepUnet: 5 encoder blocks (avg-pool 2x2) + 4 intermediate + 5 decoder
  cnn 3x3 -> 3 channels, BiGRU(3*128 -> 256) -> Linear 360 -> sigmoid
  decode: local weighted average around the argmax over 20-cent bins

Layout NCHW with (batch, channels, frames, mels); parameter and buffer names
are those of the published rmvpe.pt (E2E(4, 1, (2, 2))).  BatchNorm runs
from its running statistics.  With ``dtype="bfloat16"`` (the default of
:class:`RMVPE`) the U-Net's convolutions and norms run in bf16; the cnn
head, GRU, classifier and decode stay fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.mel import mel_spectrogram

N_MELS = 128
N_CLASS = 360


def _bn(x, bn: nn.BatchNorm2d):
    """Inference BatchNorm computed in fp32, returned in x's type."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * scale
    return (x.float() * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


def _conv(x, conv: nn.Conv2d | nn.ConvTranspose2d):
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, conv.stride, conv.padding, conv.output_padding)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


class ConvBlockRes(nn.Module):
    """Two (conv 3x3, BN, ReLU) + residual; keys .conv.{0,1,3,4} [+ .shortcut]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, 1, 1, bias=False), nn.BatchNorm2d(cout), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, 1, 1, bias=False), nn.BatchNorm2d(cout), nn.ReLU())
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        c = self.conv
        y = torch.relu(_bn(_conv(x, c[0]), c[1]))
        y = torch.relu(_bn(_conv(y, c[3]), c[4]))
        return y + (_conv(x, self.shortcut) if hasattr(self, "shortcut") else x)


class ResEncoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_blocks: int, pool: bool):
        super().__init__()
        self.conv = nn.ModuleList([ConvBlockRes(cin, cout)]
                                  + [ConvBlockRes(cout, cout) for _ in range(n_blocks - 1)])
        self.pool = pool

    def forward(self, x):
        for blk in self.conv:
            x = blk(x)
        if self.pool:
            return x, F.avg_pool2d(x, 2)
        return x


class ResDecoderBlock(nn.Module):
    """ConvTranspose 3x3 stride 2 (exact 2x) + BN + ReLU, concat skip, blocks."""

    def __init__(self, cin: int, cout: int, n_blocks: int):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1, bias=False),
            nn.BatchNorm2d(cout), nn.ReLU())
        self.conv2 = nn.ModuleList([ConvBlockRes(cout * 2, cout)]
                                   + [ConvBlockRes(cout, cout) for _ in range(n_blocks - 1)])

    def forward(self, x, skip):
        x = torch.relu(_bn(_conv(x, self.conv1[0]), self.conv1[1]))
        x = torch.cat([x, skip.to(x.dtype)], dim=1)
        for blk in self.conv2:
            x = blk(x)
        return x


class _Stage(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeepUnet(nn.Module):
    def __init__(self, en_de_layers=5, inter_layers=4, n_blocks=4, en_out_channels=16,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        enc, cin, ch = [], 1, en_out_channels
        for _ in range(en_de_layers):
            enc.append(ResEncoderBlock(cin, ch, n_blocks, pool=True))
            cin, ch = ch, ch * 2
        self.encoder = _Stage(enc)
        self.encoder.bn = nn.BatchNorm2d(1)
        self.intermediate = _Stage(
            [ResEncoderBlock(cin, ch, n_blocks, pool=False)]
            + [ResEncoderBlock(ch, ch, n_blocks, pool=False) for _ in range(inter_layers - 1)])
        dec = []
        for _ in range(en_de_layers):
            dec.append(ResDecoderBlock(ch, ch // 2, n_blocks))
            ch //= 2
        self.decoder = _Stage(dec)

    def forward(self, x):
        x = _bn(x, self.encoder.bn)
        if self.dtype is not None:
            x = x.to(self.dtype)
        skips = []
        for layer in self.encoder.layers:
            skip, x = layer(x)
            skips.append(skip)
        for layer in self.intermediate.layers:
            x = layer(x)
        for i, layer in enumerate(self.decoder.layers):
            x = layer(x, skips[-1 - i])
        return x


class BiGRU(nn.Module):
    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.gru = nn.GRU(n_in, hidden, num_layers=1, batch_first=True, bidirectional=True)

    def forward(self, x):
        return self.gru(x)[0]


class E2E(nn.Module):
    """mel (b, T, 128) -> salience (b, T, 360); T padded (zeros) to a
    multiple of 2**en_de_layers inside and sliced back."""

    def __init__(self, en_de_layers=5, inter_layers=4, n_blocks=4, en_out_channels=16,
                 gru_hidden=256, dtype: str | None = None):
        super().__init__()
        self.en_de_layers = en_de_layers
        self.unet = DeepUnet(en_de_layers, inter_layers, n_blocks, en_out_channels,
                             getattr(torch, dtype) if dtype else None)
        self.cnn = nn.Conv2d(en_out_channels, 3, 3, padding=1)
        self.fc = nn.Sequential(BiGRU(3 * N_MELS, gru_hidden), nn.Linear(2 * gru_hidden, N_CLASS))

    def forward(self, mel):
        t = mel.shape[1]
        pad = (-t) % (1 << self.en_de_layers)
        x = F.pad(mel, (0, 0, 0, pad))[:, None]                # (b, 1, T, 128)
        x = self.unet(x)
        x = F.conv2d(x.float(), self.cnn.weight, self.cnn.bias, padding=1).to(mel.dtype)
        x = x.transpose(1, 2).flatten(2)                       # (b, T, 3*128), c*128+m
        x = self.fc[1](self.fc[0](x))
        return torch.sigmoid(x)[:, :t]


_CENTS = 20 * np.arange(N_CLASS) + 1997.3794084376191


def decode_f0(hidden: torch.Tensor, threshold: float = 0.03) -> torch.Tensor:
    """Salience (b, t, 360) -> f0 Hz (b, t): +-4-bin weighted average of the
    cents around the argmax, 0 where the peak is under ``threshold``."""
    cents_map = torch.from_numpy(np.pad(_CENTS, 4).astype(np.float32)).to(hidden.device)
    center = hidden.argmax(dim=-1)
    hp = F.pad(hidden, (4, 4))
    idx = center[..., None] + torch.arange(9, device=hidden.device)
    w = torch.gather(hp, -1, idx)
    c = cents_map[idx]
    cents = (w * c).sum(-1) / torch.clamp(w.sum(-1), min=1e-9)
    cents = torch.where(hidden.amax(-1) > threshold, cents, torch.zeros_like(cents))
    f0 = 10.0 * torch.pow(2.0, cents / 1200.0)
    return torch.where(cents > 0, f0, torch.zeros_like(f0))


class RMVPE(E2E):
    """16 kHz audio -> f0 at 100 frames/s.  ``dtype="bfloat16"`` is the
    reference's half-precision inference mode."""

    def __init__(self, dtype: str | None = "bfloat16", **sizes):
        super().__init__(dtype=dtype, **sizes)

    @classmethod
    def from_checkpoint(cls, path: str, device: str | torch.device = "cuda") -> "RMVPE":
        """The published rmvpe.pt (a torch state_dict) on ``device``
        (``utils/convert.load_rmvpe_checkpoint``)."""
        from audiolab_tpu_torch.utils.convert import load_rmvpe_checkpoint

        return load_rmvpe_checkpoint(path, device)

    def mel(self, audio16k: torch.Tensor) -> torch.Tensor:
        m = mel_spectrogram(audio16k, sr=16000, n_fft=1024, hop=160, n_mels=N_MELS,
                            fmin=30.0, fmax=8000.0, htk=True, norm="slaney", power=1.0)
        return torch.log(torch.clamp(m, min=1e-5))

    def infer(self, audio16k: torch.Tensor, threshold: float = 0.03) -> torch.Tensor:
        """(n,) or (b, n) -> f0 (b, t)."""
        if audio16k.dim() == 1:
            audio16k = audio16k[None]
        mel = self.mel(audio16k)
        t = mel.shape[1]
        pad = min((-t) % 32, t - 1)   # reflect-pad frames to a multiple of 32
        if pad:
            mel = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
        hidden = self(mel)[:, :t]
        return decode_f0(hidden, threshold)

    def infer_with_pitch(self, audio16k: torch.Tensor, threshold: float = 0.03,
                         f0_min: float = 50.0, f0_max: float = 1100.0) -> torch.Tensor:
        """The "rmvpe+" method: :meth:`infer` with estimates outside
        [f0_min, f0_max] set to 0 (unvoiced)."""
        f0 = self.infer(audio16k, threshold)
        return torch.where((f0 < f0_min) | (f0 > f0_max), torch.zeros_like(f0), f0)
