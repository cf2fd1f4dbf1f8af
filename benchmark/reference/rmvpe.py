"""RMVPE (E2E(4, 1, (2, 2)) of the published rmvpe.pt, yxlllc/RMVPE) in
plain fp32 PyTorch under its parameter and buffer names: log-mel (128 bins,
n_fft 1024, hop 160, 30-8000 Hz, htk), the deep U-Net with inference batch
norms, the cnn head, a BiGRU, the 360-class sigmoid and the +-4-bin local
average decode.  Every convolution and linear layer goes through
``precision``; the GRU is torch's."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import dsp, precision

CENTS = 20 * np.arange(360) + 1997.3794084376191


def _bn(x, bn):
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return x * scale[:, None, None] + (bn.bias - bn.running_mean * scale)[:, None, None]


def _conv(x, conv):
    if isinstance(conv, nn.ConvTranspose2d):
        return precision.conv_transpose2d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                                          conv.output_padding)
    return precision.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)


class Block(nn.Module):
    def __init__(self, cin, cout):
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


class Encoder(nn.Module):
    def __init__(self, cin, cout, n):
        super().__init__()
        self.conv = nn.ModuleList([Block(cin, cout)] + [Block(cout, cout) for _ in range(n - 1)])

    def forward(self, x):
        for b in self.conv:
            x = b(x)
        return x


class Decoder(nn.Module):
    def __init__(self, cin, cout, n):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1, bias=False),
            nn.BatchNorm2d(cout), nn.ReLU())
        self.conv2 = nn.ModuleList([Block(2 * cout, cout)]
                                   + [Block(cout, cout) for _ in range(n - 1)])

    def forward(self, x, skip):
        x = torch.cat([torch.relu(_bn(_conv(x, self.conv1[0]), self.conv1[1])), skip], dim=1)
        for b in self.conv2:
            x = b(x)
        return x


class RMVPE(nn.Module):
    def __init__(self, levels=5, inter=4, n_blocks=4, ch0=16, hidden=256):
        super().__init__()
        self.levels = levels
        self.unet = nn.Module()
        self.unet.encoder = nn.Module()
        enc, cin, ch = [], 1, ch0
        for _ in range(levels):
            enc.append(Encoder(cin, ch, n_blocks))
            cin, ch = ch, 2 * ch
        self.unet.encoder.layers = nn.ModuleList(enc)
        self.unet.encoder.bn = nn.BatchNorm2d(1)
        self.unet.intermediate = nn.Module()
        self.unet.intermediate.layers = nn.ModuleList(
            [Encoder(cin, ch, n_blocks)] + [Encoder(ch, ch, n_blocks) for _ in range(inter - 1)])
        dec = []
        for _ in range(levels):
            dec.append(Decoder(ch, ch // 2, n_blocks))
            ch //= 2
        self.unet.decoder = nn.Module()
        self.unet.decoder.layers = nn.ModuleList(dec)
        self.cnn = nn.Conv2d(ch0, 3, 3, padding=1)
        gru = nn.Module()
        gru.gru = nn.GRU(3 * 128, hidden, batch_first=True, bidirectional=True)
        self.fc = nn.Sequential(gru, nn.Linear(2 * hidden, 360))

    def salience(self, mel):
        """(b, T, 128) log-mel -> (b, T, 360)."""
        t = mel.shape[1]
        x = F.pad(mel, (0, 0, 0, (-t) % (1 << self.levels)))[:, None]
        x = _bn(x, self.unet.encoder.bn)
        skips = []
        for layer in self.unet.encoder.layers:
            skip = layer(x)
            skips.append(skip)
            x = F.avg_pool2d(skip, 2)
        for layer in self.unet.intermediate.layers:
            x = layer(x)
        for i, layer in enumerate(self.unet.decoder.layers):
            x = layer(x, skips[-1 - i])
        x = precision.conv2d(x, self.cnn.weight, self.cnn.bias, 1, 1)
        x = x.transpose(1, 2).flatten(2)
        x = self.fc[0].gru(x)[0]
        x = precision.linear(x, self.fc[1].weight, self.fc[1].bias)
        return torch.sigmoid(x)[:, :t]

    def hidden(self, wav16):
        """(b, n) 16 kHz -> salience (b, 1 + n // 160, 360)."""
        m = dsp.mel(wav16, 16000, 1024, 160, 128, 30.0, 8000.0, htk=True)
        mel = torch.log(torch.clamp(m, min=1e-5))
        t = mel.shape[1]
        pad = min((-t) % 32, t - 1)
        if pad:
            mel = F.pad(mel.transpose(1, 2), (0, pad), mode="reflect").transpose(1, 2)
        return self.salience(mel)[:, :t]

    def f0(self, wav16, threshold: float = 0.03):
        """(b, n) 16 kHz -> f0 Hz (b, 1 + n // 160), 0 where unvoiced."""
        return decode(self.hidden(wav16), threshold)


def decode(hidden, threshold: float = 0.03):
    """Salience (b, t, 360) -> f0 Hz (b, t): the cents of the +-4 bins
    around the argmax, weighted by their salience; 0 where the peak is under
    ``threshold``."""
    hidden = hidden.float()
    cents_map = torch.from_numpy(np.pad(CENTS, 4).astype(np.float32)).to(hidden.device)
    centre = hidden.argmax(-1)
    idx = centre[..., None] + torch.arange(9, device=hidden.device)
    w = torch.gather(F.pad(hidden, (4, 4)), -1, idx)
    cents = (w * cents_map[idx]).sum(-1) / torch.clamp(w.sum(-1), min=1e-9)
    cents = torch.where(hidden.amax(-1) > threshold, cents, torch.zeros_like(cents))
    f = 10.0 * torch.pow(2.0, cents / 1200.0)
    return torch.where(cents > 0, f, torch.zeros_like(f))
