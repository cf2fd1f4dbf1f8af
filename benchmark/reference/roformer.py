"""Band-Split RoFormer (lucidrains/BS-RoFormer, the published
``model_bs_roformer_ep_368_sdr_12.9628`` layout) in plain fp32 PyTorch.

The parameter names are the checkpoints', so the same weights fill this and
the program.  Attention is plain softmax attention, every product goes
through ``precision`` (fp32, or the control's lower format); the STFT, the
complex mask and the inverse STFT are fp32.  Departures from upstream: the
GELU is the tanh form and the rotary pairs are interleaved, as the
checkpoints run in the repository's models.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import dsp, precision

BANDS = (2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8 + (128,) + (129,)


@dataclass(frozen=True)
class Config:
    dim: int = 512
    depth: int = 12
    heads: int = 8
    dim_head: int = 64
    stems: Sequence[str] = ("vocals",)
    residual_stem: str | None = "other"
    freqs_per_bands: Sequence[int] = BANDS
    n_fft: int = 2048
    hop: int = 512
    channels: int = 2
    ff_mult: int = 4
    mask_est_depth: int = 2


def attention(q, k, v):
    """Plain softmax attention over (b, h, t, d), fp32."""
    s = precision.einsum("bhqd,bhkd->bhqk", q, k) * (q.shape[-1] ** -0.5)
    p = torch.softmax(s.float(), dim=-1)
    return precision.einsum("bhqk,bhkd->bhqd", p, v)


def rope(x):
    """Interleaved-pair rotary embedding over axis -2."""
    t, d = x.shape[-2], x.shape[-1]
    freqs = 1.0 / (10000.0 ** (np.arange(0, d // 2, dtype=np.float32) / (d // 2)))
    ang = np.arange(t)[:, None] * freqs[None, :]
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(x.device)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(x.device)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


class RMSNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        n = torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-12)
        return x / n * (x.shape[-1] ** 0.5) * self.gamma


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim, bias=False))

    def forward(self, x):
        b, t, _ = x.shape
        h, d = self.heads, self.dim_head
        x = self.norm(x)
        qkv = precision.linear(x, self.to_qkv.weight)
        q, k, v = (z.reshape(b, t, h, d).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
        o = attention(rope(q), rope(k), v)
        gates = torch.sigmoid(precision.linear(x, self.to_gates.weight, self.to_gates.bias))
        o = (o * gates.transpose(1, 2)[..., None]).transpose(1, 2).reshape(b, t, h * d)
        return precision.linear(o, self.to_out[0].weight)


class FeedForward(nn.Module):
    def __init__(self, dim, mult):
        super().__init__()
        self.net = nn.Sequential(RMSNorm(dim), nn.Linear(dim, dim * mult),
                                 nn.GELU(approximate="tanh"), nn.Identity(),
                                 nn.Linear(dim * mult, dim), nn.Identity())

    def forward(self, x):
        a, b = self.net[1], self.net[4]
        x = F.gelu(precision.linear(self.net[0](x), a.weight, a.bias), approximate="tanh")
        return precision.linear(x, b.weight, b.bias)


class Transformer(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([Attention(c.dim, c.heads, c.dim_head),
                                                    FeedForward(c.dim, c.ff_mult)])])
        self.norm = RMSNorm(c.dim)

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return self.norm(x)


def _band_bins(c: Config) -> list[list[int]]:
    out, s = [], 0
    for w in c.freqs_per_bands:
        out.append(list(range(s, s + w)))
        s += w
    return out


class BSRoformer(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.cfg = c
        ch2 = 2 * c.channels
        self.bins = _band_bins(c)
        widths = [len(b) * ch2 for b in self.bins]
        self.band_split = nn.Module()
        self.band_split.to_features = nn.ModuleList([
            nn.Sequential(RMSNorm(w), nn.Linear(w, c.dim)) for w in widths])
        self.layers = nn.ModuleList([nn.ModuleList([Transformer(c), Transformer(c)])
                                     for _ in range(c.depth)])
        self.final_norm = RMSNorm(c.dim)

        def mlp(w):
            dims = (c.dim,) + (4 * c.dim,) * c.mask_est_depth + (2 * w,)
            mods = []
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                mods.append(nn.Linear(a, b))
                if i < len(dims) - 2:
                    mods.append(nn.Tanh())
            return nn.Sequential(nn.Sequential(*mods), nn.GLU(dim=-1))

        self.mask_estimators = nn.ModuleList()
        for _ in c.stems:
            est = nn.Module()
            est.to_freqs = nn.ModuleList([mlp(w) for w in widths])
            self.mask_estimators.append(est)

    def forward(self, audio):
        """audio (b, channels, n) -> {stem: (b, channels, n)}."""
        c = self.cfg
        b, ch, n = audio.shape
        re, im = dsp.stft(audio, c.n_fft, c.hop)                  # (b, ch, t, f)
        t, f = re.shape[-2:]
        spec = torch.stack([re, im], -1).permute(0, 2, 3, 1, 4).reshape(b, t, f, 2 * ch)
        feats = []
        for bins, layer in zip(self.bins, self.band_split.to_features):
            x = spec[:, :, bins].reshape(b, t, -1)
            feats.append(precision.linear(layer[0](x), layer[1].weight, layer[1].bias))
        x = torch.stack(feats, dim=2)                             # (b, t, bands, dim)
        nb = x.shape[2]
        for time_tf, band_tf in self.layers:
            xt = time_tf(x.permute(0, 2, 1, 3).reshape(b * nb, t, c.dim))
            x = xt.reshape(b, nb, t, c.dim).permute(0, 2, 1, 3)
            x = band_tf(x.reshape(b * t, nb, c.dim)).reshape(b, t, nb, c.dim)
        x = self.final_norm(x)
        out, total = {}, 0.0
        for stem, est in zip(c.stems, self.mask_estimators):
            masks = []
            for i, (bins, net) in enumerate(zip(self.bins, est.to_freqs)):
                h = x[:, :, i]
                mods = list(net[0])
                for m in mods:
                    h = precision.linear(h, m.weight, m.bias) if isinstance(m, nn.Linear) \
                        else torch.tanh(h)
                masks.append(F.glu(h, dim=-1).reshape(b, t, len(bins), 2 * ch))
            mask = torch.cat(masks, dim=2)                        # (b, t, f, 2ch)
            s = spec.reshape(b, t, f, ch, 2)
            m = mask.reshape(b, t, f, ch, 2)
            mre = s[..., 0] * m[..., 0] - s[..., 1] * m[..., 1]
            mim = s[..., 0] * m[..., 1] + s[..., 1] * m[..., 0]
            wav = dsp.istft(mre.permute(0, 3, 1, 2), mim.permute(0, 3, 1, 2), c.n_fft, c.hop, n)
            out[stem] = wav
            total = total + wav
        if c.residual_stem is not None:
            out[c.residual_stem] = audio - total
        return out
