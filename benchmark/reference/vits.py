"""RVC v2's VITS synthesizer with the NSF-HiFiGAN decoder
(SynthesizerTrnMs768NSFsid), its multi-period discriminator and the GAN
losses, in plain fp32 PyTorch under the upstream checkpoint names (weight
norm folded into plain weights).  Every convolution and product goes
through ``precision``.  Noise is drawn from the caller's ``torch.Generator``
in the order the published module draws it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import precision

SLOPE = 0.1


@dataclass(frozen=True)
class Config:
    """configs/v2/48k.json."""

    spec_channels: int = 1025
    segment_size: int = 17280
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (12, 10, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (24, 20, 4, 4)
    spk_embed_dim: int = 109
    gin_channels: int = 256
    sr: int = 48000
    feat_channels: int = 768
    flow_layers: int = 3

    @property
    def upp(self) -> int:
        return int(np.prod(self.upsample_rates))


def lrelu(x, slope: float = SLOPE):
    return F.leaky_relu(x, slope)


def mask_of(lengths, t):
    return torch.arange(t, device=lengths.device)[None] < lengths[:, None]


def conv(cin, cout, k=1, stride=1, dilation=1, bias=True, padding=None):
    pad = (k * dilation - dilation) // 2 if padding is None else padding
    return precision.Conv1d(cin, cout, k, stride=stride, padding=pad, dilation=dilation,
                            bias=bias)


class LayerNorm(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(ch))
        self.beta = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.layer_norm(x.transpose(1, -1), (x.shape[1],), self.gamma, self.beta,
                            1e-5).transpose(1, -1)


class RelAttention(nn.Module):
    """VITS multi-head attention with windowed relative positions (k = 10)."""

    def __init__(self, ch, heads, window=10):
        super().__init__()
        self.ch, self.heads, self.window = ch, heads, window
        d = ch // heads
        self.conv_q, self.conv_k, self.conv_v, self.conv_o = (conv(ch, ch) for _ in range(4))
        self.emb_rel_k = nn.Parameter(torch.zeros(1, 2 * window + 1, d))
        self.emb_rel_v = nn.Parameter(torch.zeros(1, 2 * window + 1, d))

    def _rel(self, emb, t):
        pad = max(t - (self.window + 1), 0)
        start = max((self.window + 1) - t, 0)
        if pad:
            emb = F.pad(emb, (0, 0, pad, pad))
        return emb[:, start:start + 2 * t - 1]

    def forward(self, x, mask):
        b, _, t = x.shape
        h, d = self.heads, self.ch // self.heads

        def split(z):
            return z.reshape(b, h, d, t).transpose(2, 3)

        q, k, v = split(self.conv_q(x)), split(self.conv_k(x)), split(self.conv_v(x))
        s = precision.einsum("bhqd,bhkd->bhqk", q, k) / d ** 0.5
        rel = precision.einsum("bhqd,xmd->bhqm", q, self._rel(self.emb_rel_k, t)) / d ** 0.5
        # relative (t, 2t-1) -> absolute (t, t): entry (i, j) is rel (i, j - i + t - 1)
        rel = F.pad(rel, (0, 1)).reshape(b, h, 2 * t * t)
        rel = F.pad(rel, (0, t - 1)).reshape(b, h, t + 1, 2 * t - 1)[:, :, :t, t - 1:]
        s = torch.where(mask, s + rel, torch.full_like(s, -1e4))
        p = torch.softmax(s, dim=-1)
        out = precision.einsum("bhqk,bhkd->bhqd", p, v)
        pr = F.pad(p, (0, t - 1)).reshape(b, h, t * (2 * t - 1))
        pr = F.pad(pr, (t, 0)).reshape(b, h, t, 2 * t)[:, :, :, 1:]
        out = out + precision.einsum("bhqm,xmd->bhqd", pr, self._rel(self.emb_rel_v, t))
        return self.conv_o(out.transpose(2, 3).reshape(b, self.ch, t))


class FFN(nn.Module):
    def __init__(self, ch, filt, k):
        super().__init__()
        self.conv_1, self.conv_2 = conv(ch, filt, k), conv(filt, ch, k)

    def forward(self, x, m):
        return self.conv_2(torch.relu(self.conv_1(x * m)) * m) * m


class Encoder(nn.Module):
    def __init__(self, ch, filt, heads, layers, k):
        super().__init__()
        self.attn_layers = nn.ModuleList([RelAttention(ch, heads) for _ in range(layers)])
        self.norm_layers_1 = nn.ModuleList([LayerNorm(ch) for _ in range(layers)])
        self.ffn_layers = nn.ModuleList([FFN(ch, filt, k) for _ in range(layers)])
        self.norm_layers_2 = nn.ModuleList([LayerNorm(ch) for _ in range(layers)])

    def forward(self, x, m):
        amask = (m[:, :, :, None] * m[:, :, None, :]) > 0
        x = x * m
        for a, n1, f, n2 in zip(self.attn_layers, self.norm_layers_1, self.ffn_layers,
                                self.norm_layers_2):
            x = n1(x + a(x * m, amask))
            x = n2(x + f(x, m))
        return x * m


class WN(nn.Module):
    def __init__(self, h, k, rate, layers, gin):
        super().__init__()
        self.h, self.layers = h, layers
        if gin:
            self.cond_layer = conv(gin, 2 * h * layers)
        self.in_layers = nn.ModuleList([conv(h, 2 * h, k, dilation=rate ** i)
                                        for i in range(layers)])
        self.res_skip_layers = nn.ModuleList([conv(h, 2 * h if i < layers - 1 else h)
                                              for i in range(layers)])

    def forward(self, x, m, g=None):
        h = self.h
        out = torch.zeros_like(x)
        ga = self.cond_layer(g) if g is not None else None
        for i in range(self.layers):
            xi = self.in_layers[i](x)
            if ga is not None:
                xi = xi + ga[:, 2 * h * i:2 * h * (i + 1)]
            rs = self.res_skip_layers[i](torch.tanh(xi[:, :h]) * torch.sigmoid(xi[:, h:]))
            if i < self.layers - 1:
                x = (x + rs[:, :h]) * m
                out = out + rs[:, h:]
            else:
                out = out + rs
        return out * m


class ResBlock(nn.Module):
    def __init__(self, ch, k, dils):
        super().__init__()
        self.convs1 = nn.ModuleList([conv(ch, ch, k, dilation=d) for d in dils])
        self.convs2 = nn.ModuleList([conv(ch, ch, k) for _ in dils])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(lrelu(c1(lrelu(x))))
        return x


class TextEncoder(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.c = c
        self.emb_phone = precision.Linear(c.feat_channels, c.hidden_channels)
        self.emb_pitch = nn.Embedding(256, c.hidden_channels)
        self.encoder = Encoder(c.hidden_channels, c.filter_channels, c.n_heads, c.n_layers,
                               c.kernel_size)
        self.proj = conv(c.hidden_channels, 2 * c.inter_channels)

    def forward(self, phone, pitch, lengths):
        c = self.c
        x = lrelu((self.emb_phone(phone) + self.emb_pitch(pitch)) * np.sqrt(c.hidden_channels))
        m = mask_of(lengths, x.shape[1])[:, None].float()
        stats = self.proj(self.encoder(x.transpose(1, 2), m)) * m
        mean, logs = stats.transpose(1, 2).split(c.inter_channels, dim=-1)
        return mean, logs, m.transpose(1, 2)


class Coupling(nn.Module):
    def __init__(self, ch, h, k, layers, gin):
        super().__init__()
        self.half = ch // 2
        self.pre = conv(self.half, h)
        self.enc = WN(h, k, 1, layers, gin)
        self.post = conv(h, self.half)

    def forward(self, x, m, g, reverse):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        mean = self.post(self.enc(self.pre(x0) * m, m, g)) * m
        x1 = (x1 - mean) * m if reverse else (mean + x1) * m
        return torch.cat([x0, x1], dim=1)


class Flow(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(4):
            self.flows.append(Coupling(c.inter_channels, c.hidden_channels, 5, c.flow_layers,
                                       c.gin_channels))
            self.flows.append(nn.Identity())      # the upstream Flip, which has no weights

    def forward(self, x, m, g, reverse=False):
        x, m, g = x.transpose(1, 2), m.transpose(1, 2), g.transpose(1, 2)
        for f in (reversed(self.flows) if reverse else self.flows):
            x = torch.flip(x, [1]) if isinstance(f, nn.Identity) else f(x, m, g, reverse)
        return x.transpose(1, 2)


class Decoder(nn.Module):
    """NSF-HiFiGAN."""

    def __init__(self, c: Config):
        super().__init__()
        self.c = c
        self.m_source = nn.Module()
        self.m_source.l_linear = precision.Linear(1, 1)
        self.conv_pre = conv(c.inter_channels, c.upsample_initial_channel, 7)
        self.ups, self.noise_convs, self.resblocks = nn.ModuleList(), nn.ModuleList(), \
            nn.ModuleList()
        rates = list(c.upsample_rates)
        for i, (u, k) in enumerate(zip(rates, c.upsample_kernel_sizes)):
            cin, ch = c.upsample_initial_channel // 2 ** i, c.upsample_initial_channel // 2 ** (i + 1)
            self.ups.append(precision.ConvTranspose1d(cin, ch, k, u, padding=(k - u) // 2))
            if i + 1 < len(rates):
                s = int(np.prod(rates[i + 1:]))
                self.noise_convs.append(conv(1, ch, 2 * s, stride=s, padding=s // 2))
            else:
                self.noise_convs.append(conv(1, ch, 1))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(ResBlock(ch, rk, tuple(rd)))
        self.conv_post = conv(ch, 1, 7, bias=False)
        self.cond = conv(c.gin_channels, c.upsample_initial_channel)

    def forward(self, x, f0, g, noise):
        """x (b, t, inter), f0 (b, t) Hz, g (b, 1, gin), ``noise`` the
        excitation's standard normals (b, t * upp, 1) or None -> (b, t * upp)."""
        c = self.c
        f0_up = f0.float().repeat_interleave(c.upp, dim=-1)
        sine = torch.sin(2.0 * np.pi * torch.cumsum(f0_up / c.sr, dim=-1))[..., None] * 0.1
        uv = (f0_up > 0).float()[..., None]
        har = sine * uv
        if noise is not None:
            har = har + (uv * 0.003 + (1.0 - uv) * 0.1 / 3.0) * noise
        har = torch.tanh(self.m_source.l_linear(har)).transpose(1, 2)
        x = self.conv_pre(x.transpose(1, 2)) + self.cond(g.transpose(1, 2))
        n = len(c.resblock_kernel_sizes)
        for i, up in enumerate(self.ups):
            x = up(lrelu(x))
            src = self.noise_convs[i](har)
            t = min(x.shape[-1], src.shape[-1])
            x = x[..., :t] + src[..., :t]
            x = sum(self.resblocks[i * n + j](x) for j in range(n)) / n
        return torch.tanh(self.conv_post(lrelu(x, 0.01)))[:, 0]


class Posterior(nn.Module):
    def __init__(self, c: Config):
        super().__init__()
        self.inter = c.inter_channels
        self.pre = conv(c.spec_channels, c.hidden_channels)
        self.enc = WN(c.hidden_channels, 5, 1, 16, c.gin_channels)
        self.proj = conv(c.hidden_channels, 2 * c.inter_channels)

    def forward(self, y, lengths, noise, g):
        m = mask_of(lengths, y.shape[1])[:, None].float()
        h = self.enc(self.pre(y.transpose(1, 2)) * m, m, g.transpose(1, 2))
        mean, logs = (self.proj(h) * m).transpose(1, 2).split(self.inter, dim=-1)
        m = m.transpose(1, 2)
        return (mean + noise * torch.exp(logs)) * m, mean, logs, m


def segments(x, starts, seg):
    """x (b, t, c), starts (b,) -> (b, seg, c), each start clamped to [0, t - seg]."""
    s = torch.clamp(starts.long(), 0, x.shape[1] - seg)
    idx = s[:, None] + torch.arange(seg, device=x.device)[None]
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


class Synthesizer(nn.Module):
    def __init__(self, c: Config, posterior: bool = False):
        super().__init__()
        self.c = c
        self.enc_p = TextEncoder(c)
        self.dec = Decoder(c)
        self.flow = Flow(c)
        if posterior:
            self.enc_q = Posterior(c)
        self.emb_g = nn.Embedding(c.spk_embed_dim, c.gin_channels)

    def infer(self, phone, lengths, pitch, f0, sid, generator, noise_scale=0.66666):
        """The deployment path; the prior's and the excitation's normals are
        drawn from ``generator``, in that order."""
        g = self.emb_g(sid)[:, None]
        m_p, logs_p, m = self.enc_p(phone, pitch, lengths)
        noise = torch.randn(m_p.shape, generator=generator, device=m_p.device)
        z = self.flow((m_p + torch.exp(logs_p) * noise * noise_scale) * m, m, g, reverse=True)
        exc = torch.randn((f0.shape[0], f0.shape[1] * self.c.upp, 1), generator=generator,
                          device=f0.device)
        return self.dec(z * m, f0, g, exc)

    def forward(self, phone, phone_lengths, pitch, pitchf, y, y_lengths, sid, draws):
        """The training path; ``draws`` = (posterior normals (b, t, inter),
        segment starts (b,), excitation normals (b, segment, 1))."""
        c = self.c
        posterior, starts, sine = draws
        g = self.emb_g(sid)[:, None]
        m_p, logs_p, _ = self.enc_p(phone, pitch, phone_lengths)
        z, m_q, logs_q, y_mask = self.enc_q(y, y_lengths, posterior, g)
        z_p = self.flow(z, y_mask, g)
        frames = c.segment_size // c.upp
        ids = starts % torch.clamp(y_lengths - frames, min=1)
        o = self.dec(segments(z, ids, frames), segments(pitchf[..., None], ids, frames)[..., 0],
                     g, sine)
        return o, ids, y_mask, (z_p, m_p, logs_p, logs_q)


# ---------------------------------------------------------------- discriminator

class DiscP(nn.Module):
    def __init__(self, period):
        super().__init__()
        self.period = period
        ch = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [nn.Conv2d(a, b, (5, 1), (3, 1), padding=(2, 0)) for a, b in zip(ch[:-1], ch[1:])]
            + [nn.Conv2d(1024, 1024, (5, 1), 1, padding=(2, 0))])
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x):
        b, c, n = x.shape
        p = self.period
        if n % p:
            x = F.pad(x, (0, p - n % p), mode="reflect")
        x = x.view(b, c, -1, p)
        fmaps = []
        for cv in self.convs:
            x = lrelu(precision.conv2d(x, cv.weight, cv.bias, cv.stride, cv.padding))
            fmaps.append(x)
        cp = self.conv_post
        x = precision.conv2d(x, cp.weight, cp.bias, cp.stride, cp.padding)
        fmaps.append(x)
        return x.flatten(1), fmaps


class DiscS(nn.Module):
    SPECS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16), (1024, 41, 4, 64),
             (1024, 41, 4, 256), (1024, 5, 1, 1))

    def __init__(self):
        super().__init__()
        cs, cin = [], 1
        for co, k, s, g in self.SPECS:
            cs.append(precision.Conv1d(cin, co, k, s, padding=k // 2, groups=min(g, cin)))
            cin = co
        self.convs = nn.ModuleList(cs)
        self.conv_post = precision.Conv1d(1024, 1, 3, 1, padding=1)

    def forward(self, x):
        fmaps = []
        for cv in self.convs:
            x = lrelu(cv(x))
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.flatten(1), fmaps


class MPD(nn.Module):
    def __init__(self, periods=(2, 3, 5, 7, 11, 17, 23, 37)):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscS()] + [DiscP(p) for p in periods])

    def forward(self, y, y_hat):
        outs = [d(y[:, None]) for d in self.discriminators], \
            [d(y_hat[:, None]) for d in self.discriminators]
        return ([o for o, _ in outs[0]], [o for o, _ in outs[1]],
                [f for _, f in outs[0]], [f for _, f in outs[1]])


# ---------------------------------------------------------------- losses

def d_loss(real, fake):
    return sum(torch.mean((1.0 - r) ** 2) + torch.mean(f ** 2) for r, f in zip(real, fake))


def g_adv_loss(fake):
    return sum(torch.mean((1.0 - f) ** 2) for f in fake)


def fm_loss(real_maps, fake_maps):
    return 2.0 * sum(torch.mean(torch.abs(r - f))
                     for rs, fs in zip(real_maps, fake_maps) for r, f in zip(rs, fs))


def kl_loss(z_p, logs_q, m_p, logs_p, mask):
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * mask) / torch.sum(mask)
