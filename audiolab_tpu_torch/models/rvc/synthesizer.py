"""RVC VITS-style synthesizer with the NSF-HiFiGAN decoder, inference path
(counterpart of audiolab_tpu/models/rvc/synthesizer.py).

  TextEncoder            feature + pitch embedding -> rel-attn transformer
  ResidualCouplingBlock  mean-only coupling flows (+ flips), run in reverse
  GeneratorNSF           harmonic sine source + upsample stack + ResBlocks

Parameter names follow the upstream SynthesizerTrnMs768NSFsid checkpoints.
Entry points take the JAX package's NTC layout; inside, the convolutions run
on NCT.  Noise (flow prior and excitation) comes from an explicit
``torch.Generator``; ``generator=None`` means zero noise, like ``rng=None``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.models.layers import (
    WN,
    Conv1d,
    ConvTranspose1d,
    ResBlock1,
    TransformerEncoder,
    lrelu,
    sequence_mask,
)


@dataclass(frozen=True)
class SynthesizerConfig:
    """Mirrors the v2 48k hparams (configs/v2/48k.json)."""

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
    use_f0: bool = True
    flow_layers: int = 3

    @property
    def upp(self) -> int:
        return int(np.prod(self.upsample_rates))


def config_for(sr: int, version: str = "v2") -> SynthesizerConfig:
    """Presets matching configs/{v1,v2}/{32k,40k,48k}.json."""
    presets = {
        (48000, "v2"): dict(upsample_rates=(12, 10, 2, 2), upsample_kernel_sizes=(24, 20, 4, 4)),
        (40000, "v2"): dict(upsample_rates=(10, 10, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4)),
        (32000, "v2"): dict(upsample_rates=(10, 8, 2, 2), upsample_kernel_sizes=(20, 16, 4, 4)),
        (48000, "v1"): dict(upsample_rates=(10, 6, 2, 2, 2),
                            upsample_kernel_sizes=(16, 16, 4, 4, 4)),
        (40000, "v1"): dict(upsample_rates=(10, 10, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4)),
        (32000, "v1"): dict(upsample_rates=(10, 4, 2, 2, 2),
                            upsample_kernel_sizes=(16, 16, 4, 4, 4)),
    }
    return SynthesizerConfig(
        sr=sr, feat_channels=768 if version == "v2" else 256,
        spec_channels=1025 if sr != 32000 else 513, **presets[(sr, version)])


def _randn(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard-normal noise for the synthesizer (one place to draw it)."""
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


class TextEncoder(nn.Module):
    """Feature/pitch embedding + rel-attn encoder -> (m, logs, x_mask), NTC."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.emb_phone = precision.Linear(c.feat_channels, c.hidden_channels)
        if c.use_f0:
            self.emb_pitch = nn.Embedding(256, c.hidden_channels)
        self.encoder = TransformerEncoder(c.hidden_channels, c.filter_channels, c.n_heads,
                                          c.n_layers, c.kernel_size)
        self.proj = Conv1d(c.hidden_channels, 2 * c.inter_channels, 1)

    def forward(self, phone, pitch, lengths):
        c = self.cfg
        x = self.emb_phone(phone)
        if c.use_f0 and pitch is not None:
            x = x + self.emb_pitch(pitch)
        x = lrelu(x * np.sqrt(c.hidden_channels))
        x_mask = sequence_mask(lengths, x.shape[1])[:, None, :].to(x.dtype)   # (b,1,t)
        x = self.encoder(x.transpose(1, 2), x_mask)
        stats = self.proj(x) * x_mask
        m, logs = stats.transpose(1, 2).split(c.inter_channels, dim=-1)
        return m, logs, x_mask.transpose(1, 2)


class ResidualCouplingLayer(nn.Module):
    """Mean-only coupling layer (NCT inside)."""

    def __init__(self, channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                 gin_channels=0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers, gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1)

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=1)


class Flip(nn.Module):
    def forward(self, x):
        return torch.flip(x, [1])


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling + flip); ``flows`` interleaves them as upstream."""

    def __init__(self, cfg: SynthesizerConfig, n_flows: int = 4):
        super().__init__()
        c = cfg
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                c.inter_channels, c.hidden_channels, 5, 1, c.flow_layers, c.gin_channels))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        """x (b, t, c), x_mask (b, t, 1), g (b, 1, gin) -> (b, t, c)."""
        x, x_mask = x.transpose(1, 2), x_mask.transpose(1, 2)
        g = None if g is None else g.transpose(1, 2)
        flows = reversed(self.flows) if reverse else self.flows
        for f in flows:
            x = f(x) if isinstance(f, Flip) else f(x, x_mask, g=g, reverse=reverse)
        return x.transpose(1, 2)


def sine_source(f0: torch.Tensor, upp: int, sr: int, generator: torch.Generator | None = None,
                sine_amp: float = 0.1, noise_std: float = 0.003,
                harmonics: int = 1) -> torch.Tensor:
    """Harmonic sine excitation: f0 (b, t) Hz -> (b, t*upp, harmonics),
    phase from one fp32 cumsum, voiced/unvoiced noise mixing."""
    f0 = f0.float()
    f0_up = f0.repeat_interleave(upp, dim=-1)
    phase = torch.cumsum(f0_up / sr, dim=-1)
    h = torch.arange(1, harmonics + 1, dtype=f0.dtype, device=f0.device)
    sines = torch.sin(2.0 * np.pi * (phase[..., None] * h)) * sine_amp
    uv = (f0_up > 0.0).to(f0.dtype)[..., None]
    if generator is None:
        return sines * uv
    noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
    return sines * uv + noise_amp * _randn(sines.shape, generator, f0.device)


class SourceModuleHnNSF(nn.Module):
    def __init__(self):
        super().__init__()
        self.l_linear = precision.Linear(1, 1)


class GeneratorNSF(nn.Module):
    """NSF-HiFiGAN decoder."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.num_kernels = len(c.resblock_kernel_sizes)
        self.m_source = SourceModuleHnNSF()
        self.conv_pre = Conv1d(c.inter_channels, c.upsample_initial_channel, 7)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        n_up = len(c.upsample_rates)
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            ch = c.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(c.upsample_initial_channel // (2 ** i), ch, k, u))
            if i + 1 < n_up:
                s = int(np.prod(c.upsample_rates[i + 1:]))
                self.noise_convs.append(Conv1d(1, ch, 2 * s, stride=s, padding=s // 2))
            else:
                self.noise_convs.append(Conv1d(1, ch, 1))
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = Conv1d(ch, 1, 7, bias=False)
        if c.gin_channels:
            self.cond = Conv1d(c.gin_channels, c.upsample_initial_channel, 1)

    def forward(self, x, f0, g=None, generator=None):
        """x (b, t, inter), f0 (b, t), g (b, 1, gin) -> (b, t*upp, 1)."""
        c = self.cfg
        har = sine_source(f0, c.upp, c.sr, generator)                 # (b, n, 1)
        har = torch.tanh(self.m_source.l_linear(har)).transpose(1, 2)  # (b, 1, n)
        x = self.conv_pre(x.transpose(1, 2))
        if g is not None:
            x = x + self.cond(g.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(lrelu(x))
            src = self.noise_convs[i](har)
            m = min(x.shape[-1], src.shape[-1])
            x = x[..., :m] + src[..., :m]
            xs = None
            for j in range(self.num_kernels):
                y = self.resblocks[i * self.num_kernels + j](x)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        x = self.conv_post(lrelu(x, 0.01))     # torch's default slope here
        return torch.tanh(x).transpose(1, 2)


class SynthesizerTrn(nn.Module):
    """Synthesizer, inference path only (``infer``)."""

    def __init__(self, cfg: SynthesizerConfig):
        super().__init__()
        self.cfg = cfg
        self.enc_p = TextEncoder(cfg)
        self.dec = GeneratorNSF(cfg)
        self.flow = ResidualCouplingBlock(cfg)
        self.emb_g = nn.Embedding(cfg.spk_embed_dim, cfg.gin_channels)

    def infer(self, phone, phone_lengths, pitch, nsff0, sid,
              generator: torch.Generator | None = None, noise_scale: float = 0.66666):
        """phone (b, t, feat), pitch (b, t) int, nsff0 (b, t) Hz, sid (b,)
        -> audio (b, t * upp)."""
        g = self.emb_g(sid)[:, None, :]
        m_p, logs_p, x_mask = self.enc_p(phone, pitch, phone_lengths)
        noise = (_randn(m_p.shape, generator, m_p.device) if generator is not None
                 else torch.zeros_like(m_p))
        z_p = (m_p + torch.exp(logs_p) * noise * noise_scale) * x_mask
        z = self.flow(z_p, x_mask, g=g, reverse=True)
        o = self.dec(z * x_mask, nsff0, g=g, generator=generator)
        return o[..., 0]

    forward = infer
