"""OpenVoice-class tone color converter (counterpart of
audiolab_tpu/models/openvoice.py; reference: modules/cloning/openvoice.py
and the vendored openvoice lib).

A VITS-style flow model converts the "tone color" of source speech to a
target speaker:

    spec(src) --posterior--> z --flow(g_src)--> z_p --flow^-1(g_tgt)--> z'
    --decoder(g_tgt)--> wav

Speaker embeddings g come from the reference encoder over a linear
spectrogram.  The posterior encoder and the flow are the RVC synthesizer's
(models/rvc/synthesizer.py); parameter names are the upstream converter
checkpoint's (openvoice_cli models.py: ``ref_enc``, ``enc_q``, ``flow``,
``dec``), so the JAX package's ``convert_openvoice`` maps a state_dict of
this module onto the flax tree.  Entry points take the JAX package's NTC
layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from audiolab_tpu_torch.models.layers import Conv1d, ConvTranspose1d, ResBlock1, lrelu
from audiolab_tpu_torch.models.rvc.synthesizer import (
    PosteriorEncoder,
    ResidualCouplingBlock,
    SynthesizerConfig,
)


@dataclass(frozen=True)
class ToneColorConfig:
    sr: int = 22050
    n_fft: int = 1024
    hop: int = 256
    spec_channels: int = 513
    inter_channels: int = 192
    hidden_channels: int = 192
    gin_channels: int = 256
    n_mels_ref: int = 80
    upsample_rates: tuple = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

    def synth_cfg(self) -> SynthesizerConfig:
        return SynthesizerConfig(
            spec_channels=self.spec_channels,
            inter_channels=self.inter_channels,
            hidden_channels=self.hidden_channels,
            gin_channels=self.gin_channels,
            upsample_rates=self.upsample_rates,
            upsample_kernel_sizes=self.upsample_kernel_sizes,
            upsample_initial_channel=self.upsample_initial_channel,
            resblock_kernel_sizes=self.resblock_kernel_sizes,
            resblock_dilation_sizes=self.resblock_dilation_sizes,
            sr=self.sr,
            # OpenVoice's flow couplings run 4 WN layers (VITS default)
            # where RVC uses 3
            flow_layers=4,
        )


class ReferenceEncoder(nn.Module):
    """Linear spectrogram (b, t, spec_channels) -> speaker embedding (b,
    gin): LayerNorm over the bins, six Conv2d(3x3, stride 2, pad 1) + ReLU,
    a channel-major flatten, a one-layer GRU whose final hidden state feeds
    ``proj`` (openvoice_cli models.py:302-366)."""

    CHANNELS = (32, 32, 64, 64, 128, 128)

    def __init__(self, gin_channels: int = 256, spec_channels: int = 513):
        super().__init__()
        self.layernorm = nn.LayerNorm(spec_channels, eps=1e-5)
        cin = 1
        convs = []
        for ch in self.CHANNELS:
            convs.append(nn.Conv2d(cin, ch, 3, stride=2, padding=1))
            cin = ch
        self.convs = nn.ModuleList(convs)
        f = spec_channels
        for _ in self.CHANNELS:
            f = (f - 1) // 2 + 1
        self.gru = nn.GRU(cin * f, 128, batch_first=True)
        self.proj = nn.Linear(128, gin_channels)

    def forward(self, spec):
        h = self.layernorm(spec)[:, None]                  # (b, 1, t, f)
        for conv in self.convs:
            h = torch.relu(conv(h))
        b, ch, t, f = h.shape
        h = h.transpose(1, 2).reshape(b, t, ch * f)        # channel-major per frame
        _, last = self.gru(h)
        return self.proj(last[0])


class HiFiGANGenerator(nn.Module):
    """Plain HiFiGAN decoder (GeneratorNSF without the harmonic source),
    NCT inside; ``forward`` takes z (b, t, inter) and g (b, gin)."""

    def __init__(self, cfg: ToneColorConfig):
        super().__init__()
        c = cfg
        self.num_kernels = len(c.resblock_kernel_sizes)
        self.conv_pre = Conv1d(c.inter_channels, c.upsample_initial_channel, 7)
        self.cond = Conv1d(c.gin_channels, c.upsample_initial_channel, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = c.upsample_initial_channel
        for u, k in zip(c.upsample_rates, c.upsample_kernel_sizes):
            self.ups.append(ConvTranspose1d(ch, ch // 2, k, u))
            ch //= 2
            for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = Conv1d(ch, 1, 7, bias=False)

    def forward(self, z, g=None):
        x = self.conv_pre(z.transpose(1, 2))
        if g is not None:
            x = x + self.cond(g[:, :, None])
        for i, up in enumerate(self.ups):
            x = up(lrelu(x))
            xs = None
            for j in range(self.num_kernels):
                y = self.resblocks[i * self.num_kernels + j](x)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        x = self.conv_post(lrelu(x, 0.01))   # upstream Generator: torch's default slope
        return torch.tanh(x)[:, 0]


class ToneColorConverter(nn.Module):
    def __init__(self, cfg: ToneColorConfig = ToneColorConfig()):
        super().__init__()
        self.cfg = cfg
        sc = cfg.synth_cfg()
        self.enc_q = PosteriorEncoder(sc)
        self.flow = ResidualCouplingBlock(sc)
        self.dec = HiFiGANGenerator(cfg)
        self.ref_enc = ReferenceEncoder(cfg.gin_channels, cfg.spec_channels)

    def extract_se(self, spec):
        """Reference linear spectrogram (b, t, bins) -> embedding (b, gin)."""
        return self.ref_enc(spec)

    def convert(self, spec, spec_lengths, g_src, g_tgt):
        """Linear spec (b, t, bins) -> converted waveform (b, t * hop); the
        posterior is taken at its mean (no noise), as the JAX ``convert``
        with ``rng=None``."""
        g_s, g_t = g_src[:, None, :], g_tgt[:, None, :]
        noise = spec.new_zeros(spec.shape[:2] + (self.cfg.inter_channels,))
        z, _, _, y_mask = self.enc_q(spec, spec_lengths, noise, g=g_s)
        z_p = self.flow(z, y_mask, g=g_s)
        z_hat = self.flow(z_p, y_mask, g=g_t, reverse=True)
        return self.dec(z_hat * y_mask, g=g_tgt)

    def forward(self, spec, spec_lengths, ref_spec_src, ref_spec_tgt):
        return self.convert(spec, spec_lengths, self.extract_se(ref_spec_src),
                            self.extract_se(ref_spec_tgt))
