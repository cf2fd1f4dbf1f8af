"""ADaMoS HiFiGAN V1, ACE-Step's 44.1 kHz mel vocoder, under the published
checkpoint's names (counterpart of audiolab_tpu/models/adamos_vocoder.py;
upstream acestep/music_dcae/music_vocoder.py).

A ConvNeXt backbone lifts 128-bin log-mels to 512 channels (a stem conv
with replicate padding and a channels-first LayerNorm, then stages of
depthwise ConvNeXt blocks with a layer-scale ``gamma``, each stage after
the first entered through a LayerNorm and a 1x1 conv), then a SiLU
HiFiGAN head: ``conv_pre``, transposed-conv upsamplers, SiLU ResBlock1s
averaged per stage, SiLU, ``conv_post`` and tanh.

Upstream weight-normalises ``conv_pre``, the upsamplers, the resblocks'
convolutions and ``conv_post``; here each holds its folded ``weight`` (the
JAX converter takes ``.weight`` or the ``weight_g``/``weight_v`` pair), so
a published checkpoint is folded on loading.  flax defaults mirrored:
LayerNorm eps 1e-6, the exact GELU in the blocks as the JAX module asks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.models.codecs import _ConvSame, _ConvTransposeSame


@dataclass(frozen=True)
class AdamosConfig:
    input_channels: int = 128
    depths: Sequence[int] = (3, 3, 9, 3)
    dims: Sequence[int] = (128, 256, 384, 512)
    kernel_size: int = 7
    upsample_rates: Sequence[int] = (4, 4, 2, 2, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (8, 8, 4, 4, 4, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11, 13)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 4
    num_mels: int = 512             # the head's input width (the backbone's output)
    upsample_initial_channel: int = 1024
    pre_conv_kernel_size: int = 13
    post_conv_kernel_size: int = 13


class _CNBlock(nn.Module):
    """Depthwise conv, LayerNorm, 4x MLP with the exact GELU, layer scale;
    on (b, t, c)."""

    def __init__(self, dim: int, kernel: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, kernel, padding=kernel // 2, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(h))))
        return x + self.gamma * h


class ConvNeXtBackbone(nn.Module):
    """(b, t, input_channels) -> (b, t, dims[-1])."""

    def __init__(self, cfg: AdamosConfig):
        super().__init__()
        c = cfg
        layers = [nn.Sequential(nn.Conv1d(c.input_channels, c.dims[0], 7),
                                nn.LayerNorm(c.dims[0], eps=1e-6))]
        for i in range(1, len(c.depths)):
            layers.append(nn.Sequential(nn.LayerNorm(c.dims[i - 1], eps=1e-6),
                                        nn.Conv1d(c.dims[i - 1], c.dims[i], 1)))
        self.channel_layers = nn.ModuleList(layers)
        self.stages = nn.ModuleList(
            nn.ModuleList(_CNBlock(c.dims[i], c.kernel_size) for _ in range(c.depths[i]))
            for i in range(len(c.depths)))
        self.norm = nn.LayerNorm(c.dims[-1], eps=1e-6)

    def forward(self, mel):
        stem, stem_norm = self.channel_layers[0]
        x = F.pad(mel.transpose(1, 2), (3, 3), mode="replicate")
        x = stem_norm(stem(x).transpose(1, 2))
        for i, stage in enumerate(self.stages):
            if i > 0:
                norm, proj = self.channel_layers[i]
                x = F.linear(norm(x), proj.weight[:, :, 0], proj.bias)
            for blk in stage:
                x = blk(x)
        return self.norm(x)


class _SiLUResBlock(nn.Module):
    def __init__(self, ch: int, kernel: int, dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(_ConvSame(ch, ch, kernel, d) for d in dilations)
        self.convs2 = nn.ModuleList(_ConvSame(ch, ch, kernel) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.silu(c1(F.silu(x))))
        return x


class AdamosHead(nn.Module):
    """(b, t, num_mels) -> (b, t * prod(upsample_rates))."""

    def __init__(self, cfg: AdamosConfig):
        super().__init__()
        c = cfg
        for u, k in zip(c.upsample_rates, c.upsample_kernel_sizes):
            if k != 2 * u:
                raise ValueError("the upsamplers take kernel 2 * rate")
        self.n_kernels = len(c.resblock_kernel_sizes)
        self.conv_pre = _ConvSame(c.num_mels, c.upsample_initial_channel, c.pre_conv_kernel_size)
        ups, res = [], []
        ch = c.upsample_initial_channel
        for u in c.upsample_rates:
            ups.append(_ConvTransposeSame(ch, ch // 2, u))
            ch //= 2
            res += [_SiLUResBlock(ch, rk, tuple(rd))
                    for rk, rd in zip(c.resblock_kernel_sizes, c.resblock_dilation_sizes)]
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(res)
        self.conv_post = _ConvSame(ch, 1, c.post_conv_kernel_size)

    def forward(self, x):
        x = self.conv_pre(x.transpose(1, 2))
        n = self.n_kernels
        for i, up in enumerate(self.ups):
            x = up(F.silu(x))
            xs = 0.0
            for rb in self.resblocks[i * n:(i + 1) * n]:
                xs = xs + rb(x)
            x = xs / n
        return torch.tanh(self.conv_post(F.silu(x)))[:, 0]


class AdamosVocoder(nn.Module):
    """log-mel (b, t, 128) -> waveform (b, t * 512) at 44.1 kHz."""

    def __init__(self, cfg: AdamosConfig = AdamosConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ConvNeXtBackbone(cfg)
        self.head = AdamosHead(cfg)

    def forward(self, mel):
        return self.head(self.backbone(mel.float()))
