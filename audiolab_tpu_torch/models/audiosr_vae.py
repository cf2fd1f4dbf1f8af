"""AudioSR's mel VAE, stable diffusion's AutoencoderKL (counterpart of
audiolab_tpu/models/audiosr_vae.py; upstream: the audiosr wheel's
latent_diffusion/modules/diffusionmodules/model.py:45-690 and
latent_encoder/autoencoder.py:16-120 at the shipped 48k config: ch 128,
ch_mult (1, 2, 4, 8), 2 res blocks, no per-level attention, a vanilla
attention block in the middle, z 16, double_z).

Works on torch's layout, the upstream one: the fbank is (b, 1, t, mel) and
the latents (b, 16, t/8, mel/8) (the 8x downsample applies to both axes).
Parameter names are the upstream ``first_stage_model`` ones
(``encoder.down.L.block.B``, ``encoder.down.L.downsample.conv``,
``encoder.mid.{block_1,attn_1,block_2}``, ``decoder.up.L.{block.B,
upsample.conv}``, ``quant_conv``, ``post_quant_conv``), which
``convert_audiosr_vae`` maps.  ``encode`` returns (mean, logvar) after
``quant_conv``; ``decode`` maps latents through ``post_quant_conv``.

The middle attention is single-head plain fp32 ops.  Everything is fp32,
and on the card TF32 is off (core/precision.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-6)


def _conv3(inp: int, out: int) -> nn.Conv2d:
    return nn.Conv2d(inp, out, 3, padding=1)


class ResnetBlock(nn.Module):
    """model.py ResnetBlock (temb_ch=0): GN-silu-conv3 twice + nin shortcut."""

    def __init__(self, inp: int, out: int):
        super().__init__()
        self.norm1 = _gn(inp)
        self.conv1 = _conv3(inp, out)
        self.norm2 = _gn(out)
        self.conv2 = _conv3(out, out)
        if inp != out:
            self.nin_shortcut = nn.Conv2d(inp, out, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """model.py AttnBlock: single-head 1x1-projected softmax attention over
    the (t, mel) grid, residual."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _gn(ch)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q, k, v = (f(h).reshape(b, c, hh * ww) for f in (self.q, self.k, self.v))
        w = torch.softmax(torch.einsum("bci,bcj->bij", q, k) * c ** -0.5, dim=-1)
        o = torch.einsum("bij,bcj->bci", w, v).reshape(b, c, hh, ww)
        return x + self.proj_out(o)


class _Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        # torch's asymmetric pad (0, 1, 0, 1), then a VALID stride-2 conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = _conv3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, in_channels: int = 1):
        super().__init__()
        self.conv_in = _conv3(in_channels, ch)
        self.down = nn.ModuleList()
        inp = ch
        for li, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(inp, ch * mult))
                inp = ch * mult
            if li != len(ch_mult) - 1:
                level.downsample = _Downsample(inp)
            self.down.append(level)
        self.mid = _Mid(inp)
        self.norm_out = _gn(inp)
        self.conv_out = _conv3(inp, 2 * z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for block in level.block:
                h = block(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, out_ch: int = 1):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = _conv3(z_channels, block_in)
        self.mid = _Mid(block_in)
        levels = []
        for li in reversed(range(len(ch_mult))):
            level = nn.Module()
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, ch * ch_mult[li]))
                block_in = ch * ch_mult[li]
            if li != 0:
                level.upsample = _Upsample(block_in)
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)          # indexed by level, as upstream
        self.norm_out = _gn(block_in)
        self.conv_out = _conv3(block_in, out_ch)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AudioSRVAE(nn.Module):
    """AutoencoderKL: ``encode`` -> (mean, logvar) after quant_conv; ``decode``
    maps latents through post_quant_conv (autoencoder.py:54-120)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, z_channels: int = 16, embed_dim: int = 16):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, z_channels)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    def encode(self, fbank):
        """(b, 1, t, mel) -> (mean, logvar), each (b, embed_dim, t/8, mel/8)."""
        return self.quant_conv(self.encoder(fbank)).chunk(2, dim=1)

    def decode(self, z):
        """(b, embed_dim, t/8, mel/8) -> (b, 1, t, mel)."""
        return self.decoder(self.post_quant_conv(z))

    def forward(self, fbank):
        mean, _ = self.encode(fbank)
        return self.decode(mean)
