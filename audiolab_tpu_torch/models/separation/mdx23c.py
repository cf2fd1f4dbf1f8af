"""MDX23C, the TFC-TDF v3 separator (counterpart of
audiolab_tpu/models/separation/mdx23c.py).

The reference's default ensemble and its drum split run MDX23C checkpoints
(``MDX23C-8KFFT-InstVoc_HQ.ckpt``, ``MDX23C-DrumSep-aufr33-jarredou.ckpt``),
plain state dicts of ZFTurbo's ``mdx23c_tfc_tdf_v3`` network.  The modules
keep those names (``first_conv``, ``encoder_blocks.{i}.tfc_tdf.blocks.{j}``,
``encoder_blocks.{i}.downscale.{0,2}``, ``bottleneck_block``,
``decoder_blocks.{i}.upscale.{0,2}``, ``final_conv.{0,2}``);
``utils/weights.py::mdx23c_from_jax`` carries the JAX package's parameters
here.

  stereo STFT (complex as channels, dim_f bins) -> subband fold
  -> 1x1 first conv -> U-Net of TFC-TDF blocks
     (per block: 1x1 shortcut; norm, GELU, 3x3 conv; a bottleneck MLP over
      frequency as a residual; norm, GELU, 3x3 conv; + shortcut)
     with (2, 2)-strided down- and upscales and channel growth per scale
  -> multiplicative skip with the first conv's output
  -> 1x1 convs over [mix, x] -> per-instrument spectra -> unfold -> iSTFT

The U-Net runs NCHW with time as H and frequency as W, the layout of the
upstream network after its transpose; every convolution and dense layer
runs under the precision policy (core/precision.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.kernels.stft import istft, stft


@dataclass(frozen=True)
class MDX23CConfig:
    """Field names of the audio-separator / MSST yaml (audio.* and model.*);
    the defaults are MDX23C-8KFFT-InstVoc_HQ."""

    sample_rate: int = 44100
    n_fft: int = 8192
    hop_length: int = 1024
    dim_f: int = 4096            # retained freq bins
    num_channels: int = 2        # audio channels
    num_subbands: int = 4
    num_scales: int = 5
    scale: tuple[int, int] = (2, 2)   # (time, freq) stride per scale
    num_blocks_per_scale: int = 2
    channels: int = 128          # model.num_channels (base conv width)
    growth: int = 128
    bottleneck_factor: int = 4
    norm: str = "InstanceNorm"   # InstanceNorm | GroupNormN | Identity
    act: str = "gelu"
    instruments: Sequence[str] = ("Vocals", "Instrumental")
    target_instrument: str | None = None

    @property
    def num_targets(self) -> int:
        return 1 if self.target_instrument else len(self.instruments)

    @property
    def dim_c(self) -> int:
        return self.num_subbands * self.num_channels * 2


def _act(name: str) -> nn.Module:
    if name == "gelu":
        return nn.GELU()              # the exact erf form
    if name == "relu":
        return nn.ReLU()
    if name.startswith("leakyrelu"):
        return nn.LeakyReLU(float(name.replace("leakyrelu", "") or 0.01))
    raise ValueError(f"unknown act {name}")


def _norm(kind: str, c: int) -> nn.Module:
    """InstanceNorm2d(affine) is a GroupNorm with one channel per group."""
    if kind == "InstanceNorm":
        return nn.GroupNorm(c, c, eps=1e-5)
    if kind.startswith("GroupNorm"):
        return nn.GroupNorm(int(kind.replace("GroupNorm", "")), c, eps=1e-5)
    return nn.Identity()


class TFCTDFv3(nn.Module):
    """``n_blocks`` TFC-TDF blocks; the TDF's dense layers act on the last
    (frequency) axis."""

    def __init__(self, in_c: int, c: int, n_blocks: int, f: int, bn: int, norm: str, act: str):
        super().__init__()
        self.blocks = nn.ModuleList()
        for _ in range(n_blocks):
            block = nn.Module()
            block.tfc1 = nn.Sequential(_norm(norm, in_c), _act(act),
                                       precision.Conv2d(in_c, c, 3, 1, 1, bias=False))
            block.tdf = nn.Sequential(_norm(norm, c), _act(act),
                                      precision.Linear(f, f // bn, bias=False), _act(act),
                                      precision.Linear(f // bn, f, bias=False))
            block.tfc2 = nn.Sequential(_norm(norm, c), _act(act),
                                       precision.Conv2d(c, c, 3, 1, 1, bias=False))
            block.shortcut = precision.Conv2d(in_c, c, 1, 1, 0, bias=False)
            self.blocks.append(block)
            in_c = c

    def forward(self, x):
        for block in self.blocks:
            s = block.shortcut(x)
            x = block.tfc1(x)
            x = x + block.tdf(x)
            x = block.tfc2(x) + s
        return x


class TFCTDFNetV3(nn.Module):
    """audio (b, num_channels, n) -> (b, num_targets, num_channels, n); the
    frame count n // hop_length + 1 must divide by scale[0] ** num_scales."""

    def __init__(self, cfg: MDX23CConfig = MDX23CConfig()):
        super().__init__()
        c = self.cfg = cfg
        act = c.act
        l, g, bn, scale = c.num_blocks_per_scale, c.growth, c.bottleneck_factor, tuple(c.scale)
        ch, f = c.channels, c.dim_f // c.num_subbands
        self.first_conv = precision.Conv2d(c.dim_c, ch, 1, 1, 0, bias=False)
        self.encoder_blocks = nn.ModuleList()
        for _ in range(c.num_scales):
            block = nn.Module()
            block.tfc_tdf = TFCTDFv3(ch, ch, l, f, bn, c.norm, act)
            block.downscale = nn.Sequential(
                _norm(c.norm, ch), _act(act),
                precision.Conv2d(ch, ch + g, scale, scale, bias=False))
            f //= scale[1]
            ch += g
            self.encoder_blocks.append(block)
        self.bottleneck_block = TFCTDFv3(ch, ch, l, f, bn, c.norm, act)
        self.decoder_blocks = nn.ModuleList()
        for _ in range(c.num_scales):
            block = nn.Module()
            block.upscale = nn.Sequential(
                _norm(c.norm, ch), _act(act),
                precision.ConvTranspose2d(ch, ch - g, scale, scale, bias=False))
            f *= scale[1]
            ch -= g
            block.tfc_tdf = TFCTDFv3(2 * ch, ch, l, f, bn, c.norm, act)
            self.decoder_blocks.append(block)
        self.final_conv = nn.Sequential(
            precision.Conv2d(ch + c.dim_c, ch, 1, 1, 0, bias=False), _act(act),
            precision.Conv2d(ch, c.num_targets * c.dim_c, 1, 1, 0, bias=False))

    def _cac2cws(self, x):
        """(b, C, t, F) -> (b, C*k, t, F/k); channel c*k + s holds subband s,
        the frequency slice [s*F/k, (s+1)*F/k)."""
        k = self.cfg.num_subbands
        b, c, t, f = x.shape
        return x.reshape(b, c, t, k, f // k).transpose(2, 3).reshape(b, c * k, t, f // k)

    def _cws2cac(self, x):
        k = self.cfg.num_subbands
        b, c, t, f = x.shape
        return x.reshape(b, c // k, k, t, f).transpose(2, 3).reshape(b, c // k, t, k * f)

    def forward(self, audio):
        c = self.cfg
        b, ch, n = audio.shape
        n_bins = c.n_fft // 2 + 1
        re, im = stft(audio, n_fft=c.n_fft, hop=c.hop_length)     # (b, ch, T, bins)
        t_frames = re.shape[-2]
        tot = c.scale[0] ** c.num_scales
        if t_frames % tot:
            raise ValueError(
                f"{t_frames} STFT frames not divisible by {tot}; pick a "
                f"chunk with (n // hop + 1) % {tot} == 0")
        # channels packed as [c0_re, c0_im, c1_re, c1_im]
        spec = torch.stack([re, im], dim=2).reshape(b, ch * 2, t_frames, n_bins)
        mix = x = self._cac2cws(spec[..., : c.dim_f])            # (b, dim_c, t, f/k)
        first = x = self.first_conv(x)
        skips = []
        for block in self.encoder_blocks:
            x = block.tfc_tdf(x)
            skips.append(x)
            x = block.downscale(x)
        x = self.bottleneck_block(x)
        for block in self.decoder_blocks:
            x = block.upscale(x)
            x = block.tfc_tdf(torch.cat([x, skips.pop()], dim=1))
        x = self.final_conv(torch.cat([mix, x * first], dim=1))
        x = self._cws2cac(x)                                       # (b, nt*ch*2, t, dim_f)
        x = F.pad(x, (0, n_bins - c.dim_f)).reshape(b, c.num_targets, ch, 2, t_frames, n_bins)
        return istft(x[:, :, :, 0], x[:, :, :, 1], n_fft=c.n_fft, hop=c.hop_length, length=n)

    def good_length(self, seconds: float) -> int:
        """The smallest sample count >= ``seconds`` whose frame count divides
        the U-Net's total time stride."""
        c = self.cfg
        tot = c.scale[0] ** c.num_scales
        frames = math.ceil((seconds * c.sample_rate / c.hop_length + 1) / tot) * tot
        return (frames - 1) * c.hop_length
