"""AutoencoderDC (DC-AE), ACE-Step's ``music_dcae_f8c8`` codec (counterpart
of audiolab_tpu/models/dcae.py; diffusers
models/autoencoders/autoencoder_dc.py and its SanaMultiscaleLinearAttention
processor), under diffusers' names and configured by its ``config.json``
(``config_from_json``).

- ``ResBlock``: conv3x3, act, conv3x3 without bias, RMSNorm (affine and
  bias), + residual.
- ``EfficientViTBlock``: multiscale ReLU linear attention (+ residual),
  then GLUMBConv (1x1 expand, SiLU, depthwise 3x3, GLU gate, 1x1 project,
  RMSNorm, + residual).
- ``DCDownBlock2d`` / ``DCUpBlock2d``: a strided conv (or conv and
  pixel-unshuffle) with a channel-averaged pixel-unshuffle shortcut; nearest
  interpolation and a conv (or conv and pixel-shuffle) with a
  channel-repeated pixel-shuffle shortcut.

Layout NCHW; for ACE-Step the mel image is (b, ch, 128 bins, T), upstream's
orientation.  The JAX module's channels-last ``pixel_(un)shuffle`` orders
channels as c * r^2 + di * r + dj, which is ``F.pixel_(un)shuffle``'s
order on NCHW, so those are used.  flax's ``nn.gelu`` (an ``act_fn`` of
"gelu") is the tanh form.  This is not the in-repo stand-in's
``DCAEConfig`` of ``models/acestep.py``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class DCAEConfig:
    """Field names and meanings of diffusers AutoencoderDC's config; the
    defaults are the f8c8 geometry."""

    in_channels: int = 2
    latent_channels: int = 8
    attention_head_dim: int = 32
    encoder_block_types: tuple = ("ResBlock", "ResBlock", "ResBlock", "EfficientViTBlock")
    encoder_block_out_channels: tuple = (128, 256, 512, 512)
    encoder_layers_per_block: tuple = (2, 2, 2, 3)
    encoder_qkv_multiscales: tuple = ((), (), (), (5,))
    decoder_block_types: tuple = ("ResBlock", "ResBlock", "ResBlock", "EfficientViTBlock")
    decoder_block_out_channels: tuple = (128, 256, 512, 512)
    decoder_layers_per_block: tuple = (3, 3, 3, 3)
    decoder_qkv_multiscales: tuple = ((), (), (), (5,))
    decoder_norm_types: tuple | str = "rms_norm"
    decoder_act_fns: tuple | str = "silu"
    downsample_block_type: str = "conv"
    upsample_block_type: str = "interpolate"
    scaling_factor: float = 1.0


def config_from_json(path: str) -> DCAEConfig:
    """A DCAEConfig from a diffusers checkpoint directory or its config.json."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        c = json.load(f)

    def tup(x):
        return tuple(tuple(v) if isinstance(v, (list, tuple)) else v for v in x)

    kw = {}
    for name in DCAEConfig.__dataclass_fields__:
        if name in c:
            v = c[name]
            kw[name] = tup(v) if isinstance(v, (list, tuple)) else v
    return DCAEConfig(**kw)


class DCRMSNorm(nn.Module):
    """diffusers RMSNorm(eps 1e-5, affine, bias) over the channel axis
    (axis 1), the variance through fp32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        var = x.float().square().mean(dim=1, keepdim=True)
        y = x * torch.rsqrt(var + self.eps).to(x.dtype)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * self.weight.view(shape) + self.bias.view(shape)


def _act(name: str):
    return {"silu": F.silu, "relu": F.relu, "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class ResBlock(nn.Module):
    def __init__(self, ch: int, out_channels: int, act_fn: str = "silu"):
        super().__init__()
        self.act = _act(act_fn)
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.conv2 = nn.Conv2d(ch, out_channels, 3, padding=1, bias=False)
        self.norm = DCRMSNorm(out_channels)

    def forward(self, x):
        return self.norm(self.conv2(self.act(self.conv1(x)))) + x


class SanaMultiscaleProjection(nn.Module):
    """A depthwise k x k conv and a 1x1 conv grouped per (head, q/k/v),
    both without bias."""

    def __init__(self, channels: int, heads: int, kernel_size: int):
        super().__init__()
        self.proj_in = nn.Conv2d(channels, channels, kernel_size, padding=kernel_size // 2,
                                 groups=channels, bias=False)
        self.proj_out = nn.Conv2d(channels, channels, 1, groups=3 * heads, bias=False)

    def forward(self, x):
        return self.proj_out(self.proj_in(x))


class SanaMultiscaleLinearAttention(nn.Module):
    """ReLU linear attention with multiscale depthwise aggregation, op for
    op: fp32 with a ones-padded value row when there are more positions
    than the head width, else the quadratic form."""

    def __init__(self, in_channels: int, out_channels: int, attention_head_dim: int = 32,
                 kernel_sizes: tuple = (5,), eps: float = 1e-15):
        super().__init__()
        self.hd, self.eps = attention_head_dim, eps
        heads = in_channels // attention_head_dim
        inner = heads * attention_head_dim
        self.to_q = nn.Linear(in_channels, inner, bias=False)
        self.to_k = nn.Linear(in_channels, inner, bias=False)
        self.to_v = nn.Linear(in_channels, inner, bias=False)
        self.to_qkv_multiscale = nn.ModuleList(SanaMultiscaleProjection(3 * inner, heads, k)
                                               for k in kernel_sizes)
        self.to_out = nn.Linear(inner * (1 + len(kernel_sizes)), out_channels, bias=False)
        self.norm_out = DCRMSNorm(out_channels)

    def forward(self, x):
        b, _, hgt, wid = x.shape
        hd = self.hd
        xl = x.permute(0, 2, 3, 1)
        qkv = torch.cat([self.to_q(xl), self.to_k(xl), self.to_v(xl)], dim=-1).permute(0, 3, 1, 2)
        h = torch.cat([qkv] + [m(qkv) for m in self.to_qkv_multiscale], dim=1)
        n = hgt * wid
        use_linear = n > hd
        if use_linear:
            h = h.float()
        h = h.reshape(b, -1, 3 * hd, n)
        query, key, value = h.split(hd, dim=2)
        query, key = F.relu(query), F.relu(key)
        if use_linear:
            value = F.pad(value, (0, 0, 0, 1), value=1.0)
            out = (value @ key.transpose(-1, -2)) @ query          # (b, G, hd + 1, n)
            out = out.float()
            out = (out[:, :, :-1] / (out[:, :, -1:] + self.eps)).to(x.dtype)
        else:
            scores = (key.transpose(-1, -2) @ query).float()      # (b, G, n, n)
            scores = scores / (scores.sum(dim=2, keepdim=True) + self.eps)
            out = value @ scores.to(value.dtype)
        out = out.reshape(b, -1, hgt, wid).permute(0, 2, 3, 1)
        out = self.norm_out(self.to_out(out).permute(0, 3, 1, 2))
        return out + x


class GLUMBConv(nn.Module):
    def __init__(self, ch: int, out_channels: int, expand_ratio: float = 4.0):
        super().__init__()
        hidden = int(expand_ratio * ch)
        self.conv_inverted = nn.Conv2d(ch, 2 * hidden, 1)
        self.conv_depth = nn.Conv2d(2 * hidden, 2 * hidden, 3, padding=1, groups=2 * hidden)
        self.conv_point = nn.Conv2d(hidden, out_channels, 1, bias=False)
        self.norm = DCRMSNorm(out_channels)

    def forward(self, x):
        h = self.conv_depth(F.silu(self.conv_inverted(x)))
        h, gate = h.chunk(2, dim=1)
        return self.norm(self.conv_point(h * F.silu(gate))) + x


class EfficientViTBlock(nn.Module):
    def __init__(self, ch: int, attention_head_dim: int = 32, qkv_multiscales: tuple = (5,)):
        super().__init__()
        self.attn = SanaMultiscaleLinearAttention(ch, ch, attention_head_dim,
                                                  tuple(qkv_multiscales))
        self.conv_out = GLUMBConv(ch, ch)

    def forward(self, x):
        return self.conv_out(self.attn(x))


def _block(block_type: str, ch: int, out_ch: int, head_dim: int, act: str, scales: tuple):
    if block_type == "ResBlock":
        return ResBlock(ch, out_ch, act)
    if block_type == "EfficientViTBlock":
        return EfficientViTBlock(ch, head_dim, scales)
    raise ValueError(block_type)


class DCDownBlock2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, downsample: bool = False,
                 shortcut: bool = True):
        super().__init__()
        self.downsample, self.shortcut = downsample, shortcut
        self.group = in_channels * 4 // out_channels
        self.conv = nn.Conv2d(in_channels, out_channels // 4 if downsample else out_channels, 3,
                              stride=1 if downsample else 2, padding=1)

    def forward(self, x):
        h = self.conv(x)
        if self.downsample:
            h = F.pixel_unshuffle(h, 2)
        if self.shortcut:
            y = F.pixel_unshuffle(x, 2)
            h = h + y.unflatten(1, (-1, self.group)).mean(dim=2)
        return h


class DCUpBlock2d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, interpolate: bool = False,
                 shortcut: bool = True):
        super().__init__()
        self.interpolate, self.shortcut = interpolate, shortcut
        self.repeats = out_channels * 4 // in_channels
        self.conv = nn.Conv2d(in_channels, out_channels if interpolate else out_channels * 4, 3,
                              padding=1)

    def forward(self, x):
        if self.interpolate:
            h = self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        else:
            h = F.pixel_shuffle(self.conv(x), 2)
        if self.shortcut:
            h = h + F.pixel_shuffle(x.repeat_interleave(self.repeats, dim=1), 2)
        return h


class DCAEEncoder(nn.Module):
    """(b, in_channels, H, W) -> (b, latent, H / f, W / f)."""

    def __init__(self, cfg: DCAEConfig = DCAEConfig()):
        super().__init__()
        c = cfg
        chans, layers = c.encoder_block_out_channels, c.encoder_layers_per_block
        n = len(chans)
        unshuffle = c.downsample_block_type == "pixel_unshuffle"
        if layers[0] > 0:
            self.conv_in = nn.Conv2d(c.in_channels, chans[0], 3, padding=1)
        else:
            self.conv_in = DCDownBlock2d(c.in_channels, chans[1], unshuffle, shortcut=False)
        blocks = []
        for i in range(n):
            stage = [_block(c.encoder_block_types[i], chans[i], chans[i], c.attention_head_dim,
                            "silu", c.encoder_qkv_multiscales[i]) for _ in range(layers[i])]
            if i < n - 1 and layers[i] > 0:
                stage.append(DCDownBlock2d(chans[i], chans[i + 1], unshuffle, shortcut=True))
            blocks.append(nn.ModuleList(stage))
        self.down_blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(chans[-1], c.latent_channels, 3, padding=1)
        self.group = chans[-1] // c.latent_channels

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            for blk in stage:
                x = blk(x)
        return self.conv_out(x) + x.unflatten(1, (-1, self.group)).mean(dim=2)


class DCAEDecoder(nn.Module):
    """(b, latent, h, w) -> (b, in_channels, h f, w f)."""

    def __init__(self, cfg: DCAEConfig = DCAEConfig()):
        super().__init__()
        c = cfg
        chans, layers = c.decoder_block_out_channels, c.decoder_layers_per_block
        n = len(chans)
        acts = (c.decoder_act_fns,) * n if isinstance(c.decoder_act_fns, str) else c.decoder_act_fns
        interp = c.upsample_block_type == "interpolate"
        self.repeats = chans[-1] // c.latent_channels
        self.conv_in = nn.Conv2d(c.latent_channels, chans[-1], 3, padding=1)
        blocks = []
        for i in range(n):
            stage = []
            if i < n - 1 and layers[i] > 0:
                stage.append(DCUpBlock2d(chans[i + 1], chans[i], interp, shortcut=True))
            stage += [_block(c.decoder_block_types[i], chans[i], chans[i], c.attention_head_dim,
                             acts[i], c.decoder_qkv_multiscales[i]) for _ in range(layers[i])]
            blocks.append(nn.ModuleList(stage))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = DCRMSNorm(chans[0])
        if layers[0] > 0:
            self.conv_out = nn.Conv2d(chans[0], c.in_channels, 3, padding=1)
        else:
            self.conv_out = DCUpBlock2d(chans[0], c.in_channels, interp, shortcut=False)

    def forward(self, z):
        x = self.conv_in(z) + z.repeat_interleave(self.repeats, dim=1)
        for stage in reversed(self.up_blocks):
            for blk in stage:
                x = blk(x)
        return self.conv_out(F.relu(self.norm_out(x)))


class AutoencoderDC(nn.Module):
    """``encoder`` and ``decoder`` under diffusers' module names."""

    def __init__(self, cfg: DCAEConfig = DCAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = DCAEEncoder(cfg)
        self.decoder = DCAEDecoder(cfg)

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x):
        return self.decode(self.encode(x))


def spatial_compression(cfg: DCAEConfig) -> int:
    n_down = len(cfg.encoder_block_out_channels) - 1
    if cfg.encoder_layers_per_block[0] == 0:
        n_down += 1
    return 2 ** n_down
