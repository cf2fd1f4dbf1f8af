"""The DAC decoder that turns Zonos's 9-codebook tokens into 44.1 kHz audio,
and the Vocos iSTFT vocoder behind ACE-Step (counterpart of
audiolab_tpu/models/codecs.py:29-41,223-360).

Parameter names are descript-audio-codec's (``quantizer.quantizers.N`` and
``decoder.model.N``), the names ``convert_dac`` maps; weight-normed
convolutions hold the folded weight as a plain ``.weight``.  The modules
work on torch's (batch, channels, time) layout; :class:`DACDecoder` takes
codes (b, n_q, t) and returns audio (b, t * hop) as the JAX package's does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.stft import istft


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation x + sin^2(alpha x) / alpha (DAC, BigVGAN), in fp32."""
    xf = x.float()
    a = alpha.float()
    return (xf + torch.sin(a * xf) ** 2 / (a + 1e-9)).to(x.dtype)


class Snake(nn.Module):
    """Snake over (b, channels, t) with a per-channel ``alpha`` (1, ch, 1)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x, self.alpha)


@dataclass(frozen=True)
class DACConfig:
    sr: int = 44100
    dim: int = 1024                 # latent width after codes projection
    rates: Sequence[int] = (8, 8, 4, 2)
    n_q: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    decoder_dim: int | None = None  # first decoder width (upstream 1536);
                                    # defaults to ``dim``

    @property
    def hop(self) -> int:
        return int(np.prod(self.rates))

    @property
    def d0(self) -> int:
        return self.decoder_dim or self.dim


class _ConvSame(nn.Conv1d):
    """flax ``Conv(padding="SAME")`` at stride 1 for an odd kernel: the same
    padding on both sides."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1):
        super().__init__(cin, cout, k, dilation=dilation, padding=(k - 1) * dilation // 2)


class _ConvTransposeSame(nn.ConvTranspose1d):
    """flax ``ConvTranspose(kernel 2r, stride r, padding="SAME")`` on the
    torch weight (in, out, k), which the converter takes with its spatial
    flip: the full transposed convolution, cropped where
    ``lax.conv_transpose`` crops (jax _conv_transpose_padding), t * r
    samples from k - 1 - ceil((k + r - 2) / 2)."""

    def __init__(self, cin: int, cout: int, rate: int):
        super().__init__(cin, cout, 2 * rate, stride=rate)
        k, s = 2 * rate, rate
        pad_a = k - 1 if s > k - 1 else int(np.ceil((k + s - 2) / 2))
        self.crop = k - 1 - pad_a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        full = F.conv_transpose1d(x, self.weight, self.bias, stride=self.stride)
        n = x.shape[-1] * self.stride[0]
        return full[..., self.crop:self.crop + n]


class DACResUnit(nn.Module):
    """Snake -> Conv(7, dilation) -> Snake -> Conv(1), residual."""

    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        self.block = nn.ModuleList([
            Snake(channels), _ConvSame(channels, channels, 7, dilation),
            Snake(channels), nn.Conv1d(channels, channels, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.block:
            h = layer(h)
        return x + h


class _DecoderBlock(nn.Module):
    """Snake -> ConvTranspose(2r, stride r) -> 3 residual units (dilations
    1, 3, 9), halving the width."""

    def __init__(self, cin: int, rate: int):
        super().__init__()
        cout = cin // 2
        self.block = nn.ModuleList([Snake(cin), _ConvTransposeSame(cin, cout, rate)]
                                   + [DACResUnit(cout, 3 ** j) for j in range(3)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.block:
            x = layer(x)
        return x


class _Quantizer(nn.Module):
    def __init__(self, cfg: DACConfig):
        super().__init__()
        self.codebook = nn.Embedding(cfg.codebook_size, cfg.codebook_dim)
        self.out_proj = nn.Conv1d(cfg.codebook_dim, cfg.dim, 1)


class DACDecoder(nn.Module):
    """Per-codebook 8-d embeddings, each through its 1x1 out_proj, summed
    (the RVQ dequantize), then Conv(7) at ``decoder_dim`` and the halving
    decoder blocks, Snake, Conv(7) to one channel and tanh."""

    def __init__(self, cfg: DACConfig = DACConfig()):
        super().__init__()
        self.cfg = cfg
        self.quantizer = nn.Module()
        self.quantizer.quantizers = nn.ModuleList(_Quantizer(cfg) for _ in range(cfg.n_q))
        ch = cfg.d0
        layers: list[nn.Module] = [_ConvSame(cfg.dim, ch, 7)]
        for r in cfg.rates:
            layers.append(_DecoderBlock(ch, r))
            ch //= 2
        layers += [Snake(ch), _ConvSame(ch, 1, 7)]
        self.decoder = nn.Module()
        self.decoder.model = nn.ModuleList(layers)

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_q, t) -> latent (b, dim, t)."""
        z = 0.0
        for qi, quant in enumerate(self.quantizer.quantizers):
            emb = quant.codebook(codes[:, qi])                      # (b, t, cdim)
            w = quant.out_proj.weight[:, :, 0]
            z = z + (emb @ w.t() + quant.out_proj.bias)
        return z.transpose(1, 2)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_q, t) -> audio (b, t * hop)."""
        h = self.dequantize(codes)
        for layer in self.decoder.model:
            h = layer(h)
        return torch.tanh(h)[:, 0]


# ------------------------------------------------------------ Vocos (iSTFT head)

@dataclass(frozen=True)
class VocosConfig:
    dim: int = 512
    n_layers: int = 8
    ffn_mult: int = 3
    n_fft: int = 1024
    hop: int = 256


class ConvNeXtBlock(nn.Module):
    """Depthwise Conv(7) -> LayerNorm (eps 1e-6) -> Linear -> tanh GELU ->
    Linear, scaled by ``gamma``, residual; on (b, t, dim)."""

    def __init__(self, dim: int, ffn_mult: int = 3):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, dim * ffn_mult)
        self.pwconv2 = nn.Linear(dim * ffn_mult, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        h = self.pwconv2(F.gelu(self.pwconv1(self.norm(h)), approximate="tanh"))
        return x + self.gamma * h


class Vocos(nn.Module):
    """ConvNeXt trunk -> (log magnitude, phase) -> ``kernels/stft.py::istft``
    (the JAX module's iDFT matmul, overlap-add and n_fft // 2 crops): latents
    (b, t, in_dim) -> audio (b, t * hop).  Names are charactr/vocos'
    (``backbone.embed``, ``backbone.norm``, ``backbone.convnext.N``,
    ``backbone.final_layer_norm``, ``head.out``), the names ``convert_vocos``
    maps.  The magnitude is exp of the log magnitude clipped at 12, then
    clipped at 1e2, as the JAX module computes it."""

    def __init__(self, cfg: VocosConfig = VocosConfig(), in_dim: int | None = None):
        super().__init__()
        c = cfg
        self.cfg = c
        self.backbone = nn.Module()
        self.backbone.embed = nn.Conv1d(in_dim or c.dim, c.dim, 7, padding=3)
        self.backbone.norm = nn.LayerNorm(c.dim, eps=1e-6)
        self.backbone.convnext = nn.ModuleList(ConvNeXtBlock(c.dim, c.ffn_mult)
                                               for _ in range(c.n_layers))
        self.backbone.final_layer_norm = nn.LayerNorm(c.dim, eps=1e-6)
        self.head = nn.Module()
        self.head.out = nn.Linear(c.dim, 2 * (c.n_fft // 2 + 1))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c, bb = self.cfg, self.backbone
        h = bb.norm(bb.embed(z.transpose(1, 2)).transpose(1, 2))
        for block in bb.convnext:
            h = block(h)
        out = self.head.out(bb.final_layer_norm(h)).float()
        logmag, phase = torch.chunk(out, 2, dim=-1)
        mag = torch.clamp(torch.exp(torch.clamp(logmag, max=12.0)), max=1e2)
        return istft(mag * torch.cos(phase), mag * torch.sin(phase), c.n_fft, c.hop,
                     center=True)
