"""The neural audio codecs under the audio LMs (counterpart of
audiolab_tpu/models/codecs.py): the SEANet encoder and decoder with the
residual VQ (``SoundStreamCodec``), the DAC decoder that turns Zonos's
9-codebook tokens into 44.1 kHz audio, the Vocos iSTFT vocoder behind
ACE-Step and YuE, and YuE's xcodec decode path (``XCodecDecoder``).

Parameter names are the upstream checkpoints': descript-audio-codec's
(``quantizer.quantizers.N`` and ``decoder.model.N``, the names
``convert_dac`` maps) and the xcodec checkpoint's
(``quantizer.vq.layers.N._codebook.embed``, ``fc_post2``,
``decoder_2.model.N``, the names ``xcodec_mapping`` maps); weight-normed
convolutions hold the folded weight as a plain ``.weight``.  SEANet has no
upstream checkpoint and keeps the JAX module's names.  The modules work on
torch's (batch, channels, time) layout inside; their entry points take and
return the JAX modules' shapes.
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


# ------------------------------------------------------------------ SEANet + RVQ

class CausalConv1d(nn.Module):
    """Left-padded convolution (SEANet's streaming convention): (k - 1) *
    dilation - (stride - 1) zeros on the left, then a valid convolution
    ``conv``, on (b, channels, t)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.pad = max((kernel - 1) * dilation - (stride - 1), 0)
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (self.pad, 0)))


class SEANetResUnit(nn.Module):
    """ELU -> causal Conv(3, dilation) to half the width -> ELU -> Conv(1)
    back, residual."""

    def __init__(self, features: int, dilation: int = 1):
        super().__init__()
        self.c1 = CausalConv1d(features, features // 2, 3, dilation=dilation)
        self.c2 = CausalConv1d(features // 2, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(F.elu(self.c1(F.elu(x))))


@dataclass(frozen=True)
class SEANetConfig:
    channels: int = 1
    dim: int = 512            # latent width at the bottleneck
    n_filters: int = 32
    ratios: Sequence[int] = (8, 5, 4, 2)   # upsample ratios, decoder order
    n_res: int = 1
    kernel: int = 7
    last_kernel: int = 7

    @property
    def hop(self) -> int:
        return int(np.prod(self.ratios))


class SEANetEncoder(nn.Module):
    """Audio (b, n, channels) -> latents (b, n / hop, dim): a causal
    Conv(7), per ratio (reversed) the residual units, ELU and a causal
    Conv(2r, stride r) that doubles the width, then ELU and Conv(7)."""

    def __init__(self, cfg: SEANetConfig = SEANetConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.conv_in = CausalConv1d(c.channels, c.n_filters, c.kernel)
        mult = 1
        for i, ratio in enumerate(reversed(c.ratios)):
            for j in range(c.n_res):
                self.add_module(f"res_{i}_{j}", SEANetResUnit(mult * c.n_filters, 3 ** j))
            self.add_module(f"down_{i}", CausalConv1d(mult * c.n_filters, 2 * mult * c.n_filters,
                                                      2 * ratio, stride=ratio))
            mult *= 2
        self.conv_out = CausalConv1d(mult * c.n_filters, c.dim, c.last_kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = self.conv_in(x.transpose(1, 2))
        for i in range(len(c.ratios)):
            for j in range(c.n_res):
                h = getattr(self, f"res_{i}_{j}")(h)
            h = getattr(self, f"down_{i}")(F.elu(h))
        return self.conv_out(F.elu(h)).transpose(1, 2)


class SEANetDecoder(nn.Module):
    """Latents (b, t, dim) -> audio (b, t * hop, channels): a causal Conv(7),
    per ratio ELU, flax's SAME ConvTranspose(2r, stride r) halving the width
    (``up_N``, :class:`_ConvTransposeSame`) and the residual units, then ELU
    and a causal Conv(7)."""

    def __init__(self, cfg: SEANetConfig = SEANetConfig()):
        super().__init__()
        c = self.cfg = cfg
        mult = 2 ** len(c.ratios)
        self.conv_in = CausalConv1d(c.dim, mult * c.n_filters, c.kernel)
        for i, ratio in enumerate(c.ratios):
            width = mult * c.n_filters // 2
            self.add_module(f"up_{i}", _ConvTransposeSame(mult * c.n_filters, width, ratio))
            for j in range(c.n_res):
                self.add_module(f"res_{i}_{j}", SEANetResUnit(width, 3 ** j))
            mult //= 2
        self.conv_out = CausalConv1d(mult * c.n_filters, c.channels, c.last_kernel)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = self.conv_in(z.transpose(1, 2))
        for i in range(len(c.ratios)):
            h = getattr(self, f"up_{i}")(F.elu(h))
            for j in range(c.n_res):
                h = getattr(self, f"res_{i}_{j}")(h)
        return self.conv_out(F.elu(h)).transpose(1, 2)


class ResidualVQ(nn.Module):
    """Residual vector quantizer over ``codebooks`` (n_q, K, dim).  The
    nearest code of each residual is the argmax of res . c - |c|^2 / 2 in
    fp32, the JAX module's expression (not a distance), so that near ties
    fall the same way."""

    def __init__(self, n_q: int = 8, codebook_size: int = 1024, dim: int = 512):
        super().__init__()
        self.n_q = n_q
        self.codebooks = nn.Parameter(torch.randn(n_q, codebook_size, dim) * 0.02)

    def encode(self, z: torch.Tensor, n_q: int | None = None) -> torch.Tensor:
        """(b, t, dim) -> codes (b, n_q, t), int64."""
        res = z.float()
        codes = []
        for qi in range(n_q or self.n_q):
            cb = self.codebooks[qi].float()
            score = res @ cb.t() - 0.5 * (cb * cb).sum(dim=-1)
            idx = score.argmax(dim=-1)
            res = res - cb[idx]
            codes.append(idx)
        return torch.stack(codes, dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_q, t) -> (b, t, dim)."""
        z = 0.0
        for qi in range(codes.shape[1]):
            z = z + self.codebooks[qi][codes[:, qi]]
        return z

    def forward(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(quantized latents with the straight-through gradient, codes)."""
        codes = self.encode(z)
        zq = self.decode(codes)
        return z + (zq - z).detach(), codes


@dataclass(frozen=True)
class CodecConfig:
    sr: int = 16000
    seanet: SEANetConfig = SEANetConfig()
    n_q: int = 8
    codebook_size: int = 1024

    @property
    def frame_rate(self) -> float:
        return self.sr / self.seanet.hop


class SoundStreamCodec(nn.Module):
    """SEANet encoder + residual VQ + SEANet decoder (xcodec's acoustic
    path; the semantic branch is for training only)."""

    def __init__(self, cfg: CodecConfig = CodecConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = SEANetEncoder(cfg.seanet)
        self.decoder = SEANetDecoder(cfg.seanet)
        self.rvq = ResidualVQ(cfg.n_q, cfg.codebook_size, cfg.seanet.dim)

    def encode(self, audio: torch.Tensor, n_q: int | None = None) -> torch.Tensor:
        """(b, n) -> codes (b, n_q, t)."""
        return self.rvq.encode(self.encoder(audio[..., None]), n_q)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (b, n_q, t) -> (b, n)."""
        return self.decoder(self.rvq.decode(codes))[..., 0]

    def forward(self, audio: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        zq, codes = self.rvq(self.encoder(audio[..., None]))
        return self.decoder(zq)[..., 0], codes


# ------------------------------------------------------------------ DAC decoder (Zonos / Dia)

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


def _conv_transpose_torch(cin: int, cout: int, rate: int) -> nn.ConvTranspose1d:
    """descript-audio-codec's upsampler as the xcodec checkpoint builds it:
    kernel 2r, stride r, padding ceil(r / 2), output padding r % 2, t * r
    samples for every rate.  For an even rate it crops where
    :class:`_ConvTransposeSame` does; at rate 5 it starts one sample later
    (3 against 2), so the JAX package's ``TorchConvTranspose`` and this
    module take torch's padding rather than flax's SAME."""
    return nn.ConvTranspose1d(cin, cout, 2 * rate, stride=rate,
                              padding=int(np.ceil(rate / 2)), output_padding=rate % 2)


class _DecoderBlock(nn.Module):
    """Snake -> ConvTranspose(2r, stride r) -> 3 residual units (dilations
    1, 3, 9), halving the width; the upsampler is flax's SAME one (DAC) or
    torch's padded one (``torch_padding``, xcodec)."""

    def __init__(self, cin: int, rate: int, torch_padding: bool = False):
        super().__init__()
        cout = cin // 2
        up = (_conv_transpose_torch if torch_padding else _ConvTransposeSame)(cin, cout, rate)
        self.block = nn.ModuleList([Snake(cin), up]
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


# ------------------------------------------------------------- xcodec (YuE)

@dataclass(frozen=True)
class XCodecConfig:
    """YuE's xcodec decode geometry: the RVQ over 896-d (128 acoustic + 768
    semantic), ``fc_post2`` to 128-d, the DAC-style decoder at 1024
    channels, rates (8, 5, 4, 2)."""

    n_q: int = 8
    codebook_size: int = 1024
    dim: int = 896                  # quantizer dimension D + 768
    acoustic_dim: int = 128         # fc_post2 output (decoder input)
    decoder_dim: int = 1024
    rates: Sequence[int] = (8, 5, 4, 2)

    @property
    def hop(self) -> int:
        return int(np.prod(self.rates))


class _XCodecVQ(nn.Module):
    """One quantizer layer: its codebook is the buffer ``_codebook.embed``."""

    def __init__(self, bins: int, dim: int):
        super().__init__()
        self._codebook = nn.Module()
        self._codebook.register_buffer("embed", torch.randn(bins, dim))


class XCodecDecoder(nn.Module):
    """codes (b, n_q, t) -> audio (b, t * hop): YuE's SoundStream.decode, the
    codebook rows summed, ``fc_post2``, then ``decoder_2`` (Conv(7), the
    halving blocks with torch-padded upsamplers, Snake, Conv(7) to one
    channel) with no final tanh: the vendored decoder leaves it out."""

    def __init__(self, cfg: XCodecConfig = XCodecConfig()):
        super().__init__()
        self.cfg = cfg
        self.quantizer = nn.Module()
        self.quantizer.vq = nn.Module()
        self.quantizer.vq.layers = nn.ModuleList(_XCodecVQ(cfg.codebook_size, cfg.dim)
                                                 for _ in range(cfg.n_q))
        self.fc_post2 = nn.Linear(cfg.dim, cfg.acoustic_dim)
        ch = cfg.decoder_dim
        layers: list[nn.Module] = [_ConvSame(cfg.acoustic_dim, ch, 7)]
        for r in cfg.rates:
            layers.append(_DecoderBlock(ch, r, torch_padding=True))
            ch //= 2
        layers += [Snake(ch), _ConvSame(ch, 1, 7)]
        self.decoder_2 = nn.Module()
        self.decoder_2.model = nn.ModuleList(layers)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        z = 0.0
        for qi, layer in enumerate(self.quantizer.vq.layers):
            z = z + F.embedding(codes[:, qi], layer._codebook.embed)
        h = self.fc_post2(z).transpose(1, 2)
        for layer in self.decoder_2.model:
            h = layer(h)
        return h[:, 0]
