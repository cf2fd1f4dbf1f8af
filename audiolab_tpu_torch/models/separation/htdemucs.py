"""HTDemucs, the hybrid transformer Demucs v4 (counterpart of
audiolab_tpu/models/separation/htdemucs.py).

The reference's multistem path runs ``htdemucs_6s`` (facebookresearch/demucs
v4).  The modules keep that checkpoint's state_dict names
(``encoder.{i}.conv``, ``tencoder.{i}.dconv.layers.{d}.{j}``,
``decoder.{j}.conv_tr``, ``crosstransformer.layers{,_t}.{idx}.self_attn``,
``freq_emb.embedding.weight``, ...); ``utils/weights.py::htdemucs_from_jax``
carries the JAX package's parameters here.

Graph (the htdemucs defaults: depth 4, channels 48, growth 2, nfft 4096,
complex-as-channels, a DConv in each encoder, 512 bottom channels, five
cross-transformer layers):

  spectral branch: normalised STFT -> (b, 4, 2048, T) -> 4 HEncLayers over
    the frequency axis (k 8, s 4, DConv, GLU rewrite), a scaled frequency
    embedding after the first
  time branch: the waveform -> 4 one-dimensional HEncLayers (k 8, s 4)
  cross transformer: both branches as token sequences with 2-d / 1-d
    sinusoidal positions, layers alternating self- and cross-attention
  decoders with skips -> spectra (iSTFT) + the time branch

Activations are NCHW (spectral, H = frequency) and NCT (time).  Every
convolution, dense layer and attention product runs under the precision
policy (core/precision.py); the attention is the JAX module's plain softmax
attention, not a kernel (the JAX model calls none there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.kernels.stft import hann_window, real_edges, stft


@dataclass(frozen=True)
class HTDemucsConfig:
    sources: Sequence[str] = ("drums", "bass", "other", "vocals",
                              "guitar", "piano")  # htdemucs_6s
    audio_channels: int = 2
    channels: int = 48
    growth: int = 2
    nfft: int = 4096
    depth: int = 4
    kernel_size: int = 8
    stride: int = 4
    time_stride: int = 2
    context: int = 1
    context_enc: int = 0
    norm_starts: int = 4
    norm_groups: int = 4
    dconv_depth: int = 2
    dconv_comp: int = 8
    bottom_channels: int = 512
    t_layers: int = 5
    t_heads: int = 8
    t_hidden_scale: float = 4.0
    t_max_period: float = 10000.0
    t_weight_pos_embed: float = 1.0
    freq_emb_scale: float = 0.2
    emb_scale: float = 10.0
    segment_seconds: float = 7.8    # htdemucs training segment (Fraction 39/5)
    samplerate: int = 44100

    @property
    def hop(self) -> int:
        return self.nfft // 4


class LayerScale(nn.Module):
    """A learned per-channel scale (checkpoint name ``.scale``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(channels))

    def forward(self, x, channel_last: bool = False):
        return self.scale * x if channel_last else self.scale[:, None] * x


def _norm(groups: int, channels: int, norm: bool) -> nn.Module:
    return nn.GroupNorm(groups, channels, eps=1e-5) if norm else nn.Identity()


class DConv(nn.Module):
    """demucs.py DConv: ``depth`` residual branches of dilated conv ->
    GroupNorm(1) -> GELU -> 1x1 -> GroupNorm(1) -> GLU -> LayerScale, NCT."""

    def __init__(self, channels: int, compress: int = 8, depth: int = 2):
        super().__init__()
        hidden = int(channels / compress)
        self.layers = nn.ModuleList()
        for d in range(depth):
            dil = 2 ** d
            self.layers.append(nn.Sequential(
                precision.Conv1d(channels, hidden, 3, dilation=dil, padding=dil),
                nn.GroupNorm(1, hidden, eps=1e-5), nn.GELU(),
                precision.Conv1d(hidden, 2 * channels, 1),
                nn.GroupNorm(1, 2 * channels, eps=1e-5), nn.GLU(1),
                LayerScale(channels)))

    def forward(self, x):
        for layer in self.layers:
            x = x + layer(x)
        return x


class HEncLayer(nn.Module):
    """hdemucs.py HEncLayer: (b, c, f, t) spectral or (b, c, t) time."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8, stride: int = 4,
                 freq: bool = True, norm: bool = False, norm_groups: int = 4,
                 context: int = 0, dconv_depth: int = 2, dconv_comp: int = 8):
        super().__init__()
        pad = kernel_size // 4
        self.freq, self.stride = freq, stride
        k = 1 + 2 * context
        if freq:
            self.conv = precision.Conv2d(chin, chout, (kernel_size, 1), (stride, 1), (pad, 0))
            self.rewrite = precision.Conv2d(chout, 2 * chout, k, 1, context)
        else:
            self.conv = precision.Conv1d(chin, chout, kernel_size, stride, pad)
            self.rewrite = precision.Conv1d(chout, 2 * chout, k, 1, context)
        self.norm1 = _norm(norm_groups, chout, norm)
        self.norm2 = _norm(norm_groups, 2 * chout, norm)
        self.dconv = DConv(chout, dconv_comp, dconv_depth)

    def forward(self, x):
        if not self.freq and x.shape[-1] % self.stride:
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = F.gelu(self.norm1(self.conv(x)))
        if self.freq:
            b, c, f, t = y.shape
            y = self.dconv(y.permute(0, 2, 1, 3).reshape(b * f, c, t))
            y = y.reshape(b, f, c, t).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return F.glu(self.norm2(self.rewrite(y)), dim=1)


class HDecLayer(nn.Module):
    """hdemucs.py HDecLayer: skip add, GLU rewrite, transposed conv, trim."""

    def __init__(self, chin: int, chout: int, last: bool = False, kernel_size: int = 8,
                 stride: int = 4, freq: bool = True, norm: bool = False,
                 norm_groups: int = 4, context: int = 1):
        super().__init__()
        self.pad, self.last, self.freq = kernel_size // 4, last, freq
        k = 1 + 2 * context
        if freq:
            self.conv_tr = precision.ConvTranspose2d(chin, chout, (kernel_size, 1), (stride, 1))
            self.rewrite = precision.Conv2d(chin, 2 * chin, k, 1, context)
        else:
            self.conv_tr = precision.ConvTranspose1d(chin, chout, kernel_size, stride)
            self.rewrite = precision.Conv1d(chin, 2 * chin, k, 1, context)
        self.norm1 = _norm(norm_groups, 2 * chin, norm)
        self.norm2 = _norm(norm_groups, chout, norm)

    def forward(self, x, skip, length: int):
        y = F.glu(self.norm1(self.rewrite(x + skip)), dim=1)
        z = self.norm2(self.conv_tr(y))
        if self.freq:
            z = z[:, :, self.pad:-self.pad] if self.pad else z
        else:
            z = z[..., self.pad:self.pad + length]
        return z if self.last else F.gelu(z)


# ------------------------------------------------------------- transformer

def create_sin_embedding(length: int, dim: int, max_period: float = 10000.0) -> np.ndarray:
    """(length, dim): cos then sin of the position over ``dim // 2`` periods."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    half = dim // 2
    adim = np.arange(half, dtype=np.float64)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return np.concatenate([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)


def create_2d_sin_embedding(d_model: int, height: int, width: int,
                            max_period: float = 10000.0) -> np.ndarray:
    """(d_model, height, width): the first half of the channels encodes the
    width position, the second half the height position."""
    pe = np.zeros((d_model, height, width), np.float32)
    half = d_model // 2
    div = np.exp(np.arange(0.0, half, 2) * -(math.log(max_period) / half))
    pos_w = np.arange(0.0, width)[:, None]
    pos_h = np.arange(0.0, height)[:, None]
    pe[0:half:2] = np.repeat(np.sin(pos_w * div).T[:, None, :], height, axis=1)
    pe[1:half:2] = np.repeat(np.cos(pos_w * div).T[:, None, :], height, axis=1)
    pe[half::2] = np.repeat(np.sin(pos_h * div).T[:, :, None], width, axis=2)
    pe[half + 1::2] = np.repeat(np.cos(pos_h * div).T[:, :, None], width, axis=2)
    return pe


class MHA(nn.Module):
    """torch nn.MultiheadAttention's parameters (packed ``in_proj``), plain
    softmax attention under the precision policy."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = precision.Linear(dim, dim)

    def forward(self, q, k, v):
        d = q.shape[-1]
        w, bias = self.in_proj_weight, self.in_proj_bias
        b, tq, tk, h = q.shape[0], q.shape[1], k.shape[1], self.heads
        hd = d // h
        wq = precision.linear(q, w[:d], bias[:d]).reshape(b, tq, h, hd).transpose(1, 2)
        wk = precision.linear(k, w[d:2 * d], bias[d:2 * d]).reshape(b, tk, h, hd).transpose(1, 2)
        wv = precision.linear(v, w[2 * d:], bias[2 * d:]).reshape(b, tk, h, hd).transpose(1, 2)
        logits = precision.einsum("bhqd,bhkd->bhqk", wq, wk) / math.sqrt(hd)
        o = precision.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), wv)
        return self.out_proj(o.transpose(1, 2).reshape(b, tq, d))


def _group_norm_tokens(norm: nn.GroupNorm, x):
    """GroupNorm over (b, t, c) tokens (demucs MyGroupNorm)."""
    return norm(x.transpose(1, 2)).transpose(1, 2)


class SelfLayer(nn.Module):
    """MyTransformerEncoderLayer: norm first, LayerScale, GroupNorm out."""

    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__()
        self.self_attn = MHA(dim, heads)
        self.linear1 = precision.Linear(dim, hidden)
        self.linear2 = precision.Linear(hidden, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm_out = nn.GroupNorm(1, dim, eps=1e-5)
        self.gamma_1 = LayerScale(dim)
        self.gamma_2 = LayerScale(dim)

    def forward(self, x):
        h = self.norm1(x)
        x = x + self.gamma_1(self.self_attn(h, h, h), channel_last=True)
        h = self.linear2(F.gelu(self.linear1(self.norm2(x))))
        return _group_norm_tokens(self.norm_out, x + self.gamma_2(h, channel_last=True))


class CrossLayer(nn.Module):
    """CrossTransformerEncoderLayer: queries from one branch, keys and
    values from the other."""

    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__()
        self.cross_attn = MHA(dim, heads)
        self.linear1 = precision.Linear(dim, hidden)
        self.linear2 = precision.Linear(hidden, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.norm_out = nn.GroupNorm(1, dim, eps=1e-5)
        self.gamma_1 = LayerScale(dim)
        self.gamma_2 = LayerScale(dim)

    def forward(self, q, kv):
        kn = self.norm2(kv)
        x = q + self.gamma_1(self.cross_attn(self.norm1(q), kn, kn), channel_last=True)
        h = self.linear2(F.gelu(self.linear1(self.norm3(x))))
        return _group_norm_tokens(self.norm_out, x + self.gamma_2(h, channel_last=True))


class CrossTransformer(nn.Module):
    def __init__(self, cfg: HTDemucsConfig, dim: int):
        super().__init__()
        self.cfg = cfg
        hidden = int(dim * cfg.t_hidden_scale)
        self.norm_in = nn.LayerNorm(dim, eps=1e-5)
        self.norm_in_t = nn.LayerNorm(dim, eps=1e-5)
        layer = [SelfLayer, CrossLayer]
        self.layers = nn.ModuleList(
            [layer[i % 2](dim, cfg.t_heads, hidden) for i in range(cfg.t_layers)])
        self.layers_t = nn.ModuleList(
            [layer[i % 2](dim, cfg.t_heads, hidden) for i in range(cfg.t_layers)])

    def forward(self, x, xt):
        """x (b, c, f, t1), xt (b, c, t2) -> the same shapes."""
        c = self.cfg
        b, dim, f, t1 = x.shape
        pe2 = create_2d_sin_embedding(dim, f, t1, c.t_max_period)
        pe2 = torch.from_numpy(pe2.transpose(2, 1, 0).reshape(t1 * f, dim)).to(x.device)
        xs = self.norm_in(x.permute(0, 3, 2, 1).reshape(b, t1 * f, dim))
        xs = xs + c.t_weight_pos_embed * pe2
        t2 = xt.shape[-1]
        pe1 = torch.from_numpy(create_sin_embedding(t2, dim, c.t_max_period)).to(x.device)
        xts = self.norm_in_t(xt.transpose(1, 2)) + c.t_weight_pos_embed * pe1
        for idx in range(c.t_layers):
            if idx % 2 == 0:
                xs, xts = self.layers[idx](xs), self.layers_t[idx](xts)
            else:
                xs, xts = self.layers[idx](xs, xts), self.layers_t[idx](xts, xs)
        return xs.reshape(b, t1, f, dim).permute(0, 3, 2, 1), xts.transpose(1, 2)


class ScaledEmbedding(nn.Module):
    """The frequency embedding (checkpoint name ``freq_emb.embedding.weight``)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.embedding = nn.Embedding(num, dim)


# ---------------------------------------------------------------- spectra

def _spec(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """htdemucs ``_spec``: reflect-padded normalised STFT, the last bin
    dropped, 2 frames trimmed each side.  (b, ch, n) -> (b, ch, F, le, 2)."""
    le = int(math.ceil(x.shape[-1] / hop))
    pad = hop // 2 * 3
    x = F.pad(x, (pad, pad + le * hop - x.shape[-1]), mode="reflect")
    re, im = stft(x, n_fft=nfft, hop=hop)                   # (b, ch, T, F + 1)
    spec = torch.stack([re, im], dim=-1) / math.sqrt(nfft)
    return spec.transpose(2, 3)[:, :, :-1, 2:2 + le]


def _ispec(spec: torch.Tensor, nfft: int, hop: int, length: int) -> torch.Tensor:
    """The inverse of :func:`_spec`: (b, s, ch, F, T, 2) -> (b, s, ch, n).
    Frames are overlap-added with ``F.fold`` (a fixed summation order) and
    divided by the squared-window sum, summed in fp64."""
    pad = hop // 2 * 3
    le = hop * int(math.ceil(length / hop)) + 2 * pad
    z = F.pad(spec, (0, 0, 2, 2, 0, 1))
    lead = z.shape[:-3]
    re, im = z[..., 0].transpose(-1, -2), z[..., 1].transpose(-1, -2)   # (..., T, F + 1)
    zc = torch.complex(re, real_edges(im, nfft))
    frames = torch.fft.irfft(zc, n=nfft, dim=-1) * math.sqrt(nfft)
    win64 = hann_window(nfft).astype(np.float64)
    frames = frames * torch.from_numpy(win64.astype(np.float32)).to(frames.device)
    t_frames = frames.shape[-2]
    out_len = (t_frames - 1) * hop + nfft
    frames = frames.reshape(-1, t_frames, nfft)
    sig = F.fold(frames.transpose(1, 2), output_size=(1, out_len), kernel_size=(1, nfft),
                 stride=(1, hop))[:, 0, 0]
    wsum = np.zeros(out_len)
    for i in range(t_frames):
        wsum[i * hop: i * hop + nfft] += win64 * win64
    sig = sig / torch.from_numpy(np.maximum(wsum, 1e-10).astype(np.float32)).to(sig.device)
    sig = sig[:, nfft // 2: nfft // 2 + le][:, pad: pad + length]
    return sig.reshape(*lead, length)


# ------------------------------------------------------------------ model

class HTDemucs(nn.Module):
    """(b, ch, n) -> (b, n_sources, ch, n)."""

    def __init__(self, cfg: HTDemucsConfig = HTDemucsConfig()):
        super().__init__()
        c = self.cfg = cfg
        s = len(c.sources)
        self.encoder, self.tencoder = nn.ModuleList(), nn.ModuleList()
        self.decoder, self.tdecoder = nn.ModuleList(), nn.ModuleList()
        chans = [c.channels * c.growth ** i for i in range(c.depth)]
        for i in range(c.depth):
            norm = i >= c.norm_starts
            kw = dict(kernel_size=c.kernel_size, stride=c.stride, norm=norm,
                      norm_groups=c.norm_groups)
            ekw = dict(kw, context=c.context_enc, dconv_depth=c.dconv_depth,
                       dconv_comp=c.dconv_comp)
            chin = c.audio_channels if i == 0 else chans[i - 1]
            self.encoder.append(HEncLayer(2 * chin if i == 0 else chin, chans[i], freq=True,
                                          **ekw))
            self.tencoder.append(HEncLayer(chin, chans[i], freq=False, **ekw))
            # decoder j undoes encoder depth - 1 - j
            chout = c.audio_channels * s if i == 0 else chans[i - 1]
            self.decoder.insert(0, HDecLayer(chans[i], 2 * chout if i == 0 else chout,
                                             last=i == 0, freq=True, context=c.context, **kw))
            self.tdecoder.insert(0, HDecLayer(chans[i], chout, last=i == 0, freq=False,
                                              context=c.context, **kw))
        self.freq_emb = ScaledEmbedding((c.nfft // 2) // c.stride, chans[0])
        tch = chans[-1]
        if c.bottom_channels:
            self.channel_upsampler = precision.Conv1d(tch, c.bottom_channels, 1)
            self.channel_downsampler = precision.Conv1d(c.bottom_channels, tch, 1)
            self.channel_upsampler_t = precision.Conv1d(tch, c.bottom_channels, 1)
            self.channel_downsampler_t = precision.Conv1d(c.bottom_channels, tch, 1)
            tch = c.bottom_channels
        self.crosstransformer = CrossTransformer(c, tch)

    def forward(self, mix):
        c = self.cfg
        length = mix.shape[-1]
        train_len = int(c.segment_seconds * c.samplerate)
        pre_pad = None
        if length < train_len:
            pre_pad = length
            mix = F.pad(mix, (0, train_len - length))
            length = train_len

        z = _spec(mix, c.nfft, c.hop)                          # (b, ch, F, T, 2)
        b, ch, fq, t, _ = z.shape
        mag = z.permute(0, 1, 4, 2, 3).reshape(b, ch * 2, fq, t)
        mean = mag.mean(dim=(1, 2, 3), keepdim=True)
        std = mag.std(dim=(1, 2, 3), keepdim=True)
        x = (mag - mean) / (1e-5 + std)
        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True)
        xt = (mix - meant) / (1e-5 + stdt)

        saved, saved_t, lengths_t = [], [], []
        for i in range(c.depth):
            lengths_t.append(xt.shape[-1])
            xt = self.tencoder[i](xt)
            saved_t.append(xt)
            x = self.encoder[i](x)
            if i == 0:
                emb = self.freq_emb.embedding.weight
                x = x + (c.freq_emb_scale * c.emb_scale) * emb.t()[None, :, :, None]
            saved.append(x)

        if c.bottom_channels:
            bb, cc, ff, tt = x.shape
            x = self.channel_upsampler(x.reshape(bb, cc, ff * tt)).reshape(bb, -1, ff, tt)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if c.bottom_channels:
            bb, cc, ff, tt = x.shape
            x = self.channel_downsampler(x.reshape(bb, cc, ff * tt)).reshape(bb, -1, ff, tt)
            xt = self.channel_downsampler_t(xt)

        for j in range(c.depth):
            x = self.decoder[j](x, saved.pop(), 0)
            xt = self.tdecoder[j](xt, saved_t.pop(), lengths_t.pop())

        s = len(c.sources)
        x = x.reshape(b, s, ch * 2, fq, t) * std[:, None] + mean[:, None]
        zout = x.reshape(b, s, ch, 2, fq, t).permute(0, 1, 2, 4, 5, 3)
        wav_spec = _ispec(zout, c.nfft, c.hop, length)
        xt = xt.reshape(b, s, ch, length) * stdt[:, None] + meant[:, None]
        out = xt + wav_spec
        return out[..., :pre_pad] if pre_pad is not None else out
