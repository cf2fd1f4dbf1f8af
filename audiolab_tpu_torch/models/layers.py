"""VITS-style building blocks of the RVC synthesizer (counterpart of
audiolab_tpu/models/layers.py).

These blocks work on torch's NCT layout (batch, channels, time); the model
entry points in models/rvc/synthesizer.py take and return the JAX package's
NTC layout.  Parameter names follow the upstream RVC checkpoints
(attentions.py / modules.py); weight-normed convolutions hold the folded
weight as a plain ``.weight``.  Convolutions and products follow the
precision policy of core/precision.py.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core import precision

LRELU_SLOPE = 0.1


def lrelu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(b,) lengths -> (b, max_len) bool mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def Conv1d(in_ch: int, out_ch: int, kernel_size: int = 1, stride: int = 1,
           dilation: int = 1, bias: bool = True, padding: int | None = None):
    """NCT conv with torch-style 'same' padding by default (the JAX
    Conv1d's ``padding=None``)."""
    pad = get_padding(kernel_size, dilation) if padding is None else padding
    return precision.Conv1d(in_ch, out_ch, kernel_size, stride=stride, padding=pad,
                            dilation=dilation, bias=bias)


class ConvTranspose1d(precision.ConvTranspose1d):
    """torch ConvTranspose1d(k, s, padding=(k-s)//2): output (t-1)*s - 2p + k."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int):
        super().__init__(in_ch, out_ch, kernel_size, stride,
                         padding=(kernel_size - stride) // 2)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of NCT (modules.py LayerNorm)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        x = x.transpose(1, -1)
        x = F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta, self.eps)
        return x.transpose(1, -1)


class RelPositionMultiHeadAttention(nn.Module):
    """VITS windowed-relative-position self-attention (single shared
    relative bank); plain attention, not a kernel."""

    def __init__(self, channels: int, n_heads: int, window_size: int = 10):
        super().__init__()
        self.channels, self.n_heads, self.window_size = channels, n_heads, window_size
        k_ch = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, channels, 1)
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, k_ch) * k_ch ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, k_ch) * k_ch ** -0.5)

    @staticmethod
    def _get_relative_embeddings(emb, length: int, window: int):
        """Pad/slice the (1, 2w+1, d) bank to (1, 2*length-1, d)."""
        pad = max(length - (window + 1), 0)
        start = max((window + 1) - length, 0)
        if pad > 0:
            emb = F.pad(emb, (0, 0, pad, pad))
        return emb[:, start: start + 2 * length - 1]

    @staticmethod
    def _relative_to_absolute(x):
        """(b,h,t,2t-1) relative logits -> (b,h,t,t)."""
        b, h, t, _ = x.shape
        x = F.pad(x, (0, 1)).reshape(b, h, t * 2 * t)
        x = F.pad(x, (0, t - 1)).reshape(b, h, t + 1, 2 * t - 1)
        return x[:, :, :t, t - 1:]

    @staticmethod
    def _absolute_to_relative(x):
        """(b,h,t,t) -> (b,h,t,2t-1)."""
        b, h, t, _ = x.shape
        x = F.pad(x, (0, t - 1)).reshape(b, h, t * (2 * t - 1))
        x = F.pad(x, (t, 0)).reshape(b, h, t, 2 * t)
        return x[:, :, :, 1:]

    def forward(self, x, mask=None):
        # x (b, c, t); mask bool (b, 1, t, t)
        b, _, t = x.shape
        h = self.n_heads
        k_ch = self.channels // h

        def heads(z):
            return z.reshape(b, h, k_ch, t).transpose(2, 3)   # (b, h, t, d)

        q, k, v = heads(self.conv_q(x)), heads(self.conv_k(x)), heads(self.conv_v(x))
        scale = 1.0 / k_ch ** 0.5
        scores = precision.einsum("bhqd,bhkd->bhqk", q, k) * scale
        rel = self._get_relative_embeddings(self.emb_rel_k, t, self.window_size)
        rel_logits = precision.einsum("bhqd,xmd->bhqm", q, rel) * scale
        scores = scores + self._relative_to_absolute(rel_logits)
        if mask is not None:
            scores = torch.where(mask, scores, torch.full_like(scores, -1e4))
        probs = torch.softmax(scores, dim=-1)
        out = precision.einsum("bhqk,bhkd->bhqd", probs, v)
        rel_v = self._get_relative_embeddings(self.emb_rel_v, t, self.window_size)
        out = out + precision.einsum("bhqm,xmd->bhqd", self._absolute_to_relative(probs), rel_v)
        out = out.transpose(2, 3).reshape(b, self.channels, t)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward: conv k -> relu -> conv k, masked."""

    def __init__(self, channels: int, filter_channels: int, kernel_size: int = 3):
        super().__init__()
        self.conv_1 = Conv1d(channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, channels, kernel_size)

    def forward(self, x, mask=None):
        if mask is not None:
            x = x * mask
        x = torch.relu(self.conv_1(x))
        if mask is not None:
            x = x * mask
        x = self.conv_2(x)
        if mask is not None:
            x = x * mask
        return x


class TransformerEncoder(nn.Module):
    """attentions.Encoder: n_layers of (rel-MHA + LN, FFN + LN), post-norm."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 3, window_size: int = 10):
        super().__init__()
        self.attn_layers = nn.ModuleList([
            RelPositionMultiHeadAttention(hidden_channels, n_heads, window_size)
            for _ in range(n_layers)])
        self.norm_layers_1 = nn.ModuleList([LayerNorm(hidden_channels) for _ in range(n_layers)])
        self.ffn_layers = nn.ModuleList([
            FFN(hidden_channels, filter_channels, kernel_size) for _ in range(n_layers)])
        self.norm_layers_2 = nn.ModuleList([LayerNorm(hidden_channels) for _ in range(n_layers)])

    def forward(self, x, x_mask):
        # x (b, c, t); x_mask (b, 1, t)
        attn_mask = (x_mask[:, :, :, None] * x_mask[:, :, None, :]) > 0   # (b,1,t,t)
        x = x * x_mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1,
                                     self.ffn_layers, self.norm_layers_2):
            x = n1(x + attn(x * x_mask, attn_mask))
            x = n2(x + ffn(x, x_mask))
        return x * x_mask


class WN(nn.Module):
    """WaveNet residual stack with gated tanh units + global conditioning."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels, self.n_layers = hidden_channels, n_layers
        h = hidden_channels
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * h * n_layers, 1)
        self.in_layers = nn.ModuleList([
            Conv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i) for i in range(n_layers)])
        self.res_skip_layers = nn.ModuleList([
            Conv1d(h, 2 * h if i < n_layers - 1 else h, 1) for i in range(n_layers)])

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            if g_all is not None:
                x_in = x_in + g_all[:, i * 2 * h:(i + 1) * 2 * h]
            acts = torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:])
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


class ResBlock1(nn.Module):
    """HiFi-GAN ResBlock1: 3 x (dilated conv + conv) residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, dilation=d) for d in dilations])
        self.convs2 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size) for _ in dilations])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(lrelu(c1(lrelu(x))))
        return x
