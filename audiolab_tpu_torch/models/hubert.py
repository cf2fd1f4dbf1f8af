"""HuBERT / ContentVec feature extractor (counterpart of
audiolab_tpu/models/hubert.py).

HuBERT-base topology: a 7-layer conv feature extractor (512 channels,
strides 5,2,2,2,2,2,2, GroupNorm on layer 0, GELU), LayerNorm, 512 -> 768
projection, a grouped conv positional embedding (k=128, groups=16, the
SamePad trim of its extra frame), 12 post-LN transformer layers (12 heads,
FFN 3072, exact GELU).  Attention goes through kernels/attention.py (K2 on
the card).  Parameter names are fairseq's.  Like the JAX model, attention
takes no padding mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.kernels.attention import flash_attention

_CONV_LAYERS = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2


@dataclass(frozen=True)
class HubertConfig:
    dim: int = 768
    ffn_dim: int = 3072
    heads: int = 12
    layers: int = 12
    final_dim: int = 256


class ConvFeatureExtractor(nn.Module):
    """(b, n) 16 kHz waveform -> (b, t, 512)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 1
        for i, (ch, k, s) in enumerate(_CONV_LAYERS):
            mods = [precision.Conv1d(cin, ch, k, stride=s, bias=False), nn.Identity()]
            if i == 0:
                mods.append(nn.GroupNorm(ch, ch, eps=1e-5))
            mods.append(nn.GELU())
            layers.append(nn.Sequential(*mods))
            cin = ch
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav):
        x = wav[:, None, :]
        for block in self.conv_layers:
            x = block(x)
        return x.transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.q_proj = precision.Linear(dim, dim)
        self.k_proj = precision.Linear(dim, dim)
        self.v_proj = precision.Linear(dim, dim)
        self.out_proj = precision.Linear(dim, dim)

    def forward(self, x):
        b, t, _ = x.shape
        d = self.dim // self.heads

        def heads(z):
            return z.reshape(b, t, self.heads, d).transpose(1, 2)

        o = flash_attention(heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x)))
        return self.out_proj(o.transpose(1, 2).reshape(b, t, self.dim))


class TransformerLayer(nn.Module):
    """fairseq post-LN encoder layer."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.self_attn = SelfAttention(cfg.dim, cfg.heads)
        self.self_attn_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-5)
        self.fc1 = precision.Linear(cfg.dim, cfg.ffn_dim)
        self.fc2 = precision.Linear(cfg.ffn_dim, cfg.dim)
        self.final_layer_norm = nn.LayerNorm(cfg.dim, eps=1e-5)

    def forward(self, x):
        x = self.self_attn_layer_norm(x + self.self_attn(x))
        y = self.fc2(F.gelu(self.fc1(x)))
        return self.final_layer_norm(x + y)


class _Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pos_conv = nn.Sequential(
            precision.Conv1d(cfg.dim, cfg.dim, 128, padding=64, groups=16))
        self.layer_norm = nn.LayerNorm(cfg.dim, eps=1e-5)
        self.layers = nn.ModuleList([TransformerLayer(cfg) for _ in range(cfg.layers)])


class Hubert(nn.Module):
    """fairseq HubertModel's inference graph; ``forward`` returns the output
    of the 1-indexed ``output_layer``."""

    def __init__(self, cfg: HubertConfig = HubertConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = ConvFeatureExtractor()
        self.layer_norm = nn.LayerNorm(512, eps=1e-5)
        self.post_extract_proj = precision.Linear(512, cfg.dim)
        self.encoder = _Encoder(cfg)

    def forward(self, wav, output_layer: int = 12):
        x = self.post_extract_proj(self.layer_norm(self.feature_extractor(wav)))
        t = x.shape[1]
        pos = self.encoder.pos_conv(x.transpose(1, 2)).transpose(1, 2)
        x = x + F.gelu(pos[:, :t])      # SamePad: drop the extra trailing frame
        x = self.encoder.layer_norm(x)
        for i, layer in enumerate(self.encoder.layers):
            x = layer(x)
            if i + 1 == output_layer:
                break
        return x


class HubertFeatureExtractor(Hubert):
    """v1 (256-d: layer 9 + final_proj) or v2 (768-d: layer 12) features as
    the RVC pipeline expects; parameter names stay fairseq's."""

    def __init__(self, version: str = "v2", cfg: HubertConfig = HubertConfig(),
                 output_layer: int | None = None):
        super().__init__(cfg)
        self.version = version
        if output_layer is None:
            output_layer = cfg.layers if version == "v2" else max(1, cfg.layers * 9 // 12)
        self.output_layer = output_layer
        if version == "v1":
            self.final_proj = precision.Linear(cfg.dim, cfg.final_dim)

    def forward(self, wav):
        x = super().forward(wav, output_layer=self.output_layer)
        return self.final_proj(x) if self.version == "v1" else x
