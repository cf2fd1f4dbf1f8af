"""HuBERT-base (fairseq's HubertModel, the RVC v2 feature extractor: the
output of layer 12, 768-d) in plain fp32 PyTorch, under fairseq's
parameter names.  Attention is plain softmax attention with no padding mask;
every product goes through ``precision``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import precision
from benchmark.reference.roformer import attention

CONV = [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2


class Layer(nn.Module):
    def __init__(self, dim, ffn, heads):
        super().__init__()
        self.heads = heads
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, precision.Linear(dim, dim))
        self.self_attn_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.fc1 = precision.Linear(dim, ffn)
        self.fc2 = precision.Linear(ffn, dim)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        b, t, dim = x.shape
        a = self.self_attn

        def heads(z):
            return z.reshape(b, t, self.heads, dim // self.heads).transpose(1, 2)

        o = attention(heads(a.q_proj(x)), heads(a.k_proj(x)), heads(a.v_proj(x)))
        x = self.self_attn_layer_norm(x + a.out_proj(o.transpose(1, 2).reshape(b, t, dim)))
        return self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))


class Hubert(nn.Module):
    def __init__(self, dim=768, ffn_dim=3072, heads=12, layers=12):
        super().__init__()
        self.feature_extractor = nn.Module()
        convs, cin = [], 1
        for i, (ch, k, s) in enumerate(CONV):
            mods = [precision.Conv1d(cin, ch, k, stride=s, bias=False), nn.Identity()]
            if i == 0:
                mods.append(nn.GroupNorm(ch, ch, eps=1e-5))
            mods.append(nn.GELU())
            convs.append(nn.Sequential(*mods))
            cin = ch
        self.feature_extractor.conv_layers = nn.ModuleList(convs)
        self.layer_norm = nn.LayerNorm(512, eps=1e-5)
        self.post_extract_proj = precision.Linear(512, dim)
        self.encoder = nn.Module()
        self.encoder.pos_conv = nn.Sequential(
            precision.Conv1d(dim, dim, 128, padding=64, groups=16))
        self.encoder.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.encoder.layers = nn.ModuleList([Layer(dim, ffn_dim, heads) for _ in range(layers)])

    def forward(self, wav):
        """(b, n) 16 kHz -> (b, t50, dim), the last layer's output."""
        x = wav[:, None, :]
        for block in self.feature_extractor.conv_layers:
            x = block(x)
        x = self.post_extract_proj(self.layer_norm(x.transpose(1, 2)))
        t = x.shape[1]
        pos = self.encoder.pos_conv(x.transpose(1, 2)).transpose(1, 2)
        x = self.encoder.layer_norm(x + F.gelu(pos[:, :t]))
        for layer in self.encoder.layers:
            x = layer(x)
        return x
