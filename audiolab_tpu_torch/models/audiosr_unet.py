"""AudioSR's latent-diffusion UNet (counterpart of
audiolab_tpu/models/audiosr_unet.py; upstream: the audiosr wheel's
diffusionmodules/openaimodel.py:446-880 and attention.py:326-475 at the
shipped basic config, utils.py:470-482): in 32 (16 noisy + 16 lowpass-VAE
concat), model 128, mult (1, 2, 3, 5), 2 res blocks a level, a pair of
self-attention SpatialTransformers at downsample rates 2/4/8, head dim 32,
v-prediction.

Works on torch's (b, c, t', f') layout, the upstream one, under the
upstream ``model.diffusion_model`` names (``time_embed.{0,2}``,
``input_blocks.i.j``, ``middle_block.j``, ``output_blocks.i.j``,
``out.{0,2}``), which ``convert_audiosr_unet`` maps; ``unet_layer_schedule``
(a copy of the JAX package's) gives the block layout to both.

GroupNorm32 computes in fp32; the attention is plain fp32 ops (an einsum,
a softmax, an einsum), never a library attention call; the feed-forward is
GEGLU with exact GELU; upsampling is nearest.  Everything is fp32, and on
the card TF32 is off (core/precision.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class AudioSRUNetConfig:
    in_channels: int = 32
    model_channels: int = 128
    out_channels: int = 16
    num_res_blocks: int = 2
    attention_resolutions: Sequence[int] = (8, 4, 2)
    channel_mult: Sequence[int] = (1, 2, 3, 5)
    num_head_channels: int = 32


def unet_layer_schedule(cfg: AudioSRUNetConfig):
    """Returns (input_blocks, middle, output_blocks): lists of blocks,
    each block a list of (kind, params) matching torch Sequential order.
    kind: conv_in | res | attn | down | up."""
    mc = cfg.model_channels
    inputs = [[("conv_in", dict(out=mc))]]
    chans = [mc]
    ch, ds = mc, 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            block = [("res", dict(inp=ch, out=mult * mc))]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                block += [("attn", dict(ch=ch)), ("attn", dict(ch=ch))]
            inputs.append(block)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            inputs.append([("down", dict(ch=ch))])
            chans.append(ch)
            ds *= 2
    middle = [("res", dict(inp=ch, out=ch)), ("attn", dict(ch=ch)),
              ("attn", dict(ch=ch)), ("res", dict(inp=ch, out=ch))]
    outputs = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = chans.pop()
            block = [("res", dict(inp=ch + ich, out=mult * mc))]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                block += [("attn", dict(ch=ch)), ("attn", dict(ch=ch))]
            if level and i == cfg.num_res_blocks:
                block.append(("up", dict(ch=ch)))
                ds //= 2
            outputs.append(block)
    return inputs, middle, outputs


class GroupNorm32(nn.GroupNorm):
    """32-group GroupNorm computed in fp32 (upstream ``GroupNorm32``)."""

    def __init__(self, channels: int, eps: float):
        super().__init__(32, channels, eps=eps)

    def forward(self, x):
        return super().forward(x.float()).type(x.dtype)


def conv3(inp: int, out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(inp, out, 3, stride=stride, padding=1)


class ResBlock(nn.Module):
    """openaimodel ResBlock (use_scale_shift_norm=False): GN(1e-5)-silu-
    conv3 -> + emb -> GN-silu-conv3 (+ 1x1 skip)."""

    def __init__(self, inp: int, out: int, emb_ch: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(inp, 1e-5), nn.SiLU(), conv3(inp, out))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, out))
        self.out_layers = nn.Sequential(GroupNorm32(out, 1e-5), nn.SiLU(), nn.Identity(),
                                        conv3(out, out))
        self.skip_connection = nn.Conv2d(inp, out, 1) if inp != out else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers(x) + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class CrossAttention(nn.Module):
    """Self-attention (the context slot is empty in this model) as plain
    fp32 ops."""

    def __init__(self, ch: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(ch, ch, bias=False)
        self.to_k = nn.Linear(ch, ch, bias=False)
        self.to_v = nn.Linear(ch, ch, bias=False)
        self.to_out = nn.Sequential(nn.Linear(ch, ch), nn.Identity())

    def forward(self, x):
        b, n, c = x.shape
        dk = c // self.heads
        q, k, v = (f(x).reshape(b, n, self.heads, dk).transpose(1, 2)
                   for f in (self.to_q, self.to_k, self.to_v))
        w = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
        w = torch.softmax(w * dk ** -0.5, dim=-1)
        o = torch.einsum("bhij,bhjd->bhid", w, v.float()).to(x.dtype)
        return self.to_out(o.transpose(1, 2).reshape(b, n, c))


class GEGLU(nn.Module):
    def __init__(self, ch: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(ch, 2 * inner)

    def forward(self, x):
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class TransformerBlock(nn.Module):
    def __init__(self, ch: int, heads: int):
        super().__init__()
        self.attn1 = CrossAttention(ch, heads)
        self.attn2 = CrossAttention(ch, heads)
        self.norm1 = nn.LayerNorm(ch, eps=1e-5)
        self.norm2 = nn.LayerNorm(ch, eps=1e-5)
        self.norm3 = nn.LayerNorm(ch, eps=1e-5)
        self.ff = nn.Module()
        self.ff.net = nn.Sequential(GEGLU(ch, 4 * ch), nn.Identity(), nn.Linear(4 * ch, ch))

    def forward(self, h):
        h = h + self.attn1(self.norm1(h))
        h = h + self.attn2(self.norm2(h))
        return h + self.ff.net(self.norm3(h))


class SpatialTransformer(nn.Module):
    """Depth 1, context None: GN(1e-6) + 1x1 proj_in -> [self-attention,
    self-attention (the context slot), GEGLU ff] -> 1x1 proj_out, residual."""

    def __init__(self, ch: int, heads: int):
        super().__init__()
        self.norm = GroupNorm32(ch, 1e-6)
        self.proj_in = nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList([TransformerBlock(ch, heads)])
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x)).reshape(b, c, hh * ww).transpose(1, 2)
        h = self.transformer_blocks[0](h)
        return x + self.proj_out(h.transpose(1, 2).reshape(b, c, hh, ww))


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = conv3(ch, ch, stride=2)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = conv3(ch, ch)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimestepBlock(nn.ModuleList):
    """One Sequential of the upstream UNet: each layer takes the time
    embedding when it is a ResBlock."""

    def forward(self, h, emb):
        for layer in self:
            h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
        return h


def _block(layers, cfg: AudioSRUNetConfig, in_ch: int) -> TimestepBlock:
    emb_ch = 4 * cfg.model_channels
    mods = []
    for kind, p in layers:
        if kind == "conv_in":
            mods.append(conv3(in_ch, p["out"]))
        elif kind == "res":
            mods.append(ResBlock(p["inp"], p["out"], emb_ch))
        elif kind == "attn":
            mods.append(SpatialTransformer(p["ch"], p["ch"] // cfg.num_head_channels))
        elif kind == "down":
            mods.append(Downsample(p["ch"]))
        elif kind == "up":
            mods.append(Upsample(p["ch"]))
    return TimestepBlock(mods)


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """[cos, sin] of t * 10000^(-i / half) (b, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=timesteps.device) / half)
    ang = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class AudioSRUNet(nn.Module):
    """x (b, in_ch, t', f') latents + timesteps (b,) -> v-prediction
    (b, out_ch, t', f')."""

    def __init__(self, cfg: AudioSRUNetConfig = AudioSRUNetConfig()):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        self.time_embed = nn.Sequential(nn.Linear(mc, 4 * mc), nn.SiLU(),
                                        nn.Linear(4 * mc, 4 * mc))
        inputs, middle, outputs = unet_layer_schedule(cfg)
        self.input_blocks = nn.ModuleList([_block(b, cfg, cfg.in_channels) for b in inputs])
        self.middle_block = _block(middle, cfg, 0)
        self.output_blocks = nn.ModuleList([_block(b, cfg, 0) for b in outputs])
        ch = outputs[-1][0][1]["out"]
        self.out = nn.Sequential(GroupNorm32(ch, 1e-5), nn.SiLU(), conv3(ch, cfg.out_channels))

    def forward(self, x, timesteps):
        emb = self.time_embed(timestep_embedding(timesteps, self.cfg.model_channels).to(x.dtype))
        hs = []
        h = x
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out(h)
