"""Stable-Audio-Open DiT and Oobleck decoder at the checkpoint's structure
(counterpart of audiolab_tpu/models/stable_audio_dit.py; upstream
stable_audio_tools/models/{dit,transformer,autoencoders}.py).

stable-audio-open-1.0's geometry: 64 latent channels, embed 1536, depth 24,
24 heads of 64, T5 cross tokens 768 wide (12 key/value heads, each repeated
to 2 query heads), the global conditioning (the seconds embeddings, 1536)
and the timestep's Fourier features (2 pi t w with a learned (128, 1) w)
summed into one token PREPENDED to the latents: t + 1 positions, the token
dropped after the last block.  Self-attention rotates the first 32 of each
head's 64 dims (split-half rope); cross-attention has none.  LayerNorms are
gamma-only with eps 1e-5 (``beta`` a zero buffer, as upstream), the
feed-forward a SiLU GLU.  Everything runs in fp32: the self-attention is K2
on its fp32 kernel (``k2f_kernel``), the cross-attention the plain
:func:`attention_reference`, as in the JAX module.

Parameter names are stable_audio_tools' (``timestep_features``,
``to_timestep_embed``, ``to_cond_embed``, ``to_global_embed``,
``preprocess_conv``, ``transformer.project_in``, ``transformer.layers.N.
{pre_norm,self_attn,cross_attend_norm,cross_attn,ff_norm,ff}``, and the
decoder's ``layers.N``), the names ``convert_sao_dit`` and
``convert_oobleck`` map; weight-normed convolutions hold the folded weight
as a plain ``.weight``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.attention import attention_reference, flash_attention
from audiolab_tpu_torch.models.codecs import _ConvSame, _ConvTransposeSame


@dataclass(frozen=True)
class SAODiTConfig:
    io_channels: int = 64
    embed_dim: int = 1536
    depth: int = 24
    num_heads: int = 24
    cond_token_dim: int = 768
    global_cond_dim: int = 1536
    dtype: str = "float32"

    @property
    def dim_heads(self) -> int:
        return self.embed_dim // self.num_heads


def _partial_rope(x: torch.Tensor, seq_offset: int = 0) -> torch.Tensor:
    """Rotate the first min(hd, 2 max(hd // 4, 16)) dims of each head of x
    (b, h, t, hd), split-half convention, in fp32 (32 of 64 at hd = 64)."""
    hd, t = x.shape[-1], x.shape[-2]
    rot = min(hd, 2 * max(hd // 4, 16))
    half = rot // 2
    inv = torch.tensor(1.0 / (10000.0 ** (np.arange(0, rot, 2, dtype=np.float32) / rot)),
                       device=x.device)
    pos = torch.arange(t, device=x.device, dtype=torch.float32) + seq_offset
    ang = pos[:, None] * inv[None, :]
    cos = torch.cat([torch.cos(ang), torch.cos(ang)], dim=-1)
    sin = torch.cat([torch.sin(ang), torch.sin(ang)], dim=-1)
    xr, xu = x[..., :rot], x[..., rot:]
    rot_half = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    xr = (xr.float() * cos + rot_half.float() * sin).to(x.dtype)
    return torch.cat([xr, xu], dim=-1)


class GammaLN(nn.Module):
    """LayerNorm with a learned gain only, eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.register_buffer("beta", torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta, eps=1e-5)


class SAOSelfAttention(nn.Module):
    def __init__(self, cfg: SAODiTConfig):
        super().__init__()
        self.cfg = cfg
        self.to_qkv = nn.Linear(cfg.embed_dim, 3 * cfg.embed_dim, bias=False)
        self.to_out = nn.Linear(cfg.embed_dim, cfg.embed_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, t, _ = x.shape
        q, k, v = (a.reshape(b, t, c.num_heads, c.dim_heads).transpose(1, 2)
                   for a in torch.chunk(self.to_qkv(x), 3, dim=-1))
        o = flash_attention(_partial_rope(q), _partial_rope(k), v)
        return self.to_out(o.transpose(1, 2).reshape(b, t, c.embed_dim))


class SAOCrossAttention(nn.Module):
    def __init__(self, cfg: SAODiTConfig):
        super().__init__()
        self.cfg = cfg
        self.to_q = nn.Linear(cfg.embed_dim, cfg.embed_dim, bias=False)
        self.to_kv = nn.Linear(cfg.cond_token_dim, 2 * cfg.cond_token_dim, bias=False)
        self.to_out = nn.Linear(cfg.embed_dim, cfg.embed_dim, bias=False)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        b, t, _ = x.shape
        s, hd = ctx.shape[1], c.dim_heads
        kv_heads = c.cond_token_dim // hd
        q = self.to_q(x).reshape(b, t, c.num_heads, hd).transpose(1, 2)
        k, v = (a.reshape(b, s, kv_heads, hd).transpose(1, 2)
                for a in torch.chunk(self.to_kv(ctx), 2, dim=-1))
        rep = c.num_heads // kv_heads
        if rep > 1:
            k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        o = attention_reference(q, k, v)
        return self.to_out(o.transpose(1, 2).reshape(b, t, c.embed_dim))


class _GLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = torch.chunk(self.proj(x), 2, dim=-1)
        return a * F.silu(gate)


class SAOFeedForward(nn.Module):
    """SiLU GLU: ``ff.0.proj`` to 2 * inner, x * silu(gate), ``ff.2`` back."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.ff = nn.ModuleList([_GLU(dim, dim * mult), nn.Identity(),
                                 nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff[2](self.ff[0](x))


class SAOBlock(nn.Module):
    def __init__(self, cfg: SAODiTConfig):
        super().__init__()
        self.pre_norm = GammaLN(cfg.embed_dim)
        self.self_attn = SAOSelfAttention(cfg)
        self.cross_attend_norm = GammaLN(cfg.embed_dim)
        self.cross_attn = SAOCrossAttention(cfg)
        self.ff_norm = GammaLN(cfg.embed_dim)
        self.ff = SAOFeedForward(cfg.embed_dim)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.pre_norm(x))
        x = x + self.cross_attn(self.cross_attend_norm(x), ctx)
        return x + self.ff(self.ff_norm(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: SAODiTConfig):
        super().__init__()
        self.project_in = nn.Linear(cfg.io_channels, cfg.embed_dim, bias=False)
        self.project_out = nn.Linear(cfg.embed_dim, cfg.io_channels, bias=False)
        self.layers = nn.ModuleList([SAOBlock(cfg) for _ in range(cfg.depth)])


class _FourierFeatures(nn.Module):
    def __init__(self, out_features: int = 256):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features // 2, 1))


def _mlp(cin: int, cout: int, bias: bool) -> nn.Sequential:
    return nn.Sequential(nn.Linear(cin, cout, bias=bias), nn.SiLU(),
                         nn.Linear(cout, cout, bias=bias))


class StableAudioDiT(nn.Module):
    """v-prediction denoiser: (latents (b, t, 64), t (b,), cross tokens
    (b, s, 768), global cond (b, 1536)) -> (b, t, 64)."""

    def __init__(self, cfg: SAODiTConfig = SAODiTConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        self.timestep_features = _FourierFeatures(256)
        self.to_timestep_embed = _mlp(256, c.embed_dim, True)
        self.to_cond_embed = _mlp(c.cond_token_dim, c.cond_token_dim, False)
        self.to_global_embed = _mlp(c.global_cond_dim, c.embed_dim, False)
        self.preprocess_conv = nn.Conv1d(c.io_channels, c.io_channels, 1, bias=False)
        self.postprocess_conv = nn.Conv1d(c.io_channels, c.io_channels, 1, bias=False)
        self.transformer = _Transformer(c)

    def forward(self, x, t, cross_cond, global_cond):
        w = self.timestep_features.weight
        f = 2.0 * np.pi * t.float()[:, None] * w[None, :, 0]
        temb = self.to_timestep_embed(torch.cat([torch.cos(f), torch.sin(f)], dim=-1))
        ctx = self.to_cond_embed(cross_cond)
        g = self.to_global_embed(global_cond) + temb
        x = x + F.linear(x, self.preprocess_conv.weight[:, :, 0])
        h = self.transformer.project_in(x)
        h = torch.cat([g[:, None, :], h], dim=1)          # the prepended token
        for layer in self.transformer.layers:
            h = layer(h, ctx)
        out = self.transformer.project_out(h[:, 1:])
        return out + F.linear(out, self.postprocess_conv.weight[:, :, 0])


# --------------------------------------------------------- Oobleck VAE decoder

@dataclass(frozen=True)
class OobleckConfig:
    """stable-audio-open-1.0's decoder geometry."""

    out_channels: int = 2
    channels: int = 128
    latent_dim: int = 64
    c_mults: tuple = (1, 2, 4, 8, 16)
    strides: tuple = (2, 4, 4, 8, 8)
    final_tanh: bool = False


class SnakeBeta(nn.Module):
    """x + sin^2(exp(alpha) x) / (exp(beta) + 1e-9) over (b, ch, t), log-scale
    (ch,) parameters, in fp32."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        ea, eb = torch.exp(self.alpha)[:, None], torch.exp(self.beta)[:, None]
        return (xf + torch.sin(ea * xf) ** 2 / (eb + 1e-9)).to(x.dtype)


class _Seq(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class _OobResUnit(_Seq):
    def __init__(self, ch: int, dilation: int):
        super().__init__([SnakeBeta(ch), _ConvSame(ch, ch, 7, dilation), SnakeBeta(ch),
                          nn.Conv1d(ch, ch, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + super().forward(x)


class OobleckDecoder(_Seq):
    """(b, t, latent) -> (b, out_channels, t * prod(strides))."""

    def __init__(self, cfg: OobleckConfig = OobleckConfig()):
        c = cfg
        mults = (1,) + tuple(c.c_mults)
        layers = [_ConvSame(c.latent_dim, mults[-1] * c.channels, 7)]
        for i in range(len(mults) - 1, 0, -1):
            cin, cout, s = mults[i] * c.channels, mults[i - 1] * c.channels, c.strides[i - 1]
            layers.append(_Seq([SnakeBeta(cin), _ConvTransposeSame(cin, cout, s)]
                               + [_OobResUnit(cout, d) for d in (1, 3, 9)]))
        layers.append(SnakeBeta(c.channels))
        layers.append(nn.Conv1d(c.channels, c.out_channels, 7, padding=3, bias=False))
        super().__init__(layers)
        self.cfg = c

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = super().forward(z.transpose(1, 2))
        return torch.tanh(h) if self.cfg.final_tanh else h
