"""ACE-Step's diffusion transformer in the published checkpoint's layout
(counterpart of audiolab_tpu/models/acestep_dit.py; upstream
acestep/models/ace_step_transformer.py:206-330, attention.py:197-340 and
lyric_encoder.py:902-1010), and its lyric conformer.

- ``PatchEmbedIn``: upstream's ``early_conv_layers`` (a Conv2d of kernel
  and stride (16, 1) over the full latent height, GroupNorm(32), a 1x1
  Conv2d).  The JAX module states the first convolution as a Dense over
  the flattened (channel, height) patch; here it is the Conv2d, under its
  upstream names, and ``utils/weights.py::acestep_dit_from_jax`` reshapes.
- ``LinearTransformerBlock``: affine-less RMSNorm, lite linear attention
  (a ReLU kernel, fp32 sums, a ones-row denominator), a softmax
  cross-attention over the conditioning sequence that reads the raw
  residual stream, the GLUMBConv feed-forward, and adaLN-single through a
  per-block ``scale_shift_table``.
- Rope is upstream's quirk: Qwen2-style half-duplicated tables with
  interleaved-pair rotation (not the LM core's rope of ``models/lm.py``).

This DiT launches none of the hand-written kernels: its self-attention is
linear and its cross-attention a plain softmax, as in the JAX package.
flax defaults mirrored: GroupNorm eps 1e-6, the conformer's LayerNorms eps
1e-5.  Everything computes in fp32 (the JAX config's ``dtype`` is
"float32" by default; another dtype raises).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ACEStepDiTConfig:
    """The JAX package's checkpoint-layout widths (unchecked against the
    published ``config.json``, which is not in the repository)."""
    in_channels: int = 8
    num_layers: int = 28
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    mlp_ratio: float = 4.0
    out_channels: int = 8
    rope_theta: float = 1_000_000.0
    speaker_embedding_dim: int = 512
    text_embedding_dim: int = 768
    lyric_vocab_size: int = 6681
    lyric_hidden_size: int = 1024
    patch_height: int = 16
    ssl_latent_dims: Sequence[int] = (1024, 768)
    ssl_encoder_depths: Sequence[int] = (9, 9)
    dtype: str = "float32"

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def _rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Affine-less RMSNorm over the last axis, in fp32."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)).to(x.dtype)


def rope_tables(seq_len: int, dim: int, theta: float, device=None):
    """Qwen2-style (seq, dim) fp32 cos/sin, the frequencies duplicated
    along the feature axis."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    freqs = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, h, s, d): pairs (x0, x1), (x2, x3), ... rotated with the
    half-duplicated tables, as upstream does."""
    xr, xi = x[..., 0::2], x[..., 1::2]
    rot = torch.stack([-xi, xr], dim=-1).reshape(x.shape)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


class _Attention(nn.Module):
    """``to_q``, ``to_k``, ``to_v`` and ``to_out.0`` under upstream's names."""

    def __init__(self, dim: int, inner: int, kv_dim: int | None = None):
        super().__init__()
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(kv_dim or dim, inner)
        self.to_v = nn.Linear(kv_dim or dim, inner)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])


class LiteLASelfAttention(_Attention):
    """ReLU-kernel linear attention: (v kᵀ) q over a ones-row denominator,
    fp32 sums in the JAX module's order.  ``q_scale`` is ERG's temperature
    on ``to_q``'s output."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__(dim, heads * head_dim)
        self.heads = heads

    def forward(self, x, mask, cos, sin, q_scale: float = 1.0):
        q = self.to_q(x) * q_scale
        q, k, v = (_split_heads(a, self.heads) for a in (q, self.to_k(x), self.to_v(x)))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if mask is not None:
            m = mask.to(q.dtype)[:, None, :, None]
            q, k, v = q * m, k * m, v * m
        q, k, v = F.relu(q).float(), F.relu(k).float(), v.float()
        vk = torch.einsum("bhsd,bhse->bhde", v, k)
        num = torch.einsum("bhte,bhde->bhtd", q, vk)
        den = torch.einsum("bhte,bhe->bht", q, k.sum(dim=2))
        out = _merge_heads(num / (den[..., None] + 1e-15)).to(x.dtype)
        return self.to_out[0](out)


class SoftmaxCrossAttention(_Attention):
    """Softmax attention over the conditioning sequence, rope on q (latent
    positions) and k (conditioning positions), the -inf mask of
    mask_q x mask_kv."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__(dim, heads * head_dim)
        self.heads, self.head_dim = heads, head_dim

    def forward(self, x, enc, mask, enc_mask, cos, sin, cos_c, sin_c, q_scale: float = 1.0):
        q = self.to_q(x) * q_scale
        q, k, v = (_split_heads(a, self.heads) for a in (q, self.to_k(enc), self.to_v(enc)))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos_c, sin_c)
        logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(self.head_dim)
        if mask is not None and enc_mask is not None:
            keep = (mask[:, :, None] * enc_mask[:, None, :])[:, None] == 1
            logits = logits.masked_fill(~keep, float("-inf"))
        w = torch.softmax(logits, dim=-1)
        out = _merge_heads(torch.einsum("bhts,bhsd->bhtd", w, v.float())).to(x.dtype)
        return self.to_out[0](out)


class _ConvLayer(nn.Module):
    """Upstream's ``ConvLayer``: the Conv1d is its ``conv``."""

    def __init__(self, cin: int, cout: int, k: int, groups: int = 1, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, padding=k // 2, groups=groups, bias=bias)


class GLUMBConv(nn.Module):
    """Sana's MBConv feed-forward on (b, t, c): 1x1 expand, SiLU, depthwise
    k3, a SiLU gate, 1x1 project without bias."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.hidden = hidden
        self.inverted_conv = _ConvLayer(dim, 2 * hidden, 1)
        self.depth_conv = _ConvLayer(2 * hidden, 2 * hidden, 3, groups=2 * hidden)
        self.point_conv = _ConvLayer(hidden, out, 1, bias=False)

    def forward(self, x):
        h = F.silu(self.inverted_conv.conv(x.transpose(1, 2)))
        h = self.depth_conv.conv(h)
        a, gate = h[:, :self.hidden], h[:, self.hidden:]
        return self.point_conv.conv(a * F.silu(gate)).transpose(1, 2)


class LinearTransformerBlock(nn.Module):
    """adaLN-single modulated lite linear attention, an un-normed residual
    cross-attention, and a modulated GLUMBConv."""

    def __init__(self, cfg: ACEStepDiTConfig):
        super().__init__()
        c = cfg
        dim = c.inner_dim
        self.dim = dim
        self.scale_shift_table = nn.Parameter(torch.randn(6, dim) / math.sqrt(dim))
        self.attn = LiteLASelfAttention(dim, c.num_attention_heads, c.attention_head_dim)
        self.cross_attn = SoftmaxCrossAttention(dim, c.num_attention_heads, c.attention_head_dim)
        self.ff = GLUMBConv(dim, int(dim * c.mlp_ratio), dim)

    def forward(self, x, enc, mask, enc_mask, cos, sin, cos_c, sin_c, temb,
                q_scale: float = 1.0):
        mods = self.scale_shift_table[None].to(temb.dtype) + temb.reshape(-1, 6, self.dim)
        s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = (mods[:, i:i + 1] for i in range(6))
        h = _rms(x) * (1 + sc_msa) + s_msa
        x = x + g_msa * self.attn(h, mask, cos, sin, q_scale)
        x = x + self.cross_attn(x, enc, mask, enc_mask, cos, sin, cos_c, sin_c, q_scale)
        h = _rms(x) * (1 + sc_mlp) + s_mlp
        return x + g_mlp * self.ff(h)


class PatchEmbedIn(nn.Module):
    """Latents (b, c, 16, t) -> tokens (b, t, inner): upstream's
    ``early_conv_layers``."""

    def __init__(self, cfg: ACEStepDiTConfig):
        super().__init__()
        c = cfg
        mid = c.in_channels * 256
        self.early_conv_layers = nn.Sequential(
            nn.Conv2d(c.in_channels, mid, (c.patch_height, 1), stride=(c.patch_height, 1)),
            nn.GroupNorm(32, mid, eps=1e-6),
            nn.Conv2d(mid, c.inner_dim, 1))

    def forward(self, latent):
        x = self.early_conv_layers(latent.float())       # (b, inner, 1, t)
        return x.flatten(2).transpose(1, 2)


class T2IFinalLayerOut(nn.Module):
    """Modulated RMSNorm, a Linear, and the unpatchify to (b, out, 16, t)."""

    def __init__(self, cfg: ACEStepDiTConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.scale_shift_table = nn.Parameter(torch.randn(2, c.inner_dim) / math.sqrt(c.inner_dim))
        self.linear = nn.Linear(c.inner_dim, c.patch_height * c.out_channels)

    def forward(self, x, embedded_t, output_length: int):
        c = self.cfg
        mods = self.scale_shift_table[None].to(embedded_t.dtype) + embedded_t[:, None]
        x = _rms(x) * (1 + mods[:, 1:2]) + mods[:, 0:1]
        x = self.linear(x)
        b, t, _ = x.shape
        x = x.reshape(b, t, c.patch_height, c.out_channels).permute(0, 3, 2, 1)
        if output_length > t:
            x = F.pad(x, (0, output_length - t))
        return x[..., :output_length]


class _TimestepEmbedder(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(256, dim)
        self.linear_2 = nn.Linear(dim, dim)


class ACEStepDiT(nn.Module):
    """The conditional flow-matching transformer; ``forward`` is upstream's
    (``encode`` then ``decode``), torch layouts at the boundary."""

    def __init__(self, cfg: ACEStepDiTConfig = ACEStepDiTConfig()):
        super().__init__()
        c = cfg
        if c.dtype != "float32":
            raise NotImplementedError(f"ACEStepDiT computes in fp32, not {c.dtype}")
        self.cfg = c
        d = c.inner_dim
        self.timestep_embedder = _TimestepEmbedder(d)
        self.t_block = nn.Sequential(nn.SiLU(), nn.Linear(d, 6 * d))
        self.speaker_embedder = nn.Linear(c.speaker_embedding_dim, d)
        self.genre_embedder = nn.Linear(c.text_embedding_dim, d)
        self.lyric_embs = nn.Embedding(c.lyric_vocab_size, c.lyric_hidden_size)
        self.lyric_proj = nn.Linear(c.lyric_hidden_size, d)
        self.proj_in = PatchEmbedIn(c)
        self.transformer_blocks = nn.ModuleList(LinearTransformerBlock(c)
                                                for _ in range(c.num_layers))
        self.final_layer = T2IFinalLayerOut(c)
        self.projectors = nn.ModuleList(
            nn.Sequential(nn.Linear(d, 2 * d), nn.SiLU(), nn.Linear(2 * d, 2 * d), nn.SiLU(),
                          nn.Linear(2 * d, ssl_dim))
            for ssl_dim in c.ssl_latent_dims)

    def time_embedding(self, timestep):
        """diffusers ``Timesteps(256, flip_sin_to_cos=True)`` and the MLP."""
        half = 128
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                            device=timestep.device) / half)
        ang = timestep.float()[:, None] * freqs[None]
        emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        te = self.timestep_embedder
        return te.linear_2(F.silu(te.linear_1(emb)))

    def embed_lyrics(self, lyric_token_idx):
        """The token embedding only; the conformer runs outside (see
        :class:`LyricConformerEncoder`) and ``encode`` takes its output."""
        return self.lyric_embs(lyric_token_idx.long())

    def encode(self, text_hidden, text_mask, speaker_embeds, lyric_hidden=None, lyric_mask=None):
        """The conditioning sequence [speaker (1) | genre | lyrics] and its mask."""
        spk = self.speaker_embedder(speaker_embeds)[:, None]
        parts = [spk, self.genre_embedder(text_hidden)]
        masks = [torch.ones((spk.shape[0], 1), dtype=text_mask.dtype, device=text_mask.device),
                 text_mask]
        if lyric_hidden is not None:
            parts.append(self.lyric_proj(lyric_hidden))
            masks.append(lyric_mask)
        return torch.cat(parts, dim=1), torch.cat(masks, dim=1)

    def decode(self, latent, attention_mask, enc, enc_mask, timestep,
               return_hidden: bool = False, q_tau: float = 1.0, q_tau_blocks: tuple = ()):
        """Latents (b, c, 16, t) -> velocity (b, c, 16, t); with
        ``return_hidden`` also the SSL projections of the inner states.
        ``q_tau`` scales ``to_q``'s output of the self- and cross-attention
        of the blocks in ``q_tau_blocks`` (ERG diffusion guidance)."""
        c = self.cfg
        output_length = latent.shape[-1]
        embedded_t = self.time_embedding(timestep)
        temb = self.t_block(embedded_t)
        x = self.proj_in(latent)
        cos, sin = rope_tables(x.shape[1], c.attention_head_dim, c.rope_theta, x.device)
        cos_c, sin_c = rope_tables(enc.shape[1], c.attention_head_dim, c.rope_theta, x.device)
        inner = []
        for i, blk in enumerate(self.transformer_blocks):
            x = blk(x, enc, attention_mask, enc_mask, cos, sin, cos_c, sin_c, temb,
                    q_scale=q_tau if i in q_tau_blocks else 1.0)
            inner.extend(x for d in c.ssl_encoder_depths if i == d)
        out = self.final_layer(x, embedded_t, output_length)
        if not return_hidden:
            return out
        return out, [mlp(h) for h, mlp in zip(inner, self.projectors)]

    def forward(self, latent, attention_mask, text_hidden, text_mask, speaker_embeds, timestep,
                lyric_hidden=None, lyric_mask=None, return_hidden: bool = False):
        enc, enc_mask = self.encode(text_hidden, text_mask, speaker_embeds, lyric_hidden,
                                    lyric_mask)
        return self.decode(latent, attention_mask, enc, enc_mask, timestep,
                           return_hidden=return_hidden)


# ----------------------------------------------------------- lyric conformer

def espnet_rel_pe(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """espnet's relative positional table, rows for relative positions
    t-1 ... -(t-1), sin/cos interleaved: (2t-1, dim) fp32."""
    rels = (seq_len - 1) - torch.arange(2 * seq_len - 1, dtype=torch.float32, device=device)
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    ang = rels[:, None] * div[None]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(2 * seq_len - 1, dim)


class RelPosSelfAttention(nn.Module):
    """Transformer-XL attention on espnet tables; the rel-shift is the
    gather bd[i, t-1-i+j].  ``q_scale`` scales ``linear_q``'s output before
    the position biases (ERG lyric guidance)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads, dk = heads, dim // heads
        self.linear_q = nn.Linear(dim, dim)
        self.linear_k = nn.Linear(dim, dim)
        self.linear_v = nn.Linear(dim, dim)
        self.linear_out = nn.Linear(dim, dim)
        self.linear_pos = nn.Linear(dim, dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, dk))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, dk))

    def forward(self, x, mask, pos, q_scale: float = 1.0):
        b, t, d = x.shape
        h = self.heads
        dk = d // h
        q = self.linear_q(x) * q_scale
        q, k, v = (_split_heads(a, h) for a in (q, self.linear_k(x), self.linear_v(x)))
        p = self.linear_pos(pos).reshape(-1, h, dk).transpose(0, 1)     # (h, 2t-1, dk)
        ac = torch.einsum("bhtd,bhsd->bhts", (q + self.pos_bias_u[None, :, None]).float(),
                          k.float())
        bd = torch.einsum("bhtd,hmd->bhtm", (q + self.pos_bias_v[None, :, None]).float(),
                          p.float())
        ar = torch.arange(t, device=x.device)
        idx = (t - 1) - ar[:, None] + ar[None]
        bd = torch.gather(bd, -1, idx[None, None].expand(b, h, t, t))
        scores = (ac + bd) / math.sqrt(dk)
        if mask is not None:
            m = mask[:, None, None, :] > 0
            attn = torch.softmax(scores.masked_fill(~m, float("-inf")), dim=-1)
            attn = torch.where(m, attn, torch.zeros_like(attn))
        else:
            attn = torch.softmax(scores, dim=-1)
        out = _merge_heads(torch.einsum("bhts,bhsd->bhtd", attn, v.float())).to(x.dtype)
        return self.linear_out(out)


class _LinearEmbed(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.out = nn.Sequential(nn.Linear(in_dim, dim), nn.LayerNorm(dim, eps=1e-5))


class _FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.w_1 = nn.Linear(dim, ffn_dim)
        self.w_2 = nn.Linear(ffn_dim, dim)


class _ConformerLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ffn_dim: int):
        super().__init__()
        self.self_attn = RelPosSelfAttention(dim, heads)
        self.feed_forward = _FeedForward(dim, ffn_dim)
        self.norm_mha = nn.LayerNorm(dim, eps=1e-5)
        self.norm_ff = nn.LayerNorm(dim, eps=1e-5)


class LyricConformerEncoder(nn.Module):
    """ACE-Step's lyric encoder at its instantiated defaults (no macaron, no
    convolution module, no chunking): a pre-norm rel-pos transformer, the
    LinearEmbed (Linear, LayerNorm, times sqrt(dim)), ``num_blocks`` of
    [LN, rel-pos MHA, +res, LN, SiLU FF, +res] and a final LayerNorm.
    ``in_dim`` is the embedding's width (``dim`` when None)."""

    def __init__(self, dim: int = 1024, heads: int = 16, ffn_dim: int = 4096,
                 num_blocks: int = 6, in_dim: int | None = None):
        super().__init__()
        self.dim = dim
        self.embed = _LinearEmbed(in_dim or dim, dim)
        self.encoders = nn.ModuleList(_ConformerLayer(dim, heads, ffn_dim)
                                      for _ in range(num_blocks))
        self.after_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, mask=None, q_tau: float = 1.0, q_tau_layers: tuple = ()):
        x = self.embed.out(x.float()) * math.sqrt(self.dim)
        pos = espnet_rel_pe(x.shape[1], self.dim, x.device)
        for i, layer in enumerate(self.encoders):
            x = x + layer.self_attn(layer.norm_mha(x), mask, pos,
                                    q_scale=q_tau if i in q_tau_layers else 1.0)
            ff = layer.feed_forward
            x = x + ff.w_2(F.silu(ff.w_1(layer.norm_ff(x))))
        return self.after_norm(x)
