"""Stable-Audio-class text-to-audio latent diffusion, the in-repo model
(counterpart of audiolab_tpu/models/stable_audio.py): an Oobleck VAE, the
shared DiT (``models/dit.py``), a byte-level text encoder, timing tokens,
v-objective DDIM sampling with classifier-free guidance.

flax defaults mirrored: ``nn.LayerNorm`` eps 1e-6 with scale and bias,
``nn.gelu`` the tanh form, ``Conv(padding="SAME")`` padded as flax pads it
(strided: :class:`~audiolab_tpu_torch.models.wavegrad.SameConv1d`),
``ConvTranspose(padding="SAME")`` without the kernel flip
(:class:`~audiolab_tpu_torch.models.codecs._ConvTransposeSame`, the
converters' flip on the torch weight).  :class:`TextEncoder`'s attention is
flax's ``MultiHeadDotProductAttention``: its query, key and value kernels
are laid out (dim, heads, head_dim) with a (heads, head_dim) bias, its
output projection ``out`` (heads, head_dim, dim); here each is a Linear
over heads * head_dim (``utils/weights.py`` reshapes), the query scaled by
1/sqrt(head_dim) before the product, softmax in fp32.

The modules take and return the JAX package's (batch, time, channels)
layout.  Parameter names are the flax tree's joined by ``.``; the only
draws (the starting latents, the VAE's posterior noise) are arguments or
come from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.models.codecs import Snake, _ConvSame, _ConvTransposeSame
from audiolab_tpu_torch.models.dit import DiT, DiTConfig, timestep_embedding
from audiolab_tpu_torch.models.ksampler import linspace_f32
from audiolab_tpu_torch.models.wavegrad import SameConv1d

# ------------------------------------------------------------------ VAE


@dataclass(frozen=True)
class OobleckConfig:
    channels: int = 2
    latent_dim: int = 64
    base_ch: int = 128
    ratios: Sequence[int] = (2, 4, 4, 8, 8)   # prod = 2048

    @property
    def hop(self) -> int:
        return int(np.prod(self.ratios))


class OobleckResUnit(nn.Module):
    """Snake -> Conv(7, dilation, SAME) -> Snake -> Conv(1), residual, on (b, ch, t)."""

    def __init__(self, features: int, dilation: int = 1):
        super().__init__()
        self.s1 = Snake(features)
        self.c1 = _ConvSame(features, features, 7, dilation)
        self.s2 = Snake(features)
        self.c2 = nn.Conv1d(features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.c2(self.s2(self.c1(self.s1(x))))


class OobleckEncoder(nn.Module):
    """(b, n, channels) -> (mean, logvar), each (b, n / hop, latent_dim)."""

    def __init__(self, cfg: OobleckConfig = OobleckConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        self.conv_in = _ConvSame(c.channels, c.base_ch, 7)
        ch = c.base_ch
        for i, r in enumerate(c.ratios):
            cin, ch = ch, min(ch * 2, 8 * c.base_ch)
            for j in range(2):
                self.add_module(f"res_{i}_{j}", OobleckResUnit(cin, 3 ** j))
            self.add_module(f"snake_{i}", Snake(cin))
            self.add_module(f"down_{i}", SameConv1d(cin, ch, 2 * r, stride=r))
        self.snake_out = Snake(ch)
        self.conv_out = _ConvSame(ch, 2 * c.latent_dim, 3)

    def forward(self, audio: torch.Tensor):
        c = self.cfg
        h = self.conv_in(audio.transpose(1, 2))
        for i in range(len(c.ratios)):
            for j in range(2):
                h = getattr(self, f"res_{i}_{j}")(h)
            h = getattr(self, f"down_{i}")(getattr(self, f"snake_{i}")(h))
        stats = self.conv_out(self.snake_out(h)).transpose(1, 2)
        mean, logvar = torch.chunk(stats, 2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


class OobleckDecoder(nn.Module):
    """(b, t, latent_dim) -> (b, t * hop, channels)."""

    def __init__(self, cfg: OobleckConfig = OobleckConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        ch = min(c.base_ch * 2 ** len(c.ratios), 8 * c.base_ch)
        self.conv_in = _ConvSame(c.latent_dim, ch, 7)
        for i, r in enumerate(reversed(c.ratios)):
            cin, ch = ch, max(ch // 2, c.base_ch)
            self.add_module(f"snake_{i}", Snake(cin))
            self.add_module(f"up_{i}", _ConvTransposeSame(cin, ch, r))
            for j in range(2):
                self.add_module(f"res_{i}_{j}", OobleckResUnit(ch, 3 ** j))
        self.snake_out = Snake(ch)
        self.conv_out = _ConvSame(ch, c.channels, 7)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.transpose(1, 2))
        for i in range(len(self.cfg.ratios)):
            h = getattr(self, f"up_{i}")(getattr(self, f"snake_{i}")(h))
            for j in range(2):
                h = getattr(self, f"res_{i}_{j}")(h)
        return torch.tanh(self.conv_out(self.snake_out(h))).transpose(1, 2)


# ------------------------------------------------------------------ text encoder

class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, no dropout)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, t, dim = x.shape
        hd = dim // self.heads
        q = self.query(x).reshape(b, t, self.heads, hd) / math.sqrt(hd)
        k = self.key(x).reshape(b, t, self.heads, hd)
        v = self.value(x).reshape(b, t, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits.float(), dim=-1).to(v.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, dim))


class TextEncoder(nn.Module):
    """Byte-level bidirectional transformer: ids (b, t) -> (b, t, dim)."""

    def __init__(self, dim: int = 768, n_layers: int = 4, n_heads: int = 12, vocab: int = 256,
                 max_len: int = 128):
        super().__init__()
        self.n_layers = n_layers
        self.emb = nn.Embedding(vocab, dim)
        self.pos = nn.Parameter(torch.zeros(max_len, dim))
        for i in range(n_layers):
            self.add_module(f"ln1_{i}", nn.LayerNorm(dim, eps=1e-6))
            self.add_module(f"attn_{i}", MultiHeadAttention(dim, n_heads))
            self.add_module(f"ln2_{i}", nn.LayerNorm(dim, eps=1e-6))
            self.add_module(f"fc1_{i}", nn.Linear(dim, 4 * dim))
            self.add_module(f"fc2_{i}", nn.Linear(4 * dim, dim))
        self.final = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        x = self.emb(ids.long()) + self.pos[: ids.shape[1]]
        attn_mask = None if mask is None else (mask[:, None, None, :] != 0)
        for i in range(self.n_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            x = x + layer("attn")(layer("ln1")(x), attn_mask)
            x = x + layer("fc2")(F.gelu(layer("fc1")(layer("ln2")(x)), approximate="tanh"))
        return self.final(x)


def tokenize_prompt(text: str, max_len: int = 128) -> np.ndarray:
    """UTF-8 bytes of ``text``, cut and zero-padded to ``max_len`` (int32)."""
    b = text.encode("utf-8")[:max_len]
    ids = np.zeros(max_len, np.int32)
    ids[: len(b)] = np.frombuffer(b, np.uint8)
    return ids


class _Fourier(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(dim // 2))


class NumberEmbedder(nn.Module):
    """stable_audio_tools ``NumberEmbedder``: a normalized scalar (b,) in
    [0, 1] -> (b, features), [x, sin(2 pi x w), cos(2 pi x w)] then a Linear.
    Names are the checkpoint's (``embedding.0.weights``, ``embedding.1``),
    as ``convert_sao_number`` maps them under ``embedder``."""

    def __init__(self, features: int = 768, dim: int = 256):
        super().__init__()
        self.embedding = nn.ModuleList([_Fourier(dim), nn.Linear(dim + 1, features)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embedding[0].weights
        f = x.float()[:, None] * w[None, :] * (2.0 * np.pi)
        return self.embedding[1](torch.cat([x.float()[:, None], torch.sin(f), torch.cos(f)], -1))


# ------------------------------------------------------------------ model

@dataclass
class StableAudioConfig:
    sr: int = 44100
    max_seconds: float = 47.0
    vae: OobleckConfig = field(default_factory=OobleckConfig)
    dit: DiTConfig = field(default_factory=lambda: DiTConfig(
        dim=1024, n_layers=16, n_heads=16, cond_dim=768, in_dim=64, out_dim=64))
    text_dim: int = 768
    text_layers: int = 4


class StableAudioModel(nn.Module):
    def __init__(self, cfg: StableAudioConfig):
        super().__init__()
        c = cfg
        self.cfg = c
        self.vae_encoder = OobleckEncoder(c.vae)
        self.vae_decoder = OobleckDecoder(c.vae)
        self.dit = DiT(c.dit)
        self.text_encoder = TextEncoder(c.text_dim, c.text_layers, max(1, c.text_dim // 64))
        self.time_proj = nn.Linear(c.text_dim, c.text_dim)

    def encode_text(self, ids, mask=None):
        return self.text_encoder(ids, mask)

    def timing_tokens(self, seconds_start, seconds_total):
        """(b,) seconds -> (b, 2, text_dim) context tokens."""
        e1 = self.time_proj(timestep_embedding(seconds_start / 60.0, self.cfg.text_dim))
        e2 = self.time_proj(timestep_embedding(seconds_total / 60.0, self.cfg.text_dim))
        return torch.stack([e1, e2], dim=1)

    def denoise(self, z, t, context, context_mask=None, global_cond=None):
        return self.dit(z, t, context, context_mask, global_cond)

    def encode_audio(self, audio, noise: torch.Tensor | None = None):
        """The posterior's mean, or a sample with ``noise`` (standard normals
        of the mean's shape)."""
        mean, logvar = self.vae_encoder(audio)
        if noise is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * noise

    def decode_audio(self, z):
        return self.vae_decoder(z)

    def forward(self, audio, ids, t, noise: torch.Tensor | None = None):
        """Training forward: the v prediction on the encoded audio."""
        return self.denoise(self.encode_audio(audio, noise), t, self.encode_text(ids))


# ------------------------------------------------------------------ sampling

def v_to_eps_x0(v, z_t, t):
    """v-objective: v = alpha eps - sigma x0 with alpha = cos, sigma = sin."""
    alpha = torch.cos(t * np.pi / 2)[:, None, None]
    sigma = torch.sin(t * np.pi / 2)[:, None, None]
    return sigma * z_t + alpha * v, alpha * z_t - sigma * v


def latent_frames(seconds_total: float, sr: int, hop: int) -> int:
    return max(1, int(round(seconds_total * sr / hop)))


@torch.inference_mode()
def generate_audio(
    model: StableAudioModel,
    prompt: str,
    negative_prompt: str = "",
    seconds_total: float = 10.0,
    seconds_start: float = 0.0,
    steps: int = 50,
    cfg_scale: float = 7.0,
    init_audio: np.ndarray | None = None,
    init_strength: float = 0.8,
    seed: int = 0,
    batch: int = 1,
    z: torch.Tensor | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """DDIM v-diffusion sampling with CFG on ``device`` (the card unless the
    caller asks for the CPU); returns (b, n, channels).  ``z``: the starting
    latents (b, t_lat, latent_dim), else standard normals from a generator
    on the device seeded with ``seed``."""
    dev = resolve_device(device)
    c = model.cfg
    seconds_total = float(np.clip(seconds_total, 1.0, c.max_seconds))
    t_lat = latent_frames(seconds_total, c.sr, c.vae.hop)
    b = batch

    ids = np.stack([tokenize_prompt(prompt)] * b + [tokenize_prompt(negative_prompt)] * b)
    ctx = model.encode_text(torch.from_numpy(ids).to(dev))
    timing = model.timing_tokens(torch.full((2 * b,), float(seconds_start), device=dev),
                                 torch.full((2 * b,), seconds_total, device=dev))
    ctx = torch.cat([ctx, timing], dim=1)

    shape = (b, t_lat, c.vae.latent_dim)
    if z is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        z = torch.randn(shape, generator=gen, device=dev)
    z = torch.as_tensor(z, dtype=torch.float32, device=dev)
    if tuple(z.shape) != shape:
        raise ValueError(f"z {tuple(z.shape)}, expected {shape}")
    t_start = 1.0
    if init_audio is not None:
        z0 = model.encode_audio(torch.as_tensor(np.asarray(init_audio, np.float32), device=dev))
        z0 = z0[:, :t_lat]
        if z0.shape[1] < t_lat:
            z0 = F.pad(z0, (0, 0, 0, t_lat - z0.shape[1]))
        t_start = float(np.clip(init_strength, 0.05, 1.0))
        z = float(np.cos(t_start * np.pi / 2)) * z0 + float(np.sin(t_start * np.pi / 2)) * z

    ts = torch.from_numpy(linspace_f32(t_start, 0.0, steps + 1)).to(dev)
    for i in range(steps):
        t_cur, t_next = ts[i], ts[i + 1]
        v = model.denoise(torch.cat([z, z]), t_cur.expand(2 * b), ctx).float()
        vc, vu = v[:b], v[b:]
        v = vu + cfg_scale * (vc - vu)
        eps, x0 = v_to_eps_x0(v, z, t_cur.expand(b))
        z = torch.cos(t_next * np.pi / 2) * x0 + torch.sin(t_next * np.pi / 2) * eps
    return model.decode_audio(z).cpu().numpy()
