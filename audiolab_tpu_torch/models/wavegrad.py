"""WaveGrad-style score network for diffusion timbre transfer (counterpart
of audiolab_tpu/models/wavegrad.py; reference modules/wavetransfer/).

  - a WaveGrad UNet conditioned on a mel and a continuous noise level
    (modules/wavetransfer/model.py): DBlocks downsample the noisy waveform
    into FiLM conditioners, UBlocks upsample the mel with FiLM modulation
  - trained with L1 on the predicted noise (learner.py)
  - sampled over a short schedule (bddm/sampler.py:38)

The layers run on torch's (b, channels, t) layout; :class:`WaveGrad` takes
and returns the JAX module's layouts (audio (b, n), mel (b, t, n_mels)).
Module names are the flax ones (``d_in``, ``film_i.{conv,emb}``,
``dblock_i.{res,c0,c1,c2}``, ``u_in``, ``ublock_i.{res,c0..c3}``,
``u_out``).  flax's ``padding="SAME"`` is reproduced exactly: a strided
convolution pads asymmetrically (the low side gets the floor of half the
total), so every convolution here pads by hand.

Everything is fp32; on the card TF32 is off (core/precision.py, applied by
``sample`` and the trainer's entry points), so the convolutions run in full
fp32: cuDNN's default TF32 moves a full-width gradient by up to 1e-3 of its
max.  The randomness is explicit: ``sample`` takes its draws (or makes them
from a generator before the loop), and ``diffusion_loss`` takes the noise
level and the noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device


@dataclass(frozen=True)
class WaveGradConfig:
    n_mels: int = 128
    hop: int = 300                      # prod(factors)
    factors: Sequence[int] = (5, 5, 3, 2, 2)
    ublock_ch: Sequence[int] = (512, 512, 256, 128, 128)
    dblock_ch: Sequence[int] = (128, 128, 256, 512)
    base_ch: int = 32


def same_padding(n: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """(low, high) padding of flax's ``padding="SAME"`` for length ``n``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - n, 0)
    return total // 2, total - total // 2


class SameConv1d(nn.Conv1d):
    """``nn.Conv1d`` with flax's SAME padding, computed from the input length."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = same_padding(x.shape[-1], self.kernel_size[0], self.stride[0], self.dilation[0])
        return F.conv1d(F.pad(x, pad), self.weight, self.bias, self.stride, 0, self.dilation)


@torch.no_grad()
def lecun_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """flax's default initialisers from a generator seeded with ``seed``:
    kernels truncated normal of variance 1/fan_in (lecun_normal), biases 0."""
    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(seed)
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        fan_in = p[0].numel()
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    return module


def noise_level_embedding(scale: torch.Tensor, dim: int = 512) -> torch.Tensor:
    """Continuous sqrt-alpha-cumprod -> Fourier embedding (b, dim)."""
    half = dim // 2
    freqs = torch.exp(-np.log(1e4) * torch.arange(half, dtype=torch.float32,
                                                  device=scale.device) / half)
    args = scale[:, None] * freqs[None, :] * 5000.0
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class FiLM(nn.Module):
    def __init__(self, in_ch: int, features: int, emb_dim: int = 512):
        super().__init__()
        self.conv = SameConv1d(in_ch, features, 3)
        self.emb = nn.Linear(emb_dim, 2 * features)

    def forward(self, x, noise_emb):
        """x (b, c, t) conditioning features; noise_emb (b, d) -> shift
        (b, features, t), scale (b, features, 1)."""
        h = self.conv(x)
        shift, s = self.emb(F.silu(noise_emb))[:, :, None].chunk(2, dim=1)
        return shift + h, s


class DBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, factor: int):
        super().__init__()
        self.res = SameConv1d(in_ch, features, 1, stride=factor)
        self.c0 = SameConv1d(in_ch, features, 3, stride=factor)
        self.c1 = SameConv1d(features, features, 3, dilation=2)
        self.c2 = SameConv1d(features, features, 3, dilation=4)

    def forward(self, x):
        h = x
        for conv in (self.c0, self.c1, self.c2):
            h = conv(F.silu(h))
        return h + self.res(x)


class UBlock(nn.Module):
    def __init__(self, in_ch: int, features: int, factor: int):
        super().__init__()
        self.factor = factor
        self.res = SameConv1d(in_ch, features, 1)
        self.c0 = SameConv1d(in_ch, features, 3)
        self.c1 = SameConv1d(features, features, 3, dilation=2)
        self.c2 = SameConv1d(features, features, 3, dilation=4)
        self.c3 = SameConv1d(features, features, 3, dilation=8)

    def forward(self, x, shift, scale):
        up = x.repeat_interleave(self.factor, dim=-1)
        res = self.res(up)
        h = self.c0(F.silu(x).repeat_interleave(self.factor, dim=-1))
        shift = shift[..., : h.shape[-1]]
        h = self.c1(F.silu(h * scale + shift))
        h = h + res
        h2 = self.c2(F.silu(h * scale + shift))
        h2 = self.c3(F.silu(h2))
        return h + h2


class WaveGrad(nn.Module):
    """eps = f(noisy_audio, mel, noise_scale)."""

    def __init__(self, cfg: WaveGradConfig = WaveGradConfig()):
        super().__init__()
        self.cfg = c = cfg
        n_up = len(c.factors)
        self.d_in = SameConv1d(1, c.base_ch, 5)
        self.film_0 = FiLM(c.base_ch, c.ublock_ch[n_up - 1])
        ch = c.base_ch
        for i, (dch, f) in enumerate(zip(c.dblock_ch, c.factors[::-1][:-1])):
            setattr(self, f"dblock_{i}", DBlock(ch, dch, f))
            setattr(self, f"film_{i + 1}", FiLM(dch, c.ublock_ch[n_up - 2 - i]))
            ch = dch
        self.n_films = len(c.dblock_ch) + 1
        self.u_in = SameConv1d(c.n_mels, c.ublock_ch[0], 3)
        ch = c.ublock_ch[0]
        for i, (uch, f) in enumerate(zip(c.ublock_ch, c.factors)):
            setattr(self, f"ublock_{i}", UBlock(ch, uch, f))
            ch = uch
        self.u_out = SameConv1d(ch, 1, 3)

    def forward(self, audio, mel, noise_scale):
        """audio (b, t*hop), mel (b, t, n_mels), noise_scale (b,) in (0, 1)
        -> eps (b, t*hop)."""
        emb = noise_level_embedding(noise_scale)
        d = self.d_in(audio[:, None, :])
        films = [self.film_0(d, emb)]
        for i in range(self.n_films - 1):
            d = getattr(self, f"dblock_{i}")(d)
            films.append(getattr(self, f"film_{i + 1}")(d, emb))
        u = self.u_in(mel.transpose(1, 2))
        for i in range(len(self.cfg.factors)):
            shift, s = films[len(films) - 1 - i]
            u = getattr(self, f"ublock_{i}")(u, shift, s)
        return self.u_out(u)[:, 0]


# ------------------------------------------------------------------ diffusion

def make_beta_schedule(n: int, start: float = 1e-4, end: float = 0.05) -> np.ndarray:
    return np.linspace(start, end, n, dtype=np.float64)


@dataclass(frozen=True)
class NoiseSchedule:
    betas: np.ndarray

    @property
    def alphas(self) -> np.ndarray:
        return 1.0 - self.betas

    @property
    def alpha_cum(self) -> np.ndarray:
        return np.cumprod(self.alphas)

    @property
    def sqrt_alpha_cum(self) -> np.ndarray:
        return np.sqrt(self.alpha_cum)


TRAIN_SCHEDULE = NoiseSchedule(make_beta_schedule(1000, 1e-6, 0.01))
FAST_6 = NoiseSchedule(np.array([1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1]))
FAST_12 = NoiseSchedule(make_beta_schedule(12, 1e-6, 0.12))


def sample_noise_level(gen: torch.Generator, batch: int,
                       schedule: NoiseSchedule = TRAIN_SCHEDULE) -> torch.Tensor:
    """Continuous noise level (b,): uniform in [sqrt_ac[s+1], sqrt_ac[s]] for
    a random segment s (WaveGrad's training trick: schedule-free
    inference), drawn from ``gen`` on its device."""
    dev = gen.device
    sac = torch.tensor(np.concatenate([[1.0], schedule.sqrt_alpha_cum]),
                       dtype=torch.float32, device=dev)
    s = torch.randint(0, len(schedule.betas), (batch,), generator=gen, device=dev)
    u = torch.rand((batch,), generator=gen, device=dev)
    lo, hi = sac[s + 1], sac[s]
    return lo + u * (hi - lo)


def loss_draws(batch: int, n: int, seed: int, device: torch.device,
               schedule: NoiseSchedule = TRAIN_SCHEDULE) -> tuple[torch.Tensor, torch.Tensor]:
    """(noise level (b,), eps (b, n)) for one training step, from a
    generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = sample_noise_level(gen, batch, schedule)
    return scale, torch.randn((batch, n), generator=gen, device=device)


def diffusion_loss(model: WaveGrad, audio, mel, scale, eps) -> torch.Tensor:
    """L1(eps, eps_hat) at the continuous noise level ``scale`` (b,)
    (learner.py loss)."""
    s = scale[:, None]
    noisy = s * audio + torch.sqrt(1.0 - s ** 2) * eps
    return torch.mean(torch.abs(eps - model(noisy, mel, scale)))


def sample_draws(steps: int, batch: int, n: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    """(steps + 1, b, n) standard normal draws of :func:`sample`, from a
    generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((steps + 1, batch, n), generator=gen, device=device)


@torch.inference_mode()
def sample(model: WaveGrad, mel: torch.Tensor, schedule: NoiseSchedule = FAST_6,
           seed: int = 0, draws: torch.Tensor | None = None) -> torch.Tensor:
    """The reverse process over ``schedule`` -> audio (b, t*hop) in [-1, 1].

    ``draws`` (steps + 1, b, t*hop): ``draws[0]`` is the starting noise and
    ``draws[1 + i]`` the noise added after step ``i`` (unused at i = 0); by
    default they come from :func:`sample_draws` with ``seed``.  The JAX
    sampler draws the same roles from ``PRNGKey(seed)`` and
    ``fold_in(key, i)``."""
    dev = resolve_device(mel.device)
    b, t, _ = mel.shape
    n = t * model.cfg.hop
    steps = len(schedule.betas)
    if draws is None:
        draws = sample_draws(steps, b, n, seed, dev)
    if tuple(draws.shape) != (steps + 1, b, n):
        raise ValueError(f"draws {tuple(draws.shape)}, expected {(steps + 1, b, n)}")
    betas = torch.tensor(schedule.betas, dtype=torch.float32, device=dev)
    alphas = 1.0 - betas
    acum = torch.cumprod(alphas, 0)
    sac = torch.sqrt(acum)
    x = draws[0]
    for i in range(steps - 1, -1, -1):
        c1 = 1.0 / torch.sqrt(alphas[i])
        c2 = betas[i] / torch.sqrt(1.0 - acum[i])
        eps_hat = model(x, mel, sac[i].expand(b))
        x = c1 * (x - c2 * eps_hat)
        if i > 0:
            x = x + torch.sqrt(betas[i]) * draws[1 + i]
    return torch.clamp(x, -1.0, 1.0)
