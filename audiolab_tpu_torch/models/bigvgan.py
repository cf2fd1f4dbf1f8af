"""BigVGAN-class vocoder: mel -> waveform (counterpart of
audiolab_tpu/models/bigvgan.py).  A HiFi-GAN generator with snake
activations in the residual blocks, the anti-aliasing filters folded into
the convolutions as in the JAX package.  Works on (b, t, n_mels) and
returns (b, t * hop), as the JAX module does; the layers run on torch's
(b, channels, t) layout.  Parameter names follow the JAX module's
(``conv_pre``, ``snake_up_i``, ``up_i``, ``amp_i_j.{snake1,conv1,snake2,
conv2}_d``, ``snake_post``, ``conv_post``), which no converter maps."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from audiolab_tpu_torch.models.codecs import Snake
from audiolab_tpu_torch.models.layers import Conv1d, ConvTranspose1d


@dataclass(frozen=True)
class BigVGANConfig:
    n_mels: int = 128
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3

    @property
    def hop(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


class AMPBlock(nn.Module):
    """Snake-activated residual block (BigVGAN AMPBlock1)."""

    def __init__(self, channels: int, kernel: int, dilations: Sequence[int]):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            setattr(self, f"snake1_{i}", Snake(channels))
            setattr(self, f"conv1_{i}", Conv1d(channels, channels, kernel, dilation=d))
            setattr(self, f"snake2_{i}", Snake(channels))
            setattr(self, f"conv2_{i}", Conv1d(channels, channels, kernel))

    def forward(self, x):
        for i in range(self.n):
            h = getattr(self, f"conv1_{i}")(getattr(self, f"snake1_{i}")(x))
            x = x + getattr(self, f"conv2_{i}")(getattr(self, f"snake2_{i}")(h))
        return x


class BigVGAN(nn.Module):
    """The generator without the JAX module's optional speaker input (no
    caller passes one)."""

    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        c = self.cfg = cfg
        ch = c.upsample_initial_channel
        self.conv_pre = Conv1d(c.n_mels, ch, 7)
        self.n_up, self.n_res = len(c.upsample_rates), len(c.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(c.upsample_rates, c.upsample_kernel_sizes)):
            setattr(self, f"snake_up_{i}", Snake(ch))
            setattr(self, f"up_{i}", ConvTranspose1d(ch, ch // 2, k, u))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(c.resblock_kernel_sizes,
                                             c.resblock_dilation_sizes)):
                setattr(self, f"amp_{i}_{j}", AMPBlock(ch, rk, tuple(rd)))
        self.snake_post = Snake(ch)
        self.conv_post = Conv1d(ch, 1, 7, bias=False)

    def forward(self, mel):
        """(b, t, n_mels) -> (b, t * hop)."""
        x = self.conv_pre(mel.transpose(1, 2))
        for i in range(self.n_up):
            x = getattr(self, f"up_{i}")(getattr(self, f"snake_up_{i}")(x))
            xs = sum(getattr(self, f"amp_{i}_{j}")(x) for j in range(self.n_res))
            x = xs / self.n_res
        x = self.conv_post(self.snake_post(x))
        return torch.tanh(x)[:, 0]
