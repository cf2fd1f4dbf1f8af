"""The pieces of the decoder-only LM core that Zonos uses (counterpart of
audiolab_tpu/models/lm.py:32-76): the configuration, rotary tables and their
application, and RMSNorm.  ``TransformerLM`` and its decode loop come with
the models that use them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn


@dataclass(frozen=True)
class LMConfig:
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 16          # < n_heads => GQA
    ffn_dim: int = 5632
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def rope_freqs(cfg: LMConfig) -> np.ndarray:
    """(head_dim / 2,) float32 inverse frequencies, by the JAX package's numpy
    expression."""
    d = cfg.head_dim
    return (1.0 / (cfg.rope_theta ** (np.arange(0, d, 2) / d))).astype(np.float32)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Half-split rotary embedding of ``x`` (b, t, h, d) at positions ``pos``
    (b, t) or (t,), in fp32, returned in x's type."""
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[..., None].float() * freqs                 # (b, t, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * weight, statistics in fp32."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)
