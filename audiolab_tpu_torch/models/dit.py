"""Diffusion transformer (DiT) shared by the in-repo Stable Audio and
ACE-Step models (counterpart of audiolab_tpu/models/dit.py): latent frames
as tokens, AdaLN timestep modulation, cross-attention over the text
context, an MLP.

The JAX module's flax defaults, mirrored:

- ``nn.Dense(dtype=bf16)`` keeps fp32 parameters and computes in bf16 (the
  input, kernel and bias cast to bf16, a bf16 result): :class:`Dense` casts
  at every call.  ``proj_in``, the timestep MLP, ``ctx_proj``, the AdaLN
  projections and ``proj_out`` have no dtype and run in fp32, so the
  residual stream stays fp32 (``x + g1 * o`` promotes the bf16 ``o``).
- ``nn.LayerNorm`` takes eps 1e-6; ``ln1``, ``ln2`` and ``final_ln`` have
  neither scale nor bias, ``lnx`` both.
- ``nn.gelu`` is the tanh form.

Self-attention goes through :func:`~audiolab_tpu_torch.kernels.attention.flash_attention`
on the head-major layout, as the JAX block passes ``jnp.swapaxes`` views: a
bf16 call over more than 128 keys is K2 on its Hopper route
(``k2h_kernel``), an fp32 one K2's fp32 kernel.  Cross-attention is the
plain :func:`attention_reference` with the context mask, as in the JAX
block.  Rope is the LM core's (``models/lm.py``).

Parameter names are the flax tree's, joined by ``.`` (``block_N.wq``,
``block_N.adaln.mod``, ``final_adaln.mod``, ...): the in-repo model has no
upstream checkpoint layout.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.attention import attention_reference, flash_attention
from audiolab_tpu_torch.models.lm import LMConfig, apply_rope, rope_freqs

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class DiTConfig:
    dim: int = 1024
    n_layers: int = 16
    n_heads: int = 16
    cond_dim: int = 768          # cross-attention context width
    in_dim: int = 64             # latent channels
    out_dim: int = 64
    mlp_ratio: int = 4
    dtype: str = "bfloat16"


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: fp32 parameters, input, weight and bias
    cast to ``dtype`` at the call (no ``dtype``: computed in the input's)."""

    def __init__(self, cin: int, cout: int, bias: bool = True, dtype: torch.dtype | None = None):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal (b,) -> (b, dim), [cos, sin] of t * 1000 * freqs."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :] * 1000.0
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class AdaLNModulation(nn.Module):
    """silu(c) -> Dense(n_params * dim) -> n_params tensors (b, 1, dim)."""

    def __init__(self, dim: int, n_params: int = 6):
        super().__init__()
        self.n_params = n_params
        self.mod = nn.Linear(dim, n_params * dim)

    def forward(self, c: torch.Tensor):
        h = self.mod(F.silu(c))
        return torch.chunk(h[:, None, :], self.n_params, dim=-1)


def modulate(x, shift, scale):
    return x * (1.0 + scale) + shift


def _ln(x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(use_bias=False, use_scale=False)``."""
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        c = cfg
        dt = _DTYPES[c.dtype]
        self.cfg = c
        self.adaln = AdaLNModulation(c.dim, 6)
        for name in ("wq", "wk", "wv", "wo", "xq", "xk", "xv", "xo"):
            setattr(self, name, Dense(c.dim, c.dim, bias=False, dtype=dt))
        self.lnx = nn.LayerNorm(c.dim, eps=1e-6)
        self.fc1 = Dense(c.dim, c.dim * c.mlp_ratio, dtype=dt)
        self.fc2 = Dense(c.dim * c.mlp_ratio, c.dim, dtype=dt)
        self.register_buffer("freqs", torch.tensor(rope_freqs(LMConfig(dim=c.dim,
                                                                       n_heads=c.n_heads))),
                             persistent=False)

    def forward(self, x, t_emb, context=None, context_mask=None):
        c = self.cfg
        hd = c.dim // c.n_heads
        b, tlen, _ = x.shape
        sh1, sc1, g1, sh2, sc2, g2 = self.adaln(t_emb)

        h = modulate(_ln(x), sh1, sc1)
        q = self.wq(h).reshape(b, tlen, c.n_heads, hd)
        k = self.wk(h).reshape(b, tlen, c.n_heads, hd)
        v = self.wv(h).reshape(b, tlen, c.n_heads, hd)
        pos = torch.arange(tlen, device=x.device)
        q, k = apply_rope(q, pos, self.freqs), apply_rope(k, pos, self.freqs)
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        o = self.wo(o.transpose(1, 2).reshape(b, tlen, c.dim))
        x = x + g1 * o

        if context is not None:
            s = context.shape[1]
            hx = self.lnx(x)
            qx = self.xq(hx).reshape(b, tlen, c.n_heads, hd)
            kx = self.xk(context).reshape(b, s, c.n_heads, hd)
            vx = self.xv(context).reshape(b, s, c.n_heads, hd)
            mask = None if context_mask is None else (context_mask[:, None, None, :] != 0)
            ox = attention_reference(qx.transpose(1, 2), kx.transpose(1, 2),
                                     vx.transpose(1, 2), mask=mask)
            x = x + self.xo(ox.transpose(1, 2).reshape(b, tlen, c.dim))

        h = modulate(_ln(x), sh2, sc2)
        h = self.fc2(F.gelu(self.fc1(h), approximate="tanh"))
        return x + g2 * h


class DiT(nn.Module):
    """(latents (b, t, in_dim), t (b,), context (b, s, cond_dim)) -> (b, t, out_dim)."""

    def __init__(self, cfg: DiTConfig = DiTConfig(), global_dim: int | None = None):
        """``global_dim``: the width of a global conditioning vector, projected
        by ``gc`` onto the timestep embedding (the JAX module creates ``gc``
        when it is called with one)."""
        super().__init__()
        c = cfg
        self.cfg = c
        self.proj_in = nn.Linear(c.in_dim, c.dim)
        self.t1 = nn.Linear(256, c.dim)
        self.t2 = nn.Linear(c.dim, c.dim)
        self.gc = None if global_dim is None else nn.Linear(global_dim, c.dim)
        self.ctx_proj = nn.Linear(c.cond_dim, c.dim)
        for i in range(c.n_layers):
            self.add_module(f"block_{i}", DiTBlock(c))
        self.final_adaln = AdaLNModulation(c.dim, 2)
        self.proj_out = nn.Linear(c.dim, c.out_dim)

    def forward(self, x, t, context=None, context_mask=None, global_cond=None,
                return_hidden_at: int | None = None):
        """``return_hidden_at=k`` also returns the hidden states after block k
        (the ACE-Step SSL projection tap)."""
        c = self.cfg
        h = self.proj_in(x.float())
        t_emb = self.t2(F.silu(self.t1(timestep_embedding(t))))
        if global_cond is not None:
            t_emb = t_emb + self.gc(global_cond)
        ctx = None if context is None else self.ctx_proj(context.float())
        inner = None
        for i in range(c.n_layers):
            h = getattr(self, f"block_{i}")(h, t_emb, ctx, context_mask)
            if return_hidden_at is not None and i == return_hidden_at:
                inner = h
        sh, sc = self.final_adaln(t_emb)
        out = self.proj_out(modulate(_ln(h), sh, sc))
        if return_hidden_at is not None:
            return out, inner
        return out
