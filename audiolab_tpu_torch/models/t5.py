"""T5 text encoder, the Stable-Audio prompt conditioner (counterpart of
audiolab_tpu/models/t5.py).

Architecture (t5-base v1.0): RMS layer norms (no bias, no mean
subtraction), attention with no 1/sqrt(d_kv) scale, a relative position bias
of 32 buckets (max distance 128) held by block 0 and shared by every layer,
a ReLU feed-forward; ``gated=True`` is v1.1's gated-GELU (``wi_0``/``wi_1``,
flax's tanh GELU) and ``per_layer_bias=True`` UMT5's bias per layer.  The
mask enters as an additive term of the dtype's lowest value on the logits,
and the output is multiplied by the mask, as the JAX encoder does.  The
attention is plain PyTorch: no kernel.

Parameter names are transformers' ``T5EncoderModel`` (``shared``,
``encoder.block.N.layer.0.SelfAttention.{q,k,v,o}``,
``...relative_attention_bias``, ``encoder.block.N.layer.1.DenseReluDense``,
``layer_norm``, ``encoder.final_layer_norm``), the names ``convert_t5`` maps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    dim: int = 768          # d_model
    d_kv: int = 64
    heads: int = 12
    d_ff: int = 3072
    layers: int = 12
    rel_buckets: int = 32
    rel_max_distance: int = 128
    gated: bool = False     # v1.1 gated-gelu FFN
    per_layer_bias: bool = False   # UMT5: each layer owns its rel bias
    eps: float = 1e-6


def t5_base() -> T5Config:
    return T5Config()


def umt5_base() -> T5Config:
    """ACE-Step's text encoder: gated FFN and a relative bias per layer."""
    return T5Config(vocab_size=256384, gated=True, per_layer_bias=True)


class T5LayerNorm(nn.Module):
    """RMS norm, statistics in fp32: no bias, no mean subtraction."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps).to(x.dtype) * self.weight


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """Bidirectional T5 bucket table (q_len, k_len), the JAX package's numpy
    expression."""
    ctx = np.arange(q_len, dtype=np.int64)[:, None]
    mem = np.arange(k_len, dtype=np.int64)[None, :]
    rel = mem - ctx
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * nb
    n = np.abs(rel)
    max_exact = nb // 2
    is_small = n < max_exact
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return ret + np.where(is_small, n, large)


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        c, inner = cfg, cfg.heads * cfg.d_kv
        self.cfg = c
        self.q = nn.Linear(c.dim, inner, bias=False)
        self.k = nn.Linear(c.dim, inner, bias=False)
        self.v = nn.Linear(c.dim, inner, bias=False)
        self.o = nn.Linear(inner, c.dim, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(c.rel_buckets, c.heads)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, q_scale: float = 1.0) -> torch.Tensor:
        """x (b, t, d); ``bias`` (b|1, h, t, t) with the mask in it.  ``q_scale``
        multiplies the query projection (ACE-Step's ERG hook)."""
        c = self.cfg
        b, t, _ = x.shape
        q = (self.q(x) * q_scale).reshape(b, t, c.heads, c.d_kv)
        k = self.k(x).reshape(b, t, c.heads, c.d_kv)
        v = self.v(x).reshape(b, t, c.heads, c.d_kv)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, t, c.heads * c.d_kv)
        return self.o(o)


class T5DenseReluDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        c = cfg
        self.gated = c.gated
        if c.gated:
            self.wi_0 = nn.Linear(c.dim, c.d_ff, bias=False)
            self.wi_1 = nn.Linear(c.dim, c.d_ff, bias=False)
        else:
            self.wi = nn.Linear(c.dim, c.d_ff, bias=False)
        self.wo = nn.Linear(c.d_ff, c.dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        else:
            h = torch.relu(self.wi(x))
        return self.wo(h)


# the JAX package's name for the feed-forward
T5FFN = T5DenseReluDense


class _LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5SelfAttention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.dim, cfg.eps)


class _LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.dim, cfg.eps)


class _Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_LayerSelfAttention(cfg, has_bias), _LayerFF(cfg)])


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_Block(cfg, cfg.per_layer_bias or i == 0)
                                    for i in range(cfg.layers)])
        self.final_layer_norm = T5LayerNorm(cfg.dim, cfg.eps)


class T5Encoder(nn.Module):
    """transformers ``T5EncoderModel``: ids (b, t) and an optional mask (b, t)
    -> (b, t, dim)."""

    def __init__(self, cfg: T5Config = T5Config()):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.encoder = _Stack(cfg)

    def _rel_bias(self, i: int, t: int, device) -> torch.Tensor:
        c = self.cfg
        buckets = torch.from_numpy(relative_position_buckets(
            t, t, c.rel_buckets, c.rel_max_distance)).to(device)
        emb = self.encoder.block[i].layer[0].SelfAttention.relative_attention_bias
        return emb(buckets).permute(2, 0, 1)[None]          # (1, h, t, t)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor | None = None,
                q_tau: float = 1.0, q_tau_layers: tuple = ()) -> torch.Tensor:
        c = self.cfg
        t = ids.shape[1]
        x = self.shared(ids.long())
        mask_add = 0.0
        if mask is not None:
            neg = torch.finfo(x.dtype).min
            mask_add = torch.where(mask[:, None, None, :] > 0,
                                   torch.zeros((), dtype=x.dtype, device=x.device),
                                   torch.full((), neg, dtype=x.dtype, device=x.device))
        if not c.per_layer_bias:
            bias = self._rel_bias(0, t, x.device) + mask_add
        for i, blk in enumerate(self.encoder.block):
            if c.per_layer_bias:
                bias = self._rel_bias(i, t, x.device) + mask_add
            sa, ff = blk.layer
            x = x + sa.SelfAttention(sa.layer_norm(x), bias,
                                     q_scale=q_tau if i in q_tau_layers else 1.0)
            x = x + ff.DenseReluDense(ff.layer_norm(x))
        x = self.encoder.final_layer_norm(x)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return x
