"""Dia-class dialogue TTS: a byte-level text encoder and an AR decoder over
9 DAC codebooks with the delay pattern (counterpart of
audiolab_tpu/models/dia.py).

- Attention has no 1/sqrt(head_dim) scale (Dia's layers.py:399: scale 1.0),
  rotary on q and k (cross-attention k at source positions), GQA in the
  decoder's self-attention with the caches holding the GQA-repeated k/v, as
  the JAX package's and the upstream caches do.
- The decoder's prefill self-attention is K2 (``flash_attention``, causal,
  scale 1.0): fp32 routes it to ``k2f_kernel`` on the card, one launch a
  decoder layer.  The encoder's masked attention, the cross-attention and
  the decode step's attention over the static cache (the ``arange <= pos``
  mask) are plain PyTorch, as ``attention_reference`` is in the JAX
  package.
- Cross k/v are computed once from the encoder output.  ``generate`` runs
  the CFG double batch through one decode step captured in a
  ``torch.cuda.CUDAGraph`` and replayed ``max_frames + n_codebooks`` times
  (``graph=False``: eagerly); the Gumbel draws are made before the loop or
  passed in.

Parameter names and layouts are nari-labs Dia's (``encoder.layers.N.
self_attention.{q,k,v,o}_proj`` as DenseGeneral kernels, input-major;
``mlp.wi_fused`` (dim, 2, 4 dim), ``mlp.wo``; ``decoder.embeddings.Q``;
``decoder.logits_dense`` (dim, n_q, V)), the names ``convert_dia`` maps.
Everything is fp32, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.attention import attention_reference, flash_attention
from audiolab_tpu_torch.models.lm import (
    RMSNorm,
    StageTimer,
    apply_rope,
    model_device,
    replay,
    resolve_draws,
    top_k_mask,
)
from audiolab_tpu_torch.models.zonos import delay_pattern, undelay_pattern


@dataclass(frozen=True)
class DiaConfig:
    vocab_text: int = 256          # byte-level
    dim_enc: int = 512
    dim_dec: int = 1024
    n_layers_enc: int = 6
    n_layers_dec: int = 12
    n_heads: int = 16              # decoder GQA query heads
    n_codebooks: int = 9
    codebook_size: int = 1028      # 1024 + BOS/EOS/PAD/MASK
    max_text_len: int = 512
    max_audio_len: int = 2048
    dtype: str = "float32"
    # upstream Dia-1.6B geometry: decoder self-attention is GQA with its own
    # head dim; cross-attention is MHA with its own head dim.  None keeps the
    # derived defaults.
    kv_heads: int | None = None          # None -> n_heads (no GQA)
    head_dim_dec: int | None = None      # None -> dim_dec // n_heads
    cross_head_dim: int | None = None    # None -> dim_dec // n_heads
    n_heads_enc: int | None = None       # None -> n_heads // 2

    @property
    def eos_id(self) -> int:
        return self.codebook_size - 3

    @property
    def bos_id(self) -> int:
        return self.codebook_size - 2

    @property
    def masked_id(self) -> int:
        return self.codebook_size - 1


class DenseGeneral(nn.Module):
    """Dia's DenseGeneral: an input-major kernel ``weight`` of shape
    in_shape + out_shape, no bias."""

    def __init__(self, in_shape: tuple, out_shape: tuple):
        super().__init__()
        self.n_in, self.out_shape = len(in_shape), tuple(out_shape)
        self.weight = nn.Parameter(torch.zeros(*in_shape, *out_shape))

    def forward(self, x):
        lead = x.shape[:x.dim() - self.n_in]
        w = self.weight.reshape(-1, math.prod(self.out_shape))
        return (x.reshape(*lead, -1) @ w).reshape(*lead, *self.out_shape)


class MHA(nn.Module):
    """Self- or cross-attention: q (in -> heads x hd), k/v (kv_in -> kv_heads x
    hd), o (heads x hd -> out); rotary (timescales 1..1e4 over hd) on q and k;
    scale 1.0."""

    scale = 1.0

    def __init__(self, q_dim: int, kv_dim: int, out_dim: int, n_heads: int,
                 n_kv_heads: int | None = None, head_dim: int | None = None):
        super().__init__()
        self.hd = head_dim or out_dim // n_heads
        self.n_heads, self.kvh = n_heads, n_kv_heads or n_heads
        self.q_proj = DenseGeneral((q_dim,), (n_heads, self.hd))
        self.k_proj = DenseGeneral((kv_dim,), (self.kvh, self.hd))
        self.v_proj = DenseGeneral((kv_dim,), (self.kvh, self.hd))
        self.o_proj = DenseGeneral((n_heads, self.hd), (out_dim,))
        freqs = 1.0 / (10000.0 ** (np.arange(0, self.hd, 2) / self.hd))
        # made on the default device (a module built under ``torch.device``)
        self.register_buffer("freqs", torch.tensor(freqs, dtype=torch.float32),
                             persistent=False)

    def _repeat(self, x):
        rep = self.n_heads // self.kvh
        return x.repeat_interleave(rep, dim=2) if rep > 1 else x

    def qkv(self, xq, xkv, pos_q, pos_k):
        """q (b, tq, N, hd) and k/v GQA-repeated to N heads, q and k roped."""
        q = apply_rope(self.q_proj(xq), pos_q, self.freqs)
        k = apply_rope(self.k_proj(xkv), pos_k, self.freqs)
        return q, self._repeat(k), self._repeat(self.v_proj(xkv))

    def attend(self, q, k, v, mask=None):
        """(b, t, N, hd) q, k, v -> (b, tq, out), the plain attention under
        ``mask``."""
        o = attention_reference(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                mask=mask, scale=self.scale)
        return self.o_proj(o.transpose(1, 2))

    def attend_k2(self, q, k, v):
        """Causal attention through K2 at any length, as the decoder's
        prefill calls it."""
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=True, scale=self.scale)
        return self.o_proj(o.transpose(1, 2))


class MLP(nn.Module):
    """wo(silu(x @ wi[:, 0]) * (x @ wi[:, 1])) with the fused (dim, 2, 4 dim)
    input kernel."""

    def __init__(self, dim: int):
        super().__init__()
        self.wi_fused = DenseGeneral((dim,), (2, 4 * dim))
        self.wo = DenseGeneral((4 * dim,), (dim,))

    def forward(self, x):
        h = self.wi_fused(x)
        return self.wo(F.silu(h[..., 0, :]) * h[..., 1, :])


class EncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.pre_sa_norm = RMSNorm(dim)
        self.self_attention = MHA(dim, dim, dim, heads)
        self.post_sa_norm = RMSNorm(dim)
        self.mlp = MLP(dim)


class DiaEncoder(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        c = cfg
        heads = c.n_heads_enc or c.n_heads // 2
        self.embedding = nn.Embedding(c.vocab_text, c.dim_enc)
        self.layers = nn.ModuleList(EncoderLayer(c.dim_enc, heads)
                                    for _ in range(c.n_layers_enc))
        self.norm = RMSNorm(c.dim_enc)

    def forward(self, text_ids, text_mask=None):
        x = self.embedding(text_ids)
        mask = None if text_mask is None else text_mask[:, None, None, :]
        pos = torch.arange(x.shape[1], device=x.device)
        for layer in self.layers:
            h = layer.pre_sa_norm(x)
            att = layer.self_attention
            x = x + att.attend(*att.qkv(h, h, pos, pos), mask=mask)
            x = x + layer.mlp(layer.post_sa_norm(x))
        return self.norm(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        c = cfg
        self.pre_sa_norm = RMSNorm(c.dim_dec)
        self.self_attention = MHA(c.dim_dec, c.dim_dec, c.dim_dec, c.n_heads, c.kv_heads,
                                  c.head_dim_dec)
        self.pre_ca_norm = RMSNorm(c.dim_dec)
        self.cross_attention = MHA(c.dim_dec, c.dim_enc, c.dim_dec, c.n_heads, None,
                                   c.cross_head_dim)
        self.pre_mlp_norm = RMSNorm(c.dim_dec)
        self.mlp = MLP(c.dim_dec)


class DiaDecoder(nn.Module):
    def __init__(self, cfg: DiaConfig):
        super().__init__()
        c = self.cfg = cfg
        self.embeddings = nn.ModuleList(nn.Embedding(c.codebook_size, c.dim_dec)
                                        for _ in range(c.n_codebooks))
        self.layers = nn.ModuleList(DecoderLayer(c) for _ in range(c.n_layers_dec))
        self.norm = RMSNorm(c.dim_dec)
        self.logits_dense = DenseGeneral((c.dim_dec,), (c.n_codebooks, c.codebook_size))

    def embed(self, codes):
        """(b, n_q, t) -> (b, t, dim): the codebooks' embeddings summed."""
        return torch.stack([emb(codes[:, q]) for q, emb in enumerate(self.embeddings)],
                           dim=1).sum(dim=1)

    def logits9(self, h):
        """(b, dim) -> (b, n_q, V)."""
        return self.logits_dense(h)

    def cross_kv(self, enc_out) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Per-layer cross k/v from the encoder output, k roped at source
        positions."""
        pos_k = torch.arange(enc_out.shape[1], device=enc_out.device)
        out = []
        for layer in self.layers:
            att = layer.cross_attention
            out.append((apply_rope(att.k_proj(enc_out), pos_k, att.freqs), att.v_proj(enc_out)))
        return out

    def _cross(self, layer, xq, kv, enc_mask, pos_q):
        att = layer.cross_attention
        q = apply_rope(att.q_proj(xq), pos_q, att.freqs)
        mask = None if enc_mask is None else enc_mask[:, None, None, :]
        return att.attend(q, *kv, mask=mask)

    def prefill(self, codes, enc_out, enc_mask=None):
        """Full forward over the (b, n_q, t) prompt.  Returns the last
        position's logits (b, n_q, V), the self-attention caches ([k, v] a
        layer, (b, max_audio_len, N, hd), the prompt at positions 0..t-1) and
        the cross k/v."""
        c = self.cfg
        x = self.embed(codes)
        b, t, _ = x.shape
        pos = torch.arange(t, device=x.device)
        cross = self.cross_kv(enc_out)
        caches = []
        for layer, kv in zip(self.layers, cross):
            h = layer.pre_sa_norm(x)
            att = layer.self_attention
            q, k, v = att.qkv(h, h, pos, pos)
            x = x + att.attend_k2(q, k, v)
            cache = [torch.zeros((b, c.max_audio_len) + k.shape[2:], dtype=k.dtype,
                                 device=k.device) for _ in range(2)]
            cache[0][:, :t] = k
            cache[1][:, :t] = v
            caches.append(cache)
            x = x + self._cross(layer, layer.pre_ca_norm(x), kv, enc_mask, pos)
            x = x + layer.mlp(layer.pre_mlp_norm(x))
        return self.logits9(self.norm(x[:, -1])), caches, cross

    def step(self, codes_t, pos, caches, cross, enc_mask=None):
        """codes_t (b, n_q) at ``pos`` ((1,) int64, the cache index as in the
        JAX package's decode) -> logits (b, n_q, V); writes k/v into the caches
        in place and attends over positions <= pos."""
        x = self.embed(codes_t[:, :, None])
        for layer, (kc, vc), kv in zip(self.layers, caches, cross):
            h = layer.pre_sa_norm(x)
            att = layer.self_attention
            q, k, v = att.qkv(h, h, pos, pos)
            kc.index_copy_(1, pos, k)
            vc.index_copy_(1, pos, v)
            mask = (torch.arange(kc.shape[1], device=kc.device) <= pos)[None, None, None, :]
            x = x + att.attend(q, kc, vc, mask=mask)
            x = x + self._cross(layer, layer.pre_ca_norm(x), kv, enc_mask, pos)
            x = x + layer.mlp(layer.pre_mlp_norm(x))
        return self.logits9(self.norm(x[:, 0]))


class DiaModel(nn.Module):
    def __init__(self, cfg: DiaConfig = DiaConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = DiaEncoder(cfg)
        self.decoder = DiaDecoder(cfg)

    def forward(self, text_ids, codes, text_mask=None):
        """Teacher-forced forward: the last position's logits (b, n_q, V)."""
        enc = self.encoder(text_ids, text_mask)
        return self.decoder.prefill(codes, enc, text_mask)[0]

    def encode_text(self, text_ids, text_mask=None):
        return self.encoder(text_ids, text_mask)

    def prefill(self, codes, enc_out, enc_mask=None):
        return self.decoder.prefill(codes, enc_out, enc_mask)

    def step(self, codes_t, pos, caches, cross, enc_mask=None):
        return self.decoder.step(codes_t, pos, caches, cross, enc_mask)


def tokenize_dialogue(text: str, max_len: int = 512) -> np.ndarray:
    """Byte-level tokenizer; [S1]/[S2] speaker tags pass through as bytes."""
    b = text.encode("utf-8")[:max_len]
    return np.frombuffer(b, np.uint8).astype(np.int32)


def make_sample9(cfg: DiaConfig, max_frames: int, cfg_scale: float, temperature: float,
                 top_k: int):
    """Dia's CFG-merged sampler (dia.py ``sample9``).  ``sample9(logits2,
    gumbel, step)``: logits2 (2b, n_q, V) as [cond; uncond], gumbel (b * n_q,
    V) the step's draws (row bi * n_q + q), step (1,) int64; returns tokens
    (b, n_q): the argmax of the top-k filtered logits plus the draws, MASKED
    before the codebook's delay and EOS after its last frame."""

    def sample9(logits2, gumbel, step):
        lc, lu = logits2.chunk(2, dim=0)
        lg = lu + cfg_scale * (lc - lu)
        b, n_q, v = lg.shape
        lq = top_k_mask(lg / max(temperature, 1e-6), top_k)
        toks = (lq.reshape(b * n_q, v) + gumbel).argmax(dim=-1).reshape(b, n_q)
        q_idx = torch.arange(n_q, device=toks.device)[None, :]
        toks = torch.where(step >= q_idx, toks, cfg.masked_id)
        return torch.where(step >= max_frames + q_idx, cfg.eos_id, toks)

    return sample9


class _Decode:
    """One call's decode buffers: the prefill's caches and logits, the
    position and step as (1,) device tensors, the delayed frames and every
    step's draws."""

    def __init__(self, model, sample9, caches, cross, mask2, logits, plen: int, draws):
        dev = logits.device
        b = logits.shape[0] // 2
        self.model, self.sample9, self.draws = model, sample9, draws
        self.caches, self.cross, self.mask2 = caches, cross, mask2
        self.logits = logits.clone()
        self.pos = torch.full((1,), plen, dtype=torch.long, device=dev)
        self.step_i = torch.zeros(1, dtype=torch.long, device=dev)
        self.frames = torch.empty((b, model.cfg.n_codebooks, draws.shape[0]),
                                  dtype=torch.long, device=dev)

    def step(self) -> None:
        toks = self.sample9(self.logits, self.draws.index_select(0, self.step_i)[0],
                            self.step_i)
        self.frames.index_copy_(2, self.step_i, toks[..., None])
        self.logits.copy_(self.model.step(torch.cat([toks, toks]), self.pos, self.caches,
                                          self.cross, self.mask2))
        self.pos.add_(1)
        self.step_i.add_(1)


@torch.inference_mode()
def generate(
    model: DiaModel,
    text_ids,                    # (b, t_text)
    max_frames: int = 512,
    audio_prompt=None,           # (b, n_q, t_prompt)
    cfg_scale: float = 3.0,
    temperature: float = 1.2,
    top_k: int = 64,
    seed: int = 0,
    draws: torch.Tensor | Callable | None = None,
    graph: bool | None = None,
    stats: dict | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """CFG double-batch AR generation (dia.py ``generate``): undelayed codes
    (b, n_q, max_frames) on ``device`` (default the card; raises without
    one).  The unconditional half has zero text under an all-ones mask.

    ``draws``: (max_frames + n_q, b * n_q, V) Gumbel draws, a callable of
    that shape, or None (from ``seed``).  ``graph``: capture one decode step
    and replay it (default on the card).  ``stats``: synchronised seconds
    of the stages (draws_s, prefill_s, decode_s) and the step count."""
    dev, graph = model_device(model, device, graph, "generate")
    c = model.cfg
    text = torch.as_tensor(text_ids, dtype=torch.long, device=dev)
    b = text.shape[0]
    total = max_frames + c.n_codebooks
    mark = StageTimer(stats, dev)
    draws = resolve_draws(draws, (total, b * c.n_codebooks, c.codebook_size), seed, dev)
    mark("draws_s")
    text2 = torch.cat([text, torch.zeros_like(text)])
    mask2 = torch.cat([text != 0, torch.ones_like(text, dtype=torch.bool)])
    prompt = torch.full((b, c.n_codebooks, 1), c.bos_id, dtype=torch.long, device=dev)
    if audio_prompt is not None:
        ap = torch.as_tensor(audio_prompt, dtype=torch.long, device=dev)
        prompt = torch.cat([prompt, delay_pattern(ap, c.masked_id)], dim=2)
    prompt2 = torch.cat([prompt, prompt])
    enc = model.encode_text(text2, mask2)
    logits, caches, cross = model.prefill(prompt2, enc, mask2)
    mark("prefill_s")
    dec = _Decode(model, make_sample9(c, max_frames, cfg_scale, temperature, top_k), caches,
                  cross, mask2, logits, prompt2.shape[2], draws)
    del caches, cross, logits
    replay(dec.step, total, dev, graph)
    codes = undelay_pattern(dec.frames, c.n_codebooks)
    mark("decode_s")
    mark.put("steps", total)
    return codes
