"""Zonos-class TTS: hybrid SSM/attention backbone, 9-codebook AR decode,
and the checkpoint prefix conditioner bank (counterpart of
audiolab_tpu/models/zonos.py).

- The backbone interleaves Mamba mixers (``mamba1``, or ``mamba2`` as in
  the upstream hybrid) with causal attention every ``attn_every`` layers.
  Prefill runs the full prefix at once: the SSM through the log-depth scan
  of kernels/ssm.py, attention through K2 (``flash_attention``, causal; fp32
  routes to ``k2f_kernel`` on the card).
- Decode is one step over static buffers (the KV caches, the conv tails,
  the SSM states, the repetition window, the position as a device tensor),
  captured once per call in a ``torch.cuda.CUDAGraph`` and replayed for
  every frame (``models.lm.replay``): the counterpart of the JAX package's
  one ``lax.scan``.  ``generate_embedded`` runs the same decode after a
  prefix that ``ZonosPrefixConditioner`` embedded.  The loop has no host
  sync and no early stop; the Gumbel draws of every step
  are made before it (``jax.random.categorical`` is the argmax of logits
  plus Gumbel noise), so nothing random runs inside the graph and tests can
  inject the draws that the JAX keys give.  A capture that fails raises.
- The decode attention over the static cache is plain PyTorch with the JAX
  package's ``arange <= index`` mask, as it is ``attention_reference`` there.

Parameter names are Zyphra Zonos's where ``convert_zonos`` maps them
(``backbone.layers.N.{norm,mixer,norm2,mlp}``, the fused attention
``mixer.in_proj``, ``mlp.fc1`` as [value; gate], ``embeddings.q``,
``heads.q``, ``backbone.norm_f``); the Mamba1 mixer takes mamba_ssm's
``Mamba`` names; the conditioners and the speaker encoder, which no
converter maps, keep the JAX tree's module names.  Everything is fp32, as
in the JAX package.
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
from audiolab_tpu_torch.kernels.ssm import (
    causal_conv1d,
    causal_conv1d_step,
    selective_scan,
    ssm_step,
)
from audiolab_tpu_torch.models.lm import (  # noqa: F401  (gumbel_draws: the module's API)
    LMConfig,
    RMSNorm,
    StageTimer,
    apply_rope,
    gumbel_draws,
    model_device,
    replay,
    resolve_draws,
    rope_freqs,
)


@dataclass(frozen=True)
class ZonosConfig:
    dim: int = 1024
    n_layers: int = 12
    attn_every: int = 6        # every k-th block is attention, rest mamba
    n_heads: int = 16
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    n_codebooks: int = 9
    codebook_size: int = 1026  # 1024 + EOS + MASKED
    max_seq_len: int = 3072    # ~35 s at 86 Hz
    vocab_text: int = 256      # char-level phoneme fallback
    spk_dim: int = 256
    cond_dim: int = 64
    mixer: str = "mamba1"      # "mamba2" = upstream Zonos hybrid mixer
    headdim: int = 64          # mamba2 head width (d_inner/headdim heads)
    head_size: int | None = None   # logits width; None keeps codebook_size

    @property
    def d_inner(self) -> int:
        return self.expand * self.dim

    @property
    def eos_id(self) -> int:
        return self.codebook_size - 2

    @property
    def masked_id(self) -> int:
        return self.codebook_size - 1

    @property
    def vocab(self) -> int:
        return self.head_size or self.codebook_size


# ------------------------------------------------------------------ blocks
#
# Decode states are lists of tensors that ``step`` updates in place, so that
# a captured step reads and writes the same buffers on every replay.

def _conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """The last k - 1 inputs of the causal convolution (zero-padded)."""
    return F.pad(x, (0, 0, k - 1, 0))[:, -(k - 1):, :]


class MambaBlock(nn.Module):
    """mamba_ssm ``Mamba`` mixer: in_proj -> [x | z], depthwise causal conv,
    x_proj -> [dt (d_inner // 16) | B | C], softplus(dt_proj(dt)), the
    selective scan with a (d_inner, d_state) decay, y * silu(z), out_proj."""

    def __init__(self, cfg: ZonosConfig):
        super().__init__()
        c = cfg
        di = c.d_inner
        self.cfg = c
        self.dt_rank = di // 16
        self.in_proj = nn.Linear(c.dim, 2 * di, bias=False)
        self.conv1d = nn.Conv1d(di, di, c.d_conv, groups=di)
        self.x_proj = nn.Linear(di, self.dt_rank + 2 * c.d_state, bias=False)
        self.dt_proj = nn.Linear(self.dt_rank, di)
        self.A_log = nn.Parameter(torch.log(torch.arange(1, c.d_state + 1.0)).repeat(di, 1))
        self.D = nn.Parameter(torch.ones(di))
        self.out_proj = nn.Linear(di, c.dim, bias=False)

    def _conv_w(self) -> torch.Tensor:
        return self.conv1d.weight[:, 0].t()                      # (k, channels)

    def _gates(self, xc):
        dt, b, cc = self.x_proj(xc).split([self.dt_rank, self.cfg.d_state, self.cfg.d_state],
                                          dim=-1)
        return F.softplus(self.dt_proj(dt)), b, cc

    def _scan_in(self, x):
        xi, z = self.in_proj(x).chunk(2, dim=-1)
        xc = F.silu(causal_conv1d(xi, self._conv_w(), self.conv1d.bias))
        delta, b, cc = self._gates(xc)
        return xi, z, xc, delta, b, cc

    def forward(self, x):
        _xi, z, xc, delta, b, cc = self._scan_in(x)
        y = selective_scan(xc, delta, -torch.exp(self.A_log), b, cc, self.D)
        return self.out_proj(y * F.silu(z))

    def prefill(self, x):
        """Full-sequence forward that also returns the decode state
        [conv tail, h_T]."""
        xi, z, xc, delta, b, cc = self._scan_in(x)
        y, h = selective_scan(xc, delta, -torch.exp(self.A_log), b, cc, self.D,
                              return_state=True)
        return self.out_proj(y * F.silu(z)), [_conv_tail(xi, self.cfg.d_conv), h]

    def step(self, x_t, state):
        """One token x_t (b, dim); updates ``state`` in place."""
        conv_cache, h = state
        xi, z = self.in_proj(x_t).chunk(2, dim=-1)
        new_cache, xc = causal_conv1d_step(conv_cache, xi, self._conv_w(), self.conv1d.bias)
        xc = F.silu(xc)
        delta, b, cc = self._gates(xc)
        new_h, y = ssm_step(h, xc, delta, -torch.exp(self.A_log), b, cc, self.D)
        conv_cache.copy_(new_cache)
        h.copy_(new_h)
        return self.out_proj(y * F.silu(z))


class _GatedRMSNorm(nn.Module):
    """mamba_ssm's gated RMSNorm: (y * silu(z)) normalised in fp32, eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, y, z):
        gf = (y * F.silu(z)).float()
        r = gf * torch.rsqrt((gf * gf).mean(dim=-1, keepdim=True) + 1e-5)
        return (r * self.weight).to(y.dtype)


class Mamba2Block(nn.Module):
    """mamba_ssm ``Mamba2`` mixer as the JAX package writes it: fused in_proj
    -> [z | xBC | dt], depthwise causal conv over (x, B, C), a per-head
    scalar decay and skip broadcast over headdim, softplus(dt + dt_bias),
    B and C shared across heads, gated RMSNorm before out_proj."""

    def __init__(self, cfg: ZonosConfig):
        super().__init__()
        c = cfg
        di = c.d_inner
        self.cfg = c
        self.nheads = di // c.headdim
        self.conv_dim = di + 2 * c.d_state
        self.in_proj = nn.Linear(c.dim, 2 * di + 2 * c.d_state + self.nheads, bias=False)
        self.conv1d = nn.Conv1d(self.conv_dim, self.conv_dim, c.d_conv, groups=self.conv_dim)
        self.dt_bias = nn.Parameter(torch.zeros(self.nheads))
        self.A_log = nn.Parameter(torch.log(torch.arange(1, self.nheads + 1.0)))
        self.D = nn.Parameter(torch.ones(self.nheads))
        self.norm = _GatedRMSNorm(di)
        self.out_proj = nn.Linear(di, c.dim, bias=False)

    def _conv_w(self) -> torch.Tensor:
        return self.conv1d.weight[:, 0].t()

    def _pieces(self, x):
        di = self.cfg.d_inner
        return self.in_proj(x).split([di, self.conv_dim, self.nheads], dim=-1)

    def _ssm_params(self, xbc, dt):
        c = self.cfg
        xx, bb, cc = xbc.split([c.d_inner, c.d_state, c.d_state], dim=-1)
        delta = F.softplus(dt + self.dt_bias).repeat_interleave(c.headdim, dim=-1)
        a_full = (-torch.exp(self.A_log)).repeat_interleave(c.headdim)[:, None].expand(
            -1, c.d_state)
        d_full = self.D.repeat_interleave(c.headdim)
        return xx, bb, cc, delta, a_full, d_full

    def forward(self, x):
        z, xbc, dt = self._pieces(x)
        xbc = F.silu(causal_conv1d(xbc, self._conv_w(), self.conv1d.bias))
        xx, bb, cc, delta, a_full, d_full = self._ssm_params(xbc, dt)
        return self.out_proj(self.norm(selective_scan(xx, delta, a_full, bb, cc, d_full), z))

    def prefill(self, x):
        z, xbc_raw, dt = self._pieces(x)
        xbc = F.silu(causal_conv1d(xbc_raw, self._conv_w(), self.conv1d.bias))
        xx, bb, cc, delta, a_full, d_full = self._ssm_params(xbc, dt)
        y, h = selective_scan(xx, delta, a_full, bb, cc, d_full, return_state=True)
        return self.out_proj(self.norm(y, z)), [_conv_tail(xbc_raw, self.cfg.d_conv), h]

    def step(self, x_t, state):
        conv_cache, h = state
        z, xbc, dt = self._pieces(x_t)
        new_cache, xbc = causal_conv1d_step(conv_cache, xbc, self._conv_w(), self.conv1d.bias)
        xx, bb, cc, delta, a_full, d_full = self._ssm_params(F.silu(xbc), dt)
        new_h, y = ssm_step(h, xx, delta, a_full, bb, cc, d_full)
        conv_cache.copy_(new_cache)
        h.copy_(new_h)
        return self.out_proj(self.norm(y, z))


class AttnBlock(nn.Module):
    """Causal self-attention with rope (theta 1e4) and a fused qkv
    projection (mamba_ssm ``MHA``'s ``in_proj``)."""

    def __init__(self, cfg: ZonosConfig):
        super().__init__()
        self.cfg = cfg
        self.in_proj = nn.Linear(cfg.dim, 3 * cfg.dim, bias=False)
        self.out_proj = nn.Linear(cfg.dim, cfg.dim, bias=False)
        freqs = rope_freqs(LMConfig(dim=cfg.dim, n_heads=cfg.n_heads, rope_theta=10000.0))
        self.register_buffer("freqs", torch.from_numpy(freqs), persistent=False)

    def _qkv(self, x, pos):
        c = self.cfg
        b, t, _ = x.shape
        q, k, v = (y.reshape(b, t, c.n_heads, c.dim // c.n_heads)
                   for y in self.in_proj(x).chunk(3, dim=-1))
        return apply_rope(q, pos, self.freqs), apply_rope(k, pos, self.freqs), v

    def _attend(self, q, k, v):
        """K2, causal, over (b, t, h, d) -> (b, t, dim)."""
        b, t = q.shape[:2]
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=True)
        return self.out_proj(o.transpose(1, 2).reshape(b, t, -1))

    def forward(self, x, pos):
        return self._attend(*self._qkv(x, pos))

    def prefill(self, x, pos, cache_len: int):
        """Full-sequence forward that also returns the KV caches [k, v]
        (b, cache_len, h, d), the prefix written at its positions."""
        q, k, v = self._qkv(x, pos)
        b, t = x.shape[:2]
        caches = [torch.zeros((b, cache_len) + k.shape[2:], dtype=k.dtype, device=k.device)
                  for _ in range(2)]
        caches[0][:, :t] = k
        caches[1][:, :t] = v
        return self._attend(q, k, v), caches

    def step(self, x_t, pos, state):
        """x_t (b, dim) at position ``pos`` ((1,) int64 on x_t's device, the
        cache index as in the JAX package's decode); writes k and v into the
        caches in place and attends over positions <= pos."""
        kc, vc = state
        q, k, v = self._qkv(x_t[:, None, :], pos)
        kc.index_copy_(1, pos, k)
        vc.index_copy_(1, pos, v)
        mask = (torch.arange(kc.shape[1], device=kc.device) <= pos)[None, None, None, :]
        o = attention_reference(q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                                mask=mask)
        return self.out_proj(o.transpose(1, 2).reshape(x_t.shape[0], -1))


class GatedMLP(nn.Module):
    """fc2(value * silu(gate)) with fc1 -> [value; gate] (mamba_ssm GatedMLP)."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 8 * dim, bias=False)
        self.fc2 = nn.Linear(4 * dim, dim, bias=False)

    def forward(self, x):
        value, gate = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(value * F.silu(gate))


class _Layer(nn.Module):
    def __init__(self, cfg: ZonosConfig, attn: bool):
        super().__init__()
        self.attn = attn
        self.norm = RMSNorm(cfg.dim)
        self.mixer = (AttnBlock(cfg) if attn
                      else (Mamba2Block if cfg.mixer == "mamba2" else MambaBlock)(cfg))
        self.norm2 = RMSNorm(cfg.dim)
        self.mlp = GatedMLP(cfg.dim)


class ZonosBackbone(nn.Module):
    """Interleaved mamba/attention trunk (backbone.py hybrid)."""

    def __init__(self, cfg: ZonosConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(_Layer(cfg, (i + 1) % cfg.attn_every == 0)
                                    for i in range(cfg.n_layers))
        self.norm_f = RMSNorm(cfg.dim)

    def forward(self, x, pos):
        for layer in self.layers:
            h = layer.norm(x)
            x = x + (layer.mixer(h, pos) if layer.attn else layer.mixer(h))
            x = x + layer.mlp(layer.norm2(x))
        return self.norm_f(x)

    def prefill_states(self, x, pos, cache_len: int):
        """Full-sequence forward that also returns the decode states primed
        with the prefix (KV caches sized ``cache_len``, conv tails, SSM
        states)."""
        states = []
        for layer in self.layers:
            h = layer.norm(x)
            o, st = (layer.mixer.prefill(h, pos, cache_len) if layer.attn
                     else layer.mixer.prefill(h))
            x = x + o
            x = x + layer.mlp(layer.norm2(x))
            states.append(st)
        return self.norm_f(x), states

    def step(self, x_t, pos, states):
        for layer, st in zip(self.layers, states):
            h = layer.norm(x_t)
            x_t = x_t + (layer.mixer.step(h, pos, st) if layer.attn else layer.mixer.step(h, st))
            x_t = x_t + layer.mlp(layer.norm2(x_t))
        return self.norm_f(x_t)


# ------------------------------------------------------------------ conditioners

class FourierConditioner(nn.Module):
    """Continuous scalar(s) -> dim via random Fourier features."""

    def __init__(self, out_dim: int, in_dim: int = 1):
        super().__init__()
        self.w = nn.Parameter(torch.randn(in_dim, out_dim // 2))
        self.proj = nn.Linear(out_dim // 2 * 2, out_dim)

    def forward(self, x):                                          # (b, in_dim)
        proj = (2 * math.pi * x) @ self.w
        return self.proj(torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1))[:, None, :]


def _same_pads(t: int, k: int, stride: int) -> tuple[int, int]:
    """flax ``padding="SAME"``: ceil(t / stride) outputs, the odd pad on the
    right."""
    out = -(-t // stride)
    total = max((out - 1) * stride + k - t, 0)
    return total // 2, total - total // 2


def _flax_layer_norm(x, ln: nn.LayerNorm):
    """flax LayerNorm over the last axis: var = E[x^2] - E[x]^2, clamped at 0."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + ln.eps) * ln.weight + ln.bias


class SpeakerEncoder(nn.Module):
    """Mel (b, t, n_mels) -> unit speaker embedding: three Conv(5) + LayerNorm
    (eps 1e-6) + ReLU stages (stride 1, 2, 2, flax SAME padding), attentive
    statistics pooling, a projection and L2 normalisation."""

    CHANNELS = (128, 128, 256)

    def __init__(self, out_dim: int = 256, n_mels: int = 80):
        super().__init__()
        cin = n_mels
        for i, ch in enumerate(self.CHANNELS):
            setattr(self, f"conv_{i}", nn.Conv1d(cin, ch, 5, stride=2 if i else 1))
            setattr(self, f"ln_{i}", nn.LayerNorm(ch, eps=1e-6))
            cin = ch
        self.att = nn.Linear(cin, 1)
        self.proj = nn.Linear(2 * cin, out_dim)

    def forward(self, mel):
        h = mel
        for i in range(len(self.CHANNELS)):
            conv = getattr(self, f"conv_{i}")
            lo, hi = _same_pads(h.shape[1], 5, conv.stride[0])
            h = conv(F.pad(h.transpose(1, 2), (lo, hi))).transpose(1, 2)
            h = F.relu(_flax_layer_norm(h, getattr(self, f"ln_{i}")))
        w = torch.softmax(self.att(h), dim=1)
        mu = (h * w).sum(dim=1)
        sg = torch.sqrt(torch.clamp((h * h * w).sum(dim=1) - mu * mu, min=1e-6))
        e = self.proj(torch.cat([mu, sg], dim=-1))
        return e / (torch.linalg.norm(e, dim=-1, keepdim=True) + 1e-8)


_CHARS = "abcdefghijklmnopqrstuvwxyz0123456789 .,!?'-;:\""


def tokenize_text(text: str, max_len: int = 256) -> np.ndarray:
    """Rule-normalized char tokenizer (espeak phonemizer stand-in)."""
    text = " ".join(text.lower().strip().split())
    ids = [min(_CHARS.find(ch) + 1 if ch in _CHARS else 0, 255) for ch in text]
    return np.asarray(ids[:max_len], np.int32)


# ------------------------------------------------------------------ model

class ZonosModel(nn.Module):
    def __init__(self, cfg: ZonosConfig = ZonosConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        self.backbone = ZonosBackbone(c)
        self.embeddings = nn.ModuleList(nn.Embedding(c.codebook_size, c.dim)
                                        for _ in range(c.n_codebooks))
        self.text_emb = nn.Embedding(c.vocab_text, c.dim)
        self.spk_proj = nn.Linear(c.spk_dim, c.dim)
        self.emotion = FourierConditioner(c.dim, 8)
        self.rate = FourierConditioner(c.dim, 1)
        self.pitch = FourierConditioner(c.dim, 1)
        self.heads = nn.ModuleList(nn.Linear(c.dim, c.vocab, bias=False)
                                   for _ in range(c.n_codebooks))

    def embed_codes(self, codes):
        """codes (b, n_q, t) -> summed embeddings (b, t, dim)."""
        return torch.stack([emb(codes[:, q]) for q, emb in enumerate(self.embeddings)],
                           dim=1).sum(dim=1)

    def prefix(self, text_ids, spk_emb, emotion, rate, pitch):
        """Conditioning prefix (b, t_text + 4, dim)."""
        return torch.cat([self.text_emb(text_ids), self.spk_proj(spk_emb)[:, None, :],
                          self.emotion(emotion), self.rate(rate), self.pitch(pitch)], dim=1)

    def logits9(self, h):
        """(b, dim) -> (b, n_q, vocab)."""
        return torch.stack([head(h) for head in self.heads], dim=1)

    def prefill(self, text_ids, spk_emb, emotion, rate, pitch, bos_codes, cache_len: int):
        """Prefix + BOS frame; returns (logits9, states, prefix length)."""
        return self.prefill_embedded(self.prefix(text_ids, spk_emb, emotion, rate, pitch),
                                     bos_codes, cache_len)

    def prefill_embedded(self, x_prefix, bos_codes, cache_len: int):
        """Prefill from a pre-embedded prefix (b, t, dim), the path of the
        checkpoint prefix bank (:class:`ZonosPrefixConditioner`)."""
        x = torch.cat([x_prefix, self.embed_codes(bos_codes)], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        h, states = self.backbone.prefill_states(x, pos, cache_len)
        return self.logits9(h[:, -1]), states, x.shape[1]

    def decode_step(self, codes_t, pos, states):
        """codes_t (b, n_q) at ``pos`` ((1,) int64) -> logits9; updates
        ``states`` in place."""
        x_t = self.embed_codes(codes_t[:, :, None])[:, 0]
        return self.logits9(self.backbone.step(x_t, pos, states))


# ------------------------------------------------------------------ generation

def delay_pattern(codes: torch.Tensor, masked_id: int) -> torch.Tensor:
    """(b, n_q, t) -> (b, n_q, t + n_q): codebook q shifted right q steps."""
    b, n_q, t = codes.shape
    out = torch.full((b, n_q, t + n_q), masked_id, dtype=codes.dtype, device=codes.device)
    for q in range(n_q):
        out[:, q, q:q + t] = codes[:, q]
    return out


def undelay_pattern(delayed: torch.Tensor, n_q: int) -> torch.Tensor:
    """(b, n_q, t + n_q) -> (b, n_q, t)."""
    t = delayed.shape[2] - n_q
    return torch.stack([delayed[:, q, q:q + t] for q in range(n_q)], dim=1)


# frames per codebook the repetition penalty looks back over (sampling.py:101-109)
REP_WINDOW = 2


def make_sample9(cfg: ZonosConfig, max_frames: int, cfg_scale: float, temperature: float,
                 top_k: int, min_p: float = 0.1, repetition_penalty: float = 3.0):
    """CFG-merged 9-codebook sampler (zonos.py ``_make_sample9``).

    ``sample9(logits2, gumbel, step, window)``: logits2 (2b, n_q, V) as
    [cond; uncond], gumbel (b * n_q, V) the step's draws, step (1,) int64,
    window (b, n_q, REP_WINDOW) the last emitted ids (-1: none).  Returns
    (tokens (b, n_q), new window).  The draw is argmax(logits + gumbel),
    which is ``jax.random.categorical``."""

    def sample9(logits2, gumbel, step, window):
        lc, lu = logits2.chunk(2, dim=0)
        lg = lu + cfg_scale * (lc - lu)
        v = lg.shape[-1]
        if repetition_penalty != 1.0:
            ar = torch.arange(v, device=lg.device)
            count = (window[..., None] == ar).sum(dim=2)
            factors = torch.pow(repetition_penalty, count.to(lg.dtype))
            lg = torch.where(lg <= 0, lg * factors, lg / factors)
        flat = lg.reshape(lg.shape[0] * cfg.n_codebooks, -1) / max(temperature, 1e-6)
        if top_k > 0:
            kth = torch.topk(flat, min(top_k, flat.shape[-1]), dim=-1).values[:, -1:]
            flat = torch.where(flat < kth, -math.inf, flat)
        if min_p > 0.0:
            probs = torch.softmax(flat, dim=-1)
            keep = probs >= min_p * probs.amax(dim=-1, keepdim=True)
            flat = torch.where(keep, flat, -math.inf)
        toks = (flat + gumbel).argmax(dim=-1).reshape(lg.shape[0], cfg.n_codebooks)
        q_idx = torch.arange(cfg.n_codebooks, device=toks.device)[None, :]
        toks = torch.where(step >= q_idx, toks, cfg.masked_id)
        toks = torch.where(step >= max_frames + q_idx, cfg.eos_id, toks)
        return toks, torch.cat([window[..., 1:], toks[..., None]], dim=-1)

    return sample9


class _Decode:
    """One call's decode buffers: copies of the prefill's layer states and
    logits, position and step as (1,) device tensors, the
    repetition window, the delayed frames and every step's draws.  A call
    captures its own graph; nothing is kept on the model after it."""

    def __init__(self, model, sample9, states, logits, plen: int, draws):
        c = model.cfg
        dev = logits.device
        b = logits.shape[0] // 2
        self.model, self.sample9, self.draws = model, sample9, draws
        self.states = [[t.clone() for t in st] for st in states]
        self.logits = logits.clone()
        self.pos = torch.full((1,), plen, dtype=torch.long, device=dev)
        self.step_i = torch.zeros(1, dtype=torch.long, device=dev)
        self.window = torch.full((b, c.n_codebooks, REP_WINDOW), -1, dtype=torch.long,
                                 device=dev)
        self.frames = torch.empty((b, c.n_codebooks, draws.shape[0]), dtype=torch.long,
                                  device=dev)

    def step(self) -> None:
        """Sample this step's tokens from the current logits, record them,
        and run the backbone one token on [toks; toks]."""
        g = self.draws.index_select(0, self.step_i)[0]
        toks, window = self.sample9(self.logits, g, self.step_i, self.window)
        self.window.copy_(window)
        self.frames.index_copy_(2, self.step_i, toks[..., None])
        self.logits.copy_(self.model.decode_step(torch.cat([toks, toks]), self.pos,
                                                 self.states))
        self.pos.add_(1)
        self.step_i.add_(1)


@torch.inference_mode()
def generate(
    model: ZonosModel,
    text_ids,                    # (b, t_text)
    spk_emb,                     # (b, spk_dim)
    max_frames: int = 600,
    emotion=None,
    rate=None,
    pitch=None,
    cfg_scale: float = 2.0,
    temperature: float = 1.0,
    top_k: int = 0,
    min_p: float = 0.1,
    repetition_penalty: float = 3.0,
    seed: int = 0,
    draws: torch.Tensor | Callable | None = None,
    graph: bool | None = None,
    stats: dict | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """AR generation with the delay pattern and the CFG double batch
    (zonos.py ``generate``).  Returns codes (b, n_q, max_frames), undelayed
    and EOS-padded, on ``device`` (default the card; raises without one).

    ``draws``: the Gumbel draws of every step, (max_frames + n_q, b * n_q,
    vocab), or a callable (total, rows, vocab) -> such a tensor; by default
    :func:`gumbel_draws` from ``seed`` on the device.  ``graph``: capture the
    decode step once in this call and replay it for every frame (the
    default on the card; CPU runs are eager).
    ``stats``: when given, the stages are synchronised and their seconds
    recorded (prefill_s, decode_s) with the step count."""
    dev, graph = model_device(model, device, graph, "generate")
    c = model.cfg
    f32 = dict(dtype=torch.float32, device=dev)
    text_ids = torch.as_tensor(text_ids, dtype=torch.long, device=dev)
    spk_emb = torch.as_tensor(spk_emb, **f32)
    b = text_ids.shape[0]
    emotion = torch.as_tensor([[0.3] + [0.1] * 7] * b if emotion is None else emotion, **f32)
    rate = torch.as_tensor(np.full((b, 1), 15.0) if rate is None else rate, **f32)
    pitch = torch.as_tensor(np.full((b, 1), 20.0) if pitch is None else pitch, **f32)
    total = max_frames + c.n_codebooks                     # delay tail
    cache_len = text_ids.shape[1] + 12 + 1 + total + 2     # prefix + bos + steps
    mark = StageTimer(stats, dev)
    draws = resolve_draws(draws, (total, b * c.n_codebooks, c.vocab), seed, dev)
    mark("draws_s")
    # CFG: [cond; uncond] double batch; uncond drops the text (zeros)
    bos = torch.full((2 * b, c.n_codebooks, 1), c.masked_id, dtype=torch.long, device=dev)
    logits, states, plen = model.prefill(
        torch.cat([text_ids, torch.zeros_like(text_ids)]), torch.cat([spk_emb, spk_emb]),
        torch.cat([emotion, emotion]), torch.cat([rate, rate]), torch.cat([pitch, pitch]),
        bos, cache_len)
    mark("prefill_s")
    return _decode_codes(model, logits, states, plen, draws, graph, mark, max_frames,
                         cfg_scale, temperature, top_k, min_p, repetition_penalty)


def _decode_codes(model, logits, states, plen, draws, graph, mark, max_frames, cfg_scale,
                  temperature, top_k, min_p, repetition_penalty) -> torch.Tensor:
    """The decode after a prefill: undelayed codes (b, n_q, max_frames)."""
    c = model.cfg
    sample9 = make_sample9(c, max_frames, cfg_scale, temperature, top_k, min_p,
                           repetition_penalty)
    dec = _Decode(model, sample9, states, logits, plen, draws)
    del states, logits
    replay(dec.step, draws.shape[0], draws.device, graph)
    codes = undelay_pattern(dec.frames, c.n_codebooks)
    mark("decode_s")
    mark.put("steps", draws.shape[0])
    return codes


@torch.inference_mode()
def generate_embedded(
    model: ZonosModel,
    x_prefix2,                   # (2b, t_prefix, dim) [cond; uncond]
    max_frames: int = 600,
    cfg_scale: float = 2.0,
    temperature: float = 1.0,
    top_k: int = 0,
    min_p: float = 0.1,
    repetition_penalty: float = 3.0,
    seed: int = 0,
    draws: torch.Tensor | Callable | None = None,
    graph: bool | None = None,
    stats: dict | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """AR generation from a pre-embedded CFG prefix pair (zonos.py
    ``generate_embedded``): build it with :class:`ZonosPrefixConditioner` over
    the cond and uncond dicts.  The decode, draws, graph and stats are
    :func:`generate`'s.  Returns codes (b, n_q, max_frames)."""
    dev, graph = model_device(model, device, graph, "generate_embedded")
    c = model.cfg
    x_prefix2 = torch.as_tensor(x_prefix2, dtype=torch.float32, device=dev)
    b2 = x_prefix2.shape[0]
    total = max_frames + c.n_codebooks
    cache_len = x_prefix2.shape[1] + 1 + total + 2
    mark = StageTimer(stats, dev)
    draws = resolve_draws(draws, (total, b2 // 2 * c.n_codebooks, c.vocab), seed, dev)
    mark("draws_s")
    bos = torch.full((b2, c.n_codebooks, 1), c.masked_id, dtype=torch.long, device=dev)
    logits, states, plen = model.prefill_embedded(x_prefix2, bos, cache_len)
    mark("prefill_s")
    return _decode_codes(model, logits, states, plen, draws, graph, mark, max_frames,
                         cfg_scale, temperature, top_k, min_p, repetition_penalty)


# ------------------------------------------------- checkpoint phoneme table

# Phoneme symbol inventory of the published phoneme_embedder rows
# (reference modules/zonos/conditioning.py:25-35).
ZONOS_PAD_ID, ZONOS_UNK_ID, ZONOS_BOS_ID, ZONOS_EOS_ID = 0, 1, 2, 3
_ZONOS_SYMBOLS = (
    ';:,.!?¡¿—…"«»“”() *~-/\\&'
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
_ZONOS_SYMBOL_TO_ID = {s: i + 4 for i, s in enumerate(_ZONOS_SYMBOLS)}
ZONOS_PHONEME_VOCAB = 4 + len(_ZONOS_SYMBOLS)


def tokenize_phonemes_np(phonemes: list[str]) -> np.ndarray:
    """IPA strings -> LEFT-padded id batch [PAD..., BOS, chars, EOS]
    (conditioning.py:148-158; unknown chars -> UNK)."""
    ids = [[ZONOS_BOS_ID,
            *(_ZONOS_SYMBOL_TO_ID.get(c, ZONOS_UNK_ID) for c in p),
            ZONOS_EOS_ID] for p in phonemes]
    longest = max(map(len, ids))
    return np.asarray([[ZONOS_PAD_ID] * (longest - len(r)) + r for r in ids], np.int32)


# ------------------------------------------------- checkpoint prefix bank

@dataclass(frozen=True)
class CondSpec:
    """One entry of the model config's prefix_conditioner.conditioners list
    (conditioning.py:38-285)."""
    type: str                 # Espeak|Fourier|Integer|Passthrough Conditioner
    name: str
    cond_dim: int | None = None
    projection: str = "none"  # none | linear | mlp
    uncond_type: str = "none"
    input_dim: int = 1
    min_val: float = 0.0
    max_val: float = 1.0


# The published Zonos-v0.1 conditioner bank (a model's config.json overrides
# it: the list is data end to end).
DEFAULT_ZONOS_CONDITIONERS = (
    CondSpec("EspeakPhonemeConditioner", "espeak"),
    CondSpec("PassthroughConditioner", "speaker", cond_dim=128,
             projection="linear", uncond_type="learned"),
    CondSpec("FourierConditioner", "emotion", input_dim=8,
             uncond_type="learned"),
    CondSpec("FourierConditioner", "fmax", min_val=0.0, max_val=24000.0,
             uncond_type="learned"),
    CondSpec("FourierConditioner", "pitch_std", min_val=0.0, max_val=400.0,
             uncond_type="learned"),
    CondSpec("FourierConditioner", "speaking_rate", min_val=0.0,
             max_val=40.0, uncond_type="learned"),
    CondSpec("IntegerConditioner", "language_id", min_val=-1.0,
             max_val=126.0, uncond_type="learned"),
)


def _projection(kind: str, din: int, dim: int) -> nn.Module | None:
    if kind == "linear":
        return nn.Linear(din, dim)
    if kind == "mlp":
        return nn.Sequential(nn.Linear(din, dim), nn.SiLU(), nn.Linear(dim, dim))
    return None


class _Conditioner(nn.Module):
    """One conditioner of the bank under the checkpoint's names
    (``uncond_vector``, ``phoneme_embedder``, ``weight``, ``int_embedder``,
    ``project``)."""

    def __init__(self, spec: CondSpec, dim: int):
        super().__init__()
        s = self.spec = spec
        if s.uncond_type == "learned":
            self.uncond_vector = nn.Parameter(torch.zeros(dim))
        din = dim
        if s.type == "EspeakPhonemeConditioner":
            self.phoneme_embedder = nn.Embedding(ZONOS_PHONEME_VOCAB, dim)
        elif s.type == "FourierConditioner":
            self.weight = nn.Parameter(torch.randn(dim // 2, s.input_dim))
        elif s.type == "IntegerConditioner":
            self.int_embedder = nn.Embedding(int(s.max_val - s.min_val) + 1, dim)
        elif s.type == "PassthroughConditioner":
            din = s.cond_dim or dim
        else:
            raise ValueError(s.type)
        self.project = _projection(s.projection, din, dim)

    def forward(self, x):
        """(b, t, dim) for the slot's value, or the learned uncond vector
        (1, 1, dim) when ``x`` is None."""
        s = self.spec
        if x is None:
            return self.uncond_vector[None, None]
        if s.type == "EspeakPhonemeConditioner":
            h = self.phoneme_embedder(x)
        elif s.type == "FourierConditioner":
            f = 2.0 * math.pi * ((x - s.min_val) / (s.max_val - s.min_val)) @ self.weight.t()
            h = torch.cat([torch.cos(f), torch.sin(f)], dim=-1)
        elif s.type == "IntegerConditioner":
            h = self.int_embedder(x[..., 0].long() - int(s.min_val))
        else:
            h = x
        return h if self.project is None else self.project(h)


class ZonosPrefixConditioner(nn.Module):
    """The checkpoint's prefix conditioner bank (conditioning.py:287-303):
    each conditioner embeds its slot of the cond dict (its learned uncond
    vector when the slot is absent), the sequences are joined along time,
    then the bank's projection and LayerNorm (eps 1e-5).  Names are those
    ``convert_zonos_prefix`` maps: ``conditioners.N.*``, ``project``,
    ``norm``."""

    def __init__(self, dim: int, specs: tuple = DEFAULT_ZONOS_CONDITIONERS,
                 projection: str = "none"):
        super().__init__()
        self.conditioners = nn.ModuleList(_Conditioner(s, dim) for s in specs)
        self.project = _projection(projection, dim, dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, cond: dict) -> torch.Tensor:
        outs = [m(cond.get(m.spec.name)) for m in self.conditioners]
        b = max(o.shape[0] for o in outs)
        h = torch.cat([o.expand(b, *o.shape[1:]) for o in outs], dim=1)
        if self.project is not None:
            h = self.project(h)
        return _flax_layer_norm(h, self.norm)
