"""Whisper-class speech recognition (counterpart of
audiolab_tpu/models/whisper.py; the public openai-whisper design).

Log-mel (b, 3000, n_mels) -> two convolutions (k 3, the second stride 2,
torch's padding 1) with exact GELU -> sinusoidal positions -> pre-LN
transformer encoder -> ``ln_post``; a text decoder with learned positions,
causal self-attention, cross-attention and the token embedding as the
output head.  Parameter names are openai-whisper's (``encoder.conv1``,
``encoder.blocks.N.attn.{query,key,value,out}``, ``attn_ln``,
``mlp.0``/``mlp.2``, ``mlp_ln``, ``cross_attn``, ``cross_attn_ln``,
``decoder.token_embedding``, ``decoder.positional_embedding``,
``decoder.ln``), the names ``convert_whisper`` maps; ``key`` has no bias.
Everything is fp32.

Attention routes as the JAX package's do: the decoder's uncached forward
with more than one token is ``flash_attention(causal=True)`` (K2, fp32, on
the card); the encoder, cross-attention and the cached decode steps are the
plain :func:`attention_reference`.

``transcribe_window`` decodes from a static cache (self-attention k/v and
each layer's cross-attention k/v, computed once a call: the JAX decode
recomputes them from the encoder output at every step, the same products)
with one step captured in a CUDA graph and replayed (``models.lm.replay``);
draws for ``temperature > 0`` are made before the loop or passed in.  The
JAX decode reads its positions with a clamped dynamic slice, so past
``n_text_ctx`` it silently reuses the table's last row; the port raises
there instead (ROADMAP queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.attention import attention_reference, flash_attention
from audiolab_tpu_torch.kernels.mel import mel_spectrogram
from audiolab_tpu_torch.models.lm import (
    StageTimer,
    model_device,
    replay,
    resolve_draws,
    sample_logits,
)


@dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    n_audio_ctx: int = 1500        # frames after conv stride 2 (30 s at 100 Hz)
    dim: int = 384                 # tiny=384 base=512 small=768 medium=1024 large=1280
    n_heads: int = 6
    n_audio_layers: int = 4
    n_text_layers: int = 4
    vocab_size: int = 51865
    n_text_ctx: int = 448
    # special tokens (whisper vocab layout)
    sot: int = 50258
    eot: int = 50257
    no_timestamps: int = 50363
    timestamp_base: int = 50364    # <|0.00|>; +1 per 0.02 s
    sr: int = 16000
    hop: int = 160


def sinusoids(length: int, dim: int) -> np.ndarray:
    inv = np.exp(-np.log(10000.0) * np.arange(dim // 2) / (dim // 2 - 1))
    pos = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=1).astype(np.float32)


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim, bias=False)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def heads(self, x):
        b, t, d = x.shape
        return x.reshape(b, t, self.n_heads, d // self.n_heads).transpose(1, 2)

    def merge(self, o):
        b, h, t, hd = o.shape
        return self.out(o.transpose(1, 2).reshape(b, t, h * hd))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int, cross: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(dim, n_heads)
        self.attn_ln = nn.LayerNorm(dim, eps=1e-5)
        if cross:
            self.cross_attn = MultiHeadAttention(dim, n_heads)
            self.cross_attn_ln = nn.LayerNorm(dim, eps=1e-5)
        self.cross = cross
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(), nn.Linear(4 * dim, dim))
        self.mlp_ln = nn.LayerNorm(dim, eps=1e-5)

    def cross_kv(self, xa):
        """(k, v) of the cross-attention over the encoder output, as heads."""
        a = self.cross_attn
        return a.heads(a.key(xa)), a.heads(a.value(xa))

    def forward(self, x, xa=None, causal: bool = False, cache: dict | None = None):
        """``cache``: a layer's dict (``k``, ``v``, ``index``, and ``ck``/``cv``
        for a decoder layer), written and advanced in place; ``xa`` the
        encoder output (uncached decoder forward)."""
        a = self.attn
        h = self.attn_ln(x)
        q, k, v = a.heads(a.query(h)), a.heads(a.key(h)), a.heads(a.value(h))
        tq = x.shape[1]
        if cache is not None:
            idx = cache["index"]
            qpos = idx + torch.arange(tq, device=x.device)
            cache["k"].index_copy_(2, qpos, k)
            cache["v"].index_copy_(2, qpos, v)
            # the JAX mask is arange < index + t; causal within the written
            # block, which is the same for the one token a step writes
            mask = (torch.arange(cache["k"].shape[2], device=x.device)[None, None, None, :]
                    <= qpos[None, None, :, None])
            o = attention_reference(q, cache["k"], cache["v"], mask=mask)
            idx.add_(tq)
        elif causal and tq > 1:
            o = flash_attention(q, k, v, causal=True)
        else:
            o = attention_reference(q, k, v)
        x = x + a.merge(o)
        if self.cross and (cache is not None or xa is not None):
            c = self.cross_attn
            qc = c.heads(c.query(self.cross_attn_ln(x)))
            ck, cv = (cache["ck"], cache["cv"]) if cache is not None else self.cross_kv(xa)
            x = x + c.merge(attention_reference(qc, ck, cv))
        return x + self.mlp(self.mlp_ln(x))


class AudioEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        c = cfg
        self.conv1 = nn.Conv1d(c.n_mels, c.dim, 3, padding=1)
        self.conv2 = nn.Conv1d(c.dim, c.dim, 3, stride=2, padding=1)
        # a derived constant (not a weight): made with torch.tensor so that it
        # lands on the device a module is built under
        self.register_buffer("positional_embedding",
                             torch.tensor(sinusoids(c.n_audio_ctx, c.dim)), persistent=False)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(c.dim, c.n_heads)
                                    for _ in range(c.n_audio_layers))
        self.ln_post = nn.LayerNorm(c.dim, eps=1e-5)

    def forward(self, mel):
        """(b, t_mel, n_mels) -> (b, t_mel // 2, dim)."""
        h = F.gelu(self.conv1(mel.transpose(1, 2)))
        h = F.gelu(self.conv2(h)).transpose(1, 2)
        h = h + self.positional_embedding[: h.shape[1]]
        for block in self.blocks:
            h = block(h)
        return self.ln_post(h)


class TextDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        c = cfg
        self.n_text_ctx = c.n_text_ctx
        self.token_embedding = nn.Embedding(c.vocab_size, c.dim)
        self.positional_embedding = nn.Parameter(torch.empty(c.n_text_ctx, c.dim))
        nn.init.normal_(self.positional_embedding, std=0.01)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(c.dim, c.n_heads, cross=True)
                                    for _ in range(c.n_text_layers))
        self.ln = nn.LayerNorm(c.dim, eps=1e-5)

    def forward(self, tokens, xa=None, caches: list[dict] | None = None):
        """tokens (b, t) -> fp32 logits (b, t, vocab).  Without ``caches`` the
        tokens sit at positions 0..t-1 over ``xa``; with them at the caches'
        index, which every layer advances by t."""
        t = tokens.shape[1]
        if caches is None:
            if t > self.n_text_ctx:
                raise ValueError(f"{t} tokens past the {self.n_text_ctx} text positions")
            pos = self.positional_embedding[:t]
        else:
            pos = self.positional_embedding.index_select(
                0, caches[0]["index"] + torch.arange(t, device=tokens.device))
        x = self.token_embedding(tokens) + pos
        for i, block in enumerate(self.blocks):
            x = block(x, xa, causal=True, cache=None if caches is None else caches[i])
        return self.ln(x) @ self.token_embedding.weight.t()


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = AudioEncoder(cfg)
        self.decoder = TextDecoder(cfg)

    def encode(self, mel):
        return self.encoder(mel)

    def forward(self, mel, tokens):
        """Teacher-forced logits of ``tokens`` over ``mel`` (the uncached
        decoder forward: its self-attention is K2 when t > 1)."""
        return self.decoder(tokens, self.encoder(mel))


def log_mel_30s(audio16k: np.ndarray, cfg: WhisperConfig,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """(n,) 16 kHz -> (n_windows, 3000, n_mels) fp32 on ``device`` (default
    the card; raises without one): padded 30 s windows, log10 mel clamped to
    max - 8 (one max over every window, as the JAX package takes it) and
    scaled."""
    win = 30 * cfg.sr
    n = len(audio16k)
    n_win = max(1, -(-n // win))
    x = np.zeros(n_win * win, np.float32)
    x[:n] = audio16k
    xw = torch.from_numpy(x.reshape(n_win, win)).to(resolve_device(device))
    mel = mel_spectrogram(xw, sr=cfg.sr, n_fft=400, hop=cfg.hop, win_length=400,
                          n_mels=cfg.n_mels, power=2.0, center=True, htk=False, norm="slaney")
    logm = torch.log10(torch.clamp(mel, min=1e-10))
    logm = torch.maximum(logm, logm.max() - 8.0)
    return ((logm + 4.0) / 4.0)[:, :3000]


def init_decode_caches(model: WhisperModel, xa: torch.Tensor, max_len: int) -> list[dict]:
    """Per decoder layer: zero self-attention ``k``/``v`` (b, heads, max_len,
    head_dim), ``index`` (1,) int64 at 0, and the cross-attention ``ck``/``cv``
    of ``xa``."""
    c = model.cfg
    b = xa.shape[0]
    shape = (b, c.n_heads, max_len, c.dim // c.n_heads)
    caches = []
    for block in model.decoder.blocks:
        ck, cv = block.cross_kv(xa)
        caches.append(dict(k=torch.zeros(shape, device=xa.device),
                           v=torch.zeros(shape, device=xa.device),
                           index=torch.zeros(1, dtype=torch.long, device=xa.device),
                           ck=ck.contiguous(), cv=cv.contiguous()))
    return caches


@torch.inference_mode()
def transcribe_window(model: WhisperModel, mel, max_tokens: int = 128,
                      temperature: float = 0.0, seed: int = 0, draws=None,
                      graph: bool | None = None, device: str | torch.device = "cuda",
                      stats: dict | None = None) -> torch.Tensor:
    """Greedy (``temperature`` 0) or sampled decode of (b, 3000, n_mels)
    windows -> tokens (b, max_tokens) int64; EOT forever after EOT.

    ``draws``: (max_tokens, b, vocab) Gumbel draws for ``temperature > 0``,
    a callable of that shape, or None (made from ``seed``); the JAX decode's
    ``categorical`` on its split keys is the argmax of the tempered logits
    plus such draws.  ``graph``: capture one step and replay it (default on
    the card).  ``device``: where the model is (default the card; raises
    without one).  ``stats``: seconds of ``encode`` and ``decode``."""
    c = model.cfg
    dev, graph = model_device(model, device, graph, "transcribe_window")
    if max_tokens > c.n_text_ctx:
        raise ValueError(f"max_tokens {max_tokens} past the {c.n_text_ctx} text positions")
    timer = StageTimer(stats, dev)
    mel = torch.as_tensor(mel, dtype=torch.float32, device=dev)
    b = mel.shape[0]
    xa = model.encode(mel)
    timer("encode")
    caches = init_decode_caches(model, xa, max_tokens)
    if temperature > 0:
        draws = resolve_draws(draws, (max_tokens, b, c.vocab_size), seed, dev)
    tok = torch.full((b,), c.sot, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)
    out = torch.empty((b, max_tokens), dtype=torch.long, device=dev)

    def step():
        lg = model.decoder(tok[:, None], None, caches)[:, -1]
        g = None if temperature <= 0 else draws.index_select(0, i)[0]
        nxt = sample_logits(lg, g, temperature).masked_fill(done, c.eot)
        done.logical_or_(nxt == c.eot)
        out.index_copy_(1, i, nxt[:, None])
        tok.copy_(nxt)
        i.add_(1)

    replay(step, max_tokens, dev, graph)
    timer("decode")
    return out


def cached_logits(model: WhisperModel, mel, tokens) -> torch.Tensor:
    """Logits of ``tokens`` (b, t) fed one at a time through the decode's
    cache, each at its position (the steps ``transcribe_window`` replays, run
    eagerly): the uncached :meth:`WhisperModel.forward` is the same function."""
    with torch.inference_mode():
        xa = model.encode(mel)
        caches = init_decode_caches(model, xa, tokens.shape[1])
        return torch.cat([model.decoder(tokens[:, j:j + 1], None, caches)
                          for j in range(tokens.shape[1])], dim=1)
