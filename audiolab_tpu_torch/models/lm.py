"""Decoder-only transformer LM core shared by the audio LMs (counterpart of
audiolab_tpu/models/lm.py): the configuration, rotary tables, RMSNorm,
``TransformerLM`` with its static per-layer KV cache, the samplers and the
decode loop.

- With no cache and t > 1 the attention is K2 (``flash_attention``, causal):
  at ``LMConfig()`` bf16 with head dim 128 on K2's Hopper route.  Through a
  cache it is plain PyTorch (``attention_reference`` under the JAX
  package's ``arange <= index + j`` mask), as it is in the JAX package.
- The cache of each layer is a dict of static buffers: ``k`` and ``v`` of
  shape (b, max_len, n_kv_heads, head_dim) and ``index``, a (1,) int64
  device tensor.  A forward through the cache writes k/v at ``index`` and
  advances ``index`` in place, so a captured step reads and writes the
  same buffers on every replay.
- ``decode`` is the JAX package's ``lax.scan`` loop as one step captured in
  a ``torch.cuda.CUDAGraph`` and replayed (``graph=False``: the same step
  eagerly, the only choice on the CPU).  Its Gumbel draws are made before
  the loop or passed in (``jax.random.categorical`` is the argmax of the
  logits plus Gumbel noise), so the tests can hand it the JAX keys' draws.

Parameter names are HF LLaMA's (``model.embed_tokens``,
``model.layers.N.self_attn.{q,k,v,o}_proj``, ``mlp.{gate,up,down}_proj``,
``input_layernorm``, ``post_attention_layernorm``, ``model.norm``,
``lm_head``), the names ``convert_llama`` maps.  Linear layers and the
embedding hold the configuration's type (the JAX package casts its fp32
kernels to it at every use, which rounds them the same way); the norm
gains and ``lm_head`` stay fp32, as the JAX package computes them.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.attention import attention_reference, flash_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


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

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


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


# ------------------------------------------------------------------ blocks

class Attention(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        c, dt = cfg, cfg.torch_dtype
        self.cfg = c
        hd = c.head_dim
        self.q_proj = nn.Linear(c.dim, c.n_heads * hd, bias=False, dtype=dt)
        self.k_proj = nn.Linear(c.dim, c.n_kv_heads * hd, bias=False, dtype=dt)
        self.v_proj = nn.Linear(c.dim, c.n_kv_heads * hd, bias=False, dtype=dt)
        self.o_proj = nn.Linear(c.n_heads * hd, c.dim, bias=False, dtype=dt)
        # the heads this module computes: all of them, or a tensor-parallel
        # rank's share (parallel/tp.py)
        self.n_heads, self.n_kv_heads = c.n_heads, c.n_kv_heads
        # made on the default device (a module built under ``torch.device``)
        self.register_buffer("freqs", torch.tensor(rope_freqs(c)), persistent=False)

    def forward(self, x, pos, mask=None, cache: dict | None = None):
        """x (b, t, dim); ``cache`` None (full causal) or a layer's cache dict,
        written and advanced in place."""
        c = self.cfg
        b, t, _ = x.shape
        hd = c.head_dim
        q = apply_rope(self.q_proj(x).reshape(b, t, self.n_heads, hd), pos, self.freqs)
        k = apply_rope(self.k_proj(x).reshape(b, t, self.n_kv_heads, hd), pos, self.freqs)
        v = self.v_proj(x).reshape(b, t, self.n_kv_heads, hd)
        if cache is None:
            kf, vf, attn_mask = k, v, mask
        else:
            idx = cache["index"]
            qpos = idx + torch.arange(t, device=x.device)
            cache["k"].index_copy_(1, qpos, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, qpos, v.to(cache["v"].dtype))
            kf, vf = cache["k"], cache["v"]
            # causal within the written block: query j sees keys <= idx + j
            attn_mask = (torch.arange(kf.shape[1], device=x.device)[None, None, None, :]
                         <= qpos[None, None, :, None])
            if mask is not None:
                attn_mask = attn_mask & mask
            idx.add_(t)
        rep = self.n_heads // self.n_kv_heads
        if rep > 1:
            kf = kf.repeat_interleave(rep, dim=2)
            vf = vf.repeat_interleave(rep, dim=2)
        qh, kh, vh = q.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2)
        if cache is None and t > 1:
            o = flash_attention(qh, kh, vh, causal=True)
        else:
            o = attention_reference(qh, kh, vh, causal=cache is None, mask=attn_mask)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, self.n_heads * hd))


class MLP(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        dt = cfg.torch_dtype
        self.gate_proj = nn.Linear(cfg.dim, cfg.ffn_dim, bias=False, dtype=dt)
        self.up_proj = nn.Linear(cfg.dim, cfg.ffn_dim, bias=False, dtype=dt)
        self.down_proj = nn.Linear(cfg.ffn_dim, cfg.dim, bias=False, dtype=dt)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.self_attn = Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.dim, cfg.norm_eps)
        self.mlp = MLP(cfg)

    def forward(self, x, pos, mask=None, cache=None):
        x = x + self.self_attn(self.input_layernorm(x), pos, mask, cache)
        return x + self.mlp(self.post_attention_layernorm(x))


class _Trunk(nn.Module):
    """``model.`` of the LLaMA names: the embedding, the layers, the norm."""

    def __init__(self, cfg: LMConfig, embed_input: bool):
        super().__init__()
        if embed_input:
            self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim, dtype=cfg.torch_dtype)
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.dim, cfg.norm_eps)


class TransformerLM(nn.Module):
    """Decoder-only LM.  ``embed_input=False``: the caller passes embeddings
    (b, t, dim); ``with_head=False``: the forward returns the final-normed
    hidden states.  With ``tie_embeddings`` (and an embedding) the head is
    the embedding table, in the configuration's type."""

    def __init__(self, cfg: LMConfig, embed_input: bool = True, with_head: bool = True):
        super().__init__()
        self.cfg, self.embed_input, self.with_head = cfg, embed_input, with_head
        self.model = _Trunk(cfg, embed_input)
        if with_head and not (cfg.tie_embeddings and embed_input):
            self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False)

    def forward(self, tokens_or_embeds, pos=None, caches=None, mask=None):
        """Returns (logits or hidden states, caches); the caches are the
        ones given, advanced in place (None without)."""
        c = self.cfg
        dt = c.torch_dtype
        if self.embed_input:
            x = self.model.embed_tokens(tokens_or_embeds)
        else:
            x = tokens_or_embeds.to(dt)
        t = x.shape[1]
        if pos is None:
            pos = torch.arange(t, device=x.device)
        for i, layer in enumerate(self.model.layers):
            x = layer(x, pos, mask, None if caches is None else caches[i])
        x = self.model.norm(x)
        if not self.with_head:
            return x, caches
        if c.tie_embeddings and self.embed_input:
            return x @ self.model.embed_tokens.weight.t(), caches
        return self.lm_head(x.float()), caches


def init_cache(cfg: LMConfig, batch: int, max_len: int | None = None,
               device: str | torch.device = "cpu") -> list[dict]:
    """Per-layer static caches: k and v (batch, max_len, n_kv_heads, head_dim)
    in the configuration's type, zero, and ``index`` (1,) int64 at 0."""
    max_len = max_len or cfg.max_seq_len
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    kw = dict(dtype=cfg.torch_dtype, device=device)
    return [dict(k=torch.zeros(shape, **kw), v=torch.zeros(shape, **kw),
                 index=torch.zeros(1, dtype=torch.long, device=device))
            for _ in range(cfg.n_layers)]


# ------------------------------------------------------------------ sampling

def gumbel_draws(total: int, rows: int, vocab: int, seed: int,
                 device: torch.device) -> torch.Tensor:
    """(total, rows, vocab) fp32 Gumbel draws -log(-log(u)), u uniform in
    [tiny, 1), from a generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((total, rows, vocab), generator=gen, device=device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return u.log_().neg_().log_().neg_()


def top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Logits below the k-th largest of their row set to -inf (every logit
    kept when top_k exceeds the row, as the JAX package's clamped index
    does)."""
    kth = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(logits < kth, -math.inf, logits)


def sample_logits(logits: torch.Tensor, gumbel: torch.Tensor | None = None,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """(b, vocab) -> (b,) token ids; temperature 0 => greedy.  Otherwise the
    argmax of the filtered logits plus ``gumbel`` (b, vocab), which is
    ``jax.random.categorical`` on the JAX key that drew them."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0:
        logits = top_k_mask(logits, top_k)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits.float(), dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, -math.inf, logits)
    return (logits + gumbel.to(logits.dtype)).argmax(dim=-1)


def cfg_logits(cond: torch.Tensor, uncond: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance combine (the double-batch trick)."""
    return uncond + scale * (cond - uncond)


# ------------------------------------------------------------------ decode

def model_device(model: nn.Module, device, graph: bool | None,
                 name: str) -> tuple[torch.device, bool]:
    """(the model's device, whether to capture) for a generate call asked to
    run on ``device`` (the card unless the caller asks for the CPU; raises
    without one, or when the model is elsewhere).  ``graph`` None captures
    on the card; a capture on the CPU raises."""
    dev = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != dev.type or None not in (on.index, dev.index) and on.index != dev.index:
        raise ValueError(f"{name}: the model is on {on}, not on {dev}")
    graph = on.type == "cuda" if graph is None else graph
    if graph and on.type != "cuda":
        raise ValueError(f"{name}: a CUDA graph needs the card")
    return on, graph


class StageTimer:
    """Seconds of a call's stages into ``stats`` (when given): each call
    synchronises the card and records the time since the previous one."""

    def __init__(self, stats: dict | None, device: torch.device):
        self.stats, self.device = stats, device
        self.t0 = time.perf_counter()

    def __call__(self, key: str) -> None:
        if self.stats is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stats[key] = now - self.t0
        self.t0 = now

    def put(self, key: str, value) -> None:
        if self.stats is not None:
            self.stats[key] = value


def replay(step: Callable[[], None], total: int, device: torch.device, graph: bool) -> None:
    """Runs ``step`` ``total`` times.  With ``graph`` the first step runs
    eagerly on a side stream (it warms cuBLAS and the allocator, as capture
    needs), the second is captured, which runs nothing, and the capture is
    replayed for every step after the first; the graph is released on
    return.  The capture is thread-local: only this thread is barred from
    unsafe CUDA calls while it lasts, so card work in another server thread
    neither fails it nor fails itself.  A capture that fails raises."""
    if total <= 0:
        return
    if not graph:
        for _ in range(total):
            step()
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    if total == 1:
        return
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        step()
    for _ in range(1, total):
        g.replay()


def resolve_draws(draws, shape: tuple, seed: int, device: torch.device) -> torch.Tensor:
    """The decode's draws as an fp32 tensor of ``shape`` on ``device``: made
    by :func:`gumbel_draws` from ``seed`` (``draws`` None), by ``draws(*shape)``
    (a callable), or ``draws`` itself."""
    if draws is None:
        draws = gumbel_draws(*shape, seed, device)
    elif callable(draws):
        draws = draws(*shape)
    draws = torch.as_tensor(draws, dtype=torch.float32, device=device)
    if tuple(draws.shape) != tuple(shape):
        raise ValueError(f"draws {tuple(draws.shape)}, expected {tuple(shape)}")
    return draws


@torch.inference_mode()
def decode(
    apply_fn: Callable,
    caches,
    first_token,                 # (b,)
    start_pos: int,
    steps: int,
    temperature: float = 1.0,
    top_k: int = 0,
    logit_processor: Callable | None = None,
    stop_token: int | None = None,
    vocab: int | None = None,
    seed: int = 0,
    draws=None,
    graph: bool | None = None,
) -> torch.Tensor:
    """AR decode over a static cache (the JAX package's ``decode``).

    ``apply_fn(tokens (b, 1), pos (1,), caches) -> (logits (b, 1, V), caches)``
    with the caches advanced in place.  Returns the tokens (b, steps).  A
    token that follows ``stop_token`` is ``stop_token`` (the check is on the
    token fed in, as in the JAX loop).  ``logit_processor(logits, i)`` gets
    the step as a (1,) tensor.  ``draws``: (steps, b, vocab) Gumbel draws, a
    callable of that shape, or None (:func:`gumbel_draws` from ``seed``;
    ``vocab`` is then needed); unused when ``temperature`` is 0.  ``graph``:
    capture one step and replay it (default on the card)."""
    tok = torch.as_tensor(first_token).clone()
    dev = tok.device
    graph = dev.type == "cuda" if graph is None else graph
    b = tok.shape[0]
    if temperature != 0.0:
        if vocab is None and isinstance(draws, torch.Tensor):
            vocab = draws.shape[-1]
        if vocab is None:
            raise ValueError("decode: vocab is needed to make the draws")
        draws = resolve_draws(draws, (steps, b, vocab), seed, dev)
    pos = torch.full((1,), start_pos, dtype=torch.long, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)
    out = torch.empty((b, steps), dtype=torch.long, device=dev)

    def step():
        logits, _ = apply_fn(tok[:, None], pos, caches)
        logits = logits[:, -1]
        if logit_processor is not None:
            logits = logit_processor(logits, i)
        g = None if temperature == 0.0 else draws.index_select(0, i)[0]
        nxt = sample_logits(logits, g, temperature, top_k)
        if stop_token is not None:
            nxt = torch.where(tok == stop_token, stop_token, nxt)
        out.index_copy_(1, i, nxt[:, None])
        tok.copy_(nxt)
        pos.add_(1)
        i.add_(1)

    replay(step, steps, dev, graph)
    return out
