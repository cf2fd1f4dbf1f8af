"""Chatterbox T3 and its voice encoder (counterpart of
audiolab_tpu/models/chatterbox_t3.py), laid out under the names of the
published ``t3_cfg.safetensors`` and ``ve.safetensors``, the names
``convert_chatterbox_t3`` and ``convert_voice_encoder`` map.

  T3      ``tfmr``: the LLaMA backbone (models/lm.py::TransformerLM without
          embedding or head; hidden 1024, 30 layers, 16 heads, ffn 4096,
          RMSNorm eps 1e-6, rotary) driven with input embeddings;
          ``text_emb`` / ``speech_emb`` with learned position embeddings
          (``*_pos_emb.emb``); ``cond_enc``: speaker Linear, the perceiver
          resampler (32 learned queries, one cross-attention applied twice)
          over the speech prompt, emotion Linear; ``text_head`` /
          ``speech_head``.  fp32 throughout.
  VoiceEncoder  3-layer LSTM over 40-mel frames (torch's gate order i, f,
          g, o, as ``lstm.weight_ih_l{k}``), Linear, ReLU, L2 norm;
          utterance embedding = the renormalised mean over 1.6 s windows.

Attention: T3's teacher-forced forward (no cache, t > 1) runs K2 through
``flash_attention`` (fp32, causal, d = 64: one launch per layer); the
prefill and the decode run through the static KV cache in plain PyTorch,
as the JAX package does.  The perceiver's cross-attention is plain ops.

:func:`t3_generate` is the JAX package's CFG decode (doubled batch whose
second row zeroes only the speaker embedding, ``c + w (c - u)``, the HF
repetition penalty over the counts of emitted tokens, temperature and
top-p, every ``max_new_tokens`` step run and the result cut at the first
stop token) on the shared decode core: one captured step replayed on the
card.  One repair: every decode position starts at the prefill's true
context length.  The JAX function rotates from ``2 + n_prompt + n_text + 1``,
which is past the context by ``n_prompt - perceiver_tokens`` whenever a
speech prompt of another length than ``perceiver_tokens`` is given (the
perceiver resamples any prompt to that many rows; ROADMAP queue 3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.mel import mel_spectrogram
from audiolab_tpu_torch.kernels.resample import resample
from audiolab_tpu_torch.models.lm import (
    LMConfig,
    StageTimer,
    TransformerLM,
    init_cache,
    model_device,
    replay,
    resolve_draws,
    sample_logits,
)


@dataclass(frozen=True)
class T3CkptConfig:
    """The published T3Config (t3/t3_config.py)."""

    text_vocab: int = 704
    speech_vocab: int = 8194
    start_text_token: int = 255
    stop_text_token: int = 0
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    max_text_tokens: int = 2048
    max_speech_tokens: int = 4096
    dim: int = 1024
    n_layers: int = 30
    n_heads: int = 16
    ffn_dim: int = 4096
    speaker_embed_size: int = 256
    perceiver_tokens: int = 32
    perceiver_heads: int = 4
    speech_cond_prompt_len: int = 150
    dtype: str = "float32"

    @property
    def text_pos_size(self) -> int:
        return self.max_text_tokens + 2

    @property
    def speech_pos_size(self) -> int:
        return self.max_speech_tokens + 4

    def lm(self, max_seq_len: int = 4096) -> LMConfig:
        return LMConfig(vocab_size=8, dim=self.dim, n_layers=self.n_layers,
                        n_heads=self.n_heads, n_kv_heads=self.n_heads, ffn_dim=self.ffn_dim,
                        norm_eps=1e-6, max_seq_len=max_seq_len, dtype=self.dtype)


class CrossAttention(nn.Module):
    """The perceiver's cross-attention: to_q/to_k/to_v bias-free, to_out
    biased (``to_out.0``), softmax in plain ops."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.Sequential(nn.Linear(dim, dim))

    def forward(self, q_in, kv):
        h, hd = self.heads, self.dim // self.heads
        b, tq, _ = q_in.shape
        tk = kv.shape[1]
        q = self.to_q(q_in).reshape(b, tq, h, hd).transpose(1, 2)
        k = self.to_k(kv).reshape(b, tk, h, hd).transpose(1, 2)
        v = self.to_v(kv).reshape(b, tk, h, hd).transpose(1, 2)
        a = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(hd)
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(a, dim=-1), v)
        return self.to_out(o.transpose(1, 2).reshape(b, tq, self.dim))


class PerceiverResampler(nn.Module):
    """``perceiver_tokens`` learned queries; one shared cross-attention
    applied twice (query -> ctx, then its output -> ctx again)."""

    def __init__(self, cfg: T3CkptConfig):
        super().__init__()
        self.pre_attention_query = nn.Parameter(torch.zeros(1, cfg.perceiver_tokens, cfg.dim))
        self.attn = CrossAttention(cfg.dim, cfg.perceiver_heads)

    def forward(self, ctx):
        q = self.pre_attention_query.expand(ctx.shape[0], -1, -1)
        return self.attn(self.attn(q, ctx), ctx)


class T3CondEnc(nn.Module):
    """[speaker | resampled speech prompt | emotion] prefix embeddings."""

    def __init__(self, cfg: T3CkptConfig):
        super().__init__()
        self.spkr_enc = nn.Linear(cfg.speaker_embed_size, cfg.dim)
        self.perceiver = PerceiverResampler(cfg)
        self.emotion_adv_fc = nn.Linear(1, cfg.dim)

    def forward(self, speaker_emb, prompt_emb=None, emotion_adv=None):
        parts = [self.spkr_enc(speaker_emb)[:, None]]
        if prompt_emb is not None:
            parts.append(self.perceiver(prompt_emb))
        if emotion_adv is None:
            emotion_adv = torch.full((speaker_emb.shape[0],), 0.5, device=speaker_emb.device)
        parts.append(self.emotion_adv_fc(emotion_adv.reshape(-1, 1, 1).float()))
        return torch.cat(parts, dim=1)


class LearnedPositionEmbeddings(nn.Module):
    def __init__(self, size: int, dim: int):
        super().__init__()
        self.emb = nn.Embedding(size, dim)


class T3(nn.Module):
    """Teacher-forced forward, and the prefill/step pair of the decode.

    ``tfmr`` is a TransformerLM, whose trunk sits under ``model.``; its
    state_dict keys are mapped to the checkpoint's ``tfmr.layers.N`` /
    ``tfmr.norm`` (LlamaModel's names) on save and load."""

    def __init__(self, cfg: T3CkptConfig, max_seq_len: int = 4096):
        super().__init__()
        self.cfg = c = cfg
        self.text_emb = nn.Embedding(c.text_vocab, c.dim)
        self.speech_emb = nn.Embedding(c.speech_vocab, c.dim)
        self.text_pos_emb = LearnedPositionEmbeddings(c.text_pos_size, c.dim)
        self.speech_pos_emb = LearnedPositionEmbeddings(c.speech_pos_size, c.dim)
        self.cond_enc = T3CondEnc(c)
        self.tfmr = TransformerLM(c.lm(max_seq_len), embed_input=False, with_head=False)
        self.text_head = nn.Linear(c.dim, c.text_vocab)
        self.speech_head = nn.Linear(c.dim, c.speech_vocab)
        self._register_state_dict_hook(_tfmr_names_out)
        self._register_load_state_dict_pre_hook(_tfmr_names_in)

    def context_len(self, n_text: int, prompt: bool) -> int:
        """Rows of the prefill: [speaker | perceiver rows | emotion], the text
        and the BOS speech token."""
        return 2 + (self.cfg.perceiver_tokens if prompt else 0) + n_text + 1

    def embed_prompt(self, prompt_tokens):
        """Speech-token prompt -> the perceiver's input (speech_emb +
        speech_pos_emb)."""
        t = prompt_tokens.shape[1]
        pos = torch.arange(t, device=prompt_tokens.device)
        return self.speech_emb(prompt_tokens) + self.speech_pos_emb.emb(pos)[None]

    def _context(self, text_ids, speech_ids, speaker_emb, prompt_tokens, emotion_adv):
        prompt_emb = None if prompt_tokens is None else self.embed_prompt(prompt_tokens)
        cond = self.cond_enc(speaker_emb, prompt_emb, emotion_adv)
        dev = text_ids.device
        tex = (self.text_emb(text_ids)
               + self.text_pos_emb.emb(torch.arange(text_ids.shape[1], device=dev))[None])
        spe = (self.speech_emb(speech_ids)
               + self.speech_pos_emb.emb(torch.arange(speech_ids.shape[1], device=dev))[None])
        cond = cond.expand(tex.shape[0], -1, -1)
        return torch.cat([cond, tex, spe], dim=1), cond.shape[1]

    def forward(self, text_ids, speech_ids, speaker_emb, prompt_tokens=None, emotion_adv=None):
        """Teacher-forced: (text_logits, speech_logits)."""
        x, n_cond = self._context(text_ids, speech_ids, speaker_emb, prompt_tokens,
                                  emotion_adv)
        h, _ = self.tfmr(x)
        n_text = text_ids.shape[1]
        return (self.text_head(h[:, n_cond:n_cond + n_text]),
                self.speech_head(h[:, n_cond + n_text:]))

    def prefill(self, text_ids, speaker_emb, prompt_tokens, emotion_adv, caches):
        """Context + the BOS speech token through the caches: (logits (b, 1,
        V) at BOS, the context length)."""
        bos = torch.full((text_ids.shape[0], 1), self.cfg.start_speech_token,
                         dtype=torch.long, device=text_ids.device)
        x, _ = self._context(text_ids, bos, speaker_emb, prompt_tokens, emotion_adv)
        h, _ = self.tfmr(x, pos=torch.arange(x.shape[1], device=x.device), caches=caches)
        return self.speech_head(h[:, -1:]), x.shape[1]

    def step(self, tokens, step_idx, pos, caches):
        """tokens (b, 1) at speech position ``step_idx`` (1,) (1-based after
        BOS) and rotary position ``pos`` (1,): logits (b, 1, V)."""
        x = self.speech_emb(tokens) + self.speech_pos_emb.emb(step_idx)[None]
        h, _ = self.tfmr(x, pos=pos, caches=caches)
        return self.speech_head(h)


def _tfmr_names_out(module, state_dict, prefix, local_metadata):
    old = f"{prefix}tfmr.model."
    for key in [k for k in state_dict if k.startswith(old)]:
        state_dict[f"{prefix}tfmr.{key[len(old):]}"] = state_dict.pop(key)
    return state_dict


def _tfmr_names_in(state_dict, prefix, local_metadata, strict, missing, unexpected, errors):
    new = f"{prefix}tfmr."
    for key in [k for k in state_dict if k.startswith(new)
                and not k.startswith(f"{new}model.")]:
        state_dict[f"{new}model.{key[len(new):]}"] = state_dict.pop(key)


def t3_init_cache(cfg: T3CkptConfig, batch: int, max_len: int,
                  device: str | torch.device = "cpu") -> list[dict]:
    return init_cache(cfg.lm(max_len), batch, max_len, device)


@torch.inference_mode()
def t3_generate(model: T3, text_ids, speaker_emb, prompt_tokens=None,
                emotion_adv: float = 0.5, max_new_tokens: int = 600, cfg_weight: float = 0.5,
                temperature: float = 0.8, top_p: float = 0.8,
                repetition_penalty: float = 1.2, seed: int = 0, draws=None,
                graph: bool | None = None, stats: dict | None = None,
                device: str | torch.device = "cuda") -> np.ndarray:
    """AR speech-token generation with CFG (the JAX package's t3_generate).

    ``text_ids`` (1, t) already wrapped in the start/stop text tokens.  The
    first token comes from the prefill's logits, then ``max_new_tokens``
    steps, each feeding the last token at the next position; a token after
    the first stop is the stop token.  ``draws``: (max_new_tokens + 1, 1,
    speech_vocab) Gumbel draws (row 0 for the first token), a callable of
    that shape, or None (from ``seed``).  ``graph``: capture one step and
    replay it (default on the card).  ``stats`` gets the stages' seconds.
    ``max_new_tokens`` is capped at the speech position table
    (``speech_pos_size - 1``).  Returns (1, n) int32 tokens, cut before the
    first stop token."""
    dev, graph = model_device(model, device, graph, "t3_generate")
    c = model.cfg
    # step i reads speech position i: the table's last row bounds the decode
    # (the JAX function reads NaN rows past it; ROADMAP queue 3)
    max_new_tokens = min(max_new_tokens, c.speech_pos_size - 1)
    mark = StageTimer(stats, dev)
    vocab, stop = c.speech_vocab, c.stop_speech_token
    draws = resolve_draws(draws, (max_new_tokens + 1, 1, vocab), seed, dev)
    text = torch.as_tensor(np.asarray(text_ids), dtype=torch.long, device=dev).repeat(2, 1)
    spk = torch.as_tensor(np.asarray(speaker_emb, np.float32), device=dev).reshape(1, -1)
    spk = torch.cat([spk, torch.zeros_like(spk)])
    prompt = (None if prompt_tokens is None else torch.as_tensor(
        np.asarray(prompt_tokens), dtype=torch.long, device=dev).repeat(2, 1))
    emo = torch.full((2,), float(emotion_adv), device=dev)
    n_ctx = model.context_len(text.shape[1], prompt is not None)
    caches = t3_init_cache(c, 2, n_ctx + max_new_tokens + 1, dev)
    logits, ctx = model.prefill(text, spk, prompt, emo, caches)
    mark("prefill_s")
    counts = torch.zeros(vocab, dtype=torch.long, device=dev)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    tok = torch.empty((2, 1), dtype=torch.long, device=dev)
    out = torch.empty(max_new_tokens + 1, dtype=torch.long, device=dev)
    one = torch.ones(1, dtype=torch.long, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)

    def sample():
        lc, lu = logits[0:1, -1], logits[1:2, -1]
        lg = lc + cfg_weight * (lc - lu)
        pen = torch.where(lg > 0, lg / repetition_penalty, lg * repetition_penalty)
        lg = torch.where(counts[None] > 0, pen, lg)
        nxt = sample_logits(lg, draws.index_select(0, i)[0], temperature, top_p=top_p)
        nxt = torch.where(done, stop, nxt)
        done.logical_or_(nxt == stop)
        counts.index_add_(0, nxt, one)
        out.index_copy_(0, i, nxt)
        tok.copy_(nxt.expand(2, 1))
        i.add_(1)

    def step():
        logits.copy_(model.step(tok, i, ctx - 1 + i, caches))
        sample()

    sample()
    replay(step, max_new_tokens, dev, graph)
    mark("decode_s")
    mark.put("steps", max_new_tokens)
    mark.put("context", ctx)
    codes = out.cpu().numpy()
    stops = np.nonzero(codes == stop)[0]
    if stops.size:
        codes = codes[: stops[0]]
    return codes[None].astype(np.int32)


@torch.inference_mode()
def t3_cached_logits(model: T3, text_ids, speech_ids, speaker_emb, prompt_tokens=None,
                     emotion_adv=None) -> torch.Tensor:
    """The speech logits the decode computes, eagerly, for a given token
    stream: the prefill's at BOS, then one cached step per token of
    ``speech_ids`` (b, n) at the positions :func:`t3_generate` uses.
    (b, n + 1, V); row j is the teacher-forced forward's speech row j for
    speech ids [BOS, speech_ids]."""
    dev = next(model.parameters()).device
    text = torch.as_tensor(text_ids, dtype=torch.long, device=dev)
    speech = torch.as_tensor(speech_ids, dtype=torch.long, device=dev)
    b, n = speech.shape
    n_ctx = model.context_len(text.shape[1], prompt_tokens is not None)
    caches = t3_init_cache(model.cfg, b, n_ctx + n + 1, dev)
    logits, ctx = model.prefill(text, speaker_emb, prompt_tokens, emotion_adv, caches)
    rows = [logits]
    for j in range(n):
        i = torch.full((1,), j + 1, dtype=torch.long, device=dev)
        rows.append(model.step(speech[:, j:j + 1], i, ctx - 1 + i, caches))
    return torch.cat(rows, dim=1)


# ------------------------------------------------------------ voice encoder

@dataclass(frozen=True)
class VoiceEncoderConfig:
    n_mels: int = 40
    hidden: int = 256
    out: int = 256
    n_layers: int = 3
    sr: int = 16000
    n_fft: int = 400
    hop: int = 160
    partial_frames: int = 160


class VoiceEncoder(nn.Module):
    """Resemblyzer-layout speaker encoder: 3-layer LSTM over 40-mel frames,
    the last hidden state -> Linear -> ReLU -> L2 norm."""

    def __init__(self, cfg: VoiceEncoderConfig = VoiceEncoderConfig()):
        super().__init__()
        self.cfg = cfg
        self.lstm = nn.LSTM(cfg.n_mels, cfg.hidden, cfg.n_layers, batch_first=True)
        self.proj = nn.Linear(cfg.hidden, cfg.out)

    def forward(self, mels):
        """mels (b, t, n_mels) -> (b, out) unit-norm embeddings."""
        ys, _ = self.lstm(mels)
        e = F.relu(self.proj(ys[:, -1]))
        return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-8)


@torch.inference_mode()
def utterance_embedding(model: VoiceEncoder, wav, sr: int) -> np.ndarray:
    """Partial-window utterance embedding on the model's device: 1.6 s
    windows, 50 % overlap, the renormalised mean (voice_encoder.py
    embeds_from_wavs).  Other rates than 16 kHz go through the port's
    ``resample``."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(wav, np.float32), device=dev)
    if sr != cfg.sr:
        x = resample(x, sr, cfg.sr)
    mel = mel_spectrogram(x[None], sr=cfg.sr, n_fft=cfg.n_fft, hop=cfg.hop, n_mels=cfg.n_mels)
    mel = torch.log(torch.clamp(mel, min=1e-10))
    t = mel.shape[1]
    win, hop = cfg.partial_frames, cfg.partial_frames // 2
    if t < win:
        mel = F.pad(mel, (0, 0, 0, win - t))
        t = win
    starts = list(range(0, max(t - win, 0) + 1, hop)) or [0]
    embeds = model(torch.cat([mel[:, s:s + win] for s in starts], dim=0))
    mean = embeds.mean(dim=0)
    return (mean / torch.clamp(torch.linalg.norm(mean), min=1e-8)).cpu().numpy()
