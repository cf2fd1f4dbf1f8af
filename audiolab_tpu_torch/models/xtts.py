"""XTTS-class voice-cloning TTS (counterpart of audiolab_tpu/models/xtts.py).

Two stacks, as in the JAX package:

- The capability engine (``XTTSConfig``, ``ConditioningEncoder``,
  ``XttsGPT`` on the LM core's ``TransformerLM``, ``XttsVocoder`` on
  BigVGAN, ``XTTS``): reference mel -> conditioning latents and a speaker
  vector, a GPT over [latents | text | audio codes] prefilled through its
  static cache and decoded by ``models.lm.decode`` (one captured step,
  replayed), codes -> waveform.  Names follow the JAX tree's modules.
- The XTTS-v2 checkpoint stack under Coqui's key names, the names the
  ``convert_xtts_*`` converters map: ``XttsGPT2`` (GPT-2 blocks, per-stream
  learned positions, ``ln_f`` and ``final_norm``), ``XttsConditioningEncoder``
  (tortoise attention blocks), ``XttsPerceiverResampler``,
  ``XttsSpeakerEncoder`` (the H/ASP ResNet with its BatchNorm statistics),
  ``XttsHifiganDecoder`` and ``XttsDVAE``.

``xtts_gpt2_generate`` decodes from a static KV cache with one captured
step, where the JAX function re-runs a full forward over the padded
sequence at every step: causal masking makes the logits the same function.
The latents come from one teacher-forced forward at the end, as the JAX
function takes them.  Everything is fp32, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.kernels.mel import log_mel, mel_filterbank, mel_spectrogram
from audiolab_tpu_torch.kernels.stft import spectrogram
from audiolab_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from audiolab_tpu_torch.models.lm import (
    LMConfig,
    StageTimer,
    TransformerLM,
    decode,
    init_cache,
    model_device,
    replay,
    resolve_draws,
    top_k_mask,
)
from audiolab_tpu_torch.models.zonos import _flax_layer_norm, _same_pads
from audiolab_tpu_torch.utils.fast_init import fast_init


@dataclass(frozen=True)
class XTTSConfig:
    text_vocab: int = 256           # byte-level text tokens
    n_codes: int = 1024             # VQ audio codebook
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    cond_latents: int = 8           # conditioning prefix length
    mel_bins: int = 80
    sr: int = 24000
    max_seq_len: int = 2048
    dtype: str = "float32"

    @property
    def audio_start(self) -> int:   # BOS for the audio stream
        return self.n_codes

    @property
    def audio_stop(self) -> int:
        return self.n_codes + 1

    @property
    def audio_vocab(self) -> int:
        return self.n_codes + 2

    def lm(self) -> LMConfig:
        return LMConfig(vocab_size=self.audio_vocab, dim=self.dim, n_layers=self.n_layers,
                        n_heads=self.n_heads, n_kv_heads=self.n_heads, ffn_dim=self.dim * 4,
                        max_seq_len=self.max_seq_len, dtype=self.dtype)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class FlaxMHA(nn.Module):
    """flax ``MultiHeadDotProductAttention``: query/key/value kernels (in,
    heads, hd) with (heads, hd) biases, q divided by sqrt(hd) before the
    product, the out kernel (heads, hd, out) with a bias."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        hd = dim // heads
        for name in ("query", "key", "value"):
            setattr(self, name, _DenseGeneral((dim, heads, hd), (heads, hd), "btc,chd->bthd"))
        self.out = _DenseGeneral((heads, hd, dim), (dim,), "bqhd,hdo->bqo")

    def forward(self, xq, xkv):
        q, k, v = self.query(xq), self.key(xkv), self.value(xkv)
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class _DenseGeneral(nn.Module):
    """flax DenseGeneral: ``kernel`` and ``bias`` under the flax names,
    applied by ``eq``."""

    def __init__(self, kernel_shape: tuple, bias_shape: tuple, eq: str):
        super().__init__()
        self.eq = eq
        self.kernel = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))

    def forward(self, x):
        return torch.einsum(self.eq, x, self.kernel) + self.bias


class ConditioningEncoder(nn.Module):
    """Reference mel (b, t, mel_bins) -> (cond latents (b, L, dim), unit
    speaker vector (b, dim)): two stride-2 convolutions (flax SAME padding)
    with tanh GELU, LayerNorm (eps 1e-6), learned queries attending to the
    frames, a residual dense on GELU."""

    def __init__(self, cfg: XTTSConfig):
        super().__init__()
        c = cfg
        self.conv1 = nn.Conv1d(c.mel_bins, c.dim, 3, stride=2)
        self.conv2 = nn.Conv1d(c.dim, c.dim, 3, stride=2)
        self.ln = nn.LayerNorm(c.dim, eps=1e-6)
        self.queries = nn.Parameter(torch.zeros(c.cond_latents, c.dim))
        self.xattn = FlaxMHA(c.dim, c.n_heads)
        self.ff = nn.Linear(c.dim, c.dim)

    @staticmethod
    def _conv(conv, x):
        lo, hi = _same_pads(x.shape[-1], 3, 2)
        return conv(F.pad(x, (lo, hi)))

    def forward(self, mel):
        x = gelu_tanh(self._conv(self.conv1, mel.transpose(1, 2)))
        x = gelu_tanh(self._conv(self.conv2, x)).transpose(1, 2)
        x = _flax_layer_norm(x, self.ln)
        q = self.queries.expand(x.shape[0], -1, -1)
        lat = self.xattn(q, x)
        lat = lat + self.ff(gelu_tanh(lat))
        spk = x.mean(dim=1)
        return lat, spk / torch.clamp(torch.linalg.norm(spk, dim=-1, keepdim=True), min=1e-6)


class XttsGPT(nn.Module):
    """Decoder-only LM over [cond latents | text | audio codes]."""

    def __init__(self, cfg: XTTSConfig):
        super().__init__()
        c = self.cfg = cfg
        self.text_emb = nn.Embedding(c.text_vocab, c.dim)
        self.audio_emb = nn.Embedding(c.audio_vocab, c.dim)
        self.lm = TransformerLM(c.lm(), embed_input=False, with_head=False)
        self.audio_head = nn.Linear(c.dim, c.audio_vocab, bias=False)

    def prefill(self, cond, text_ids, caches):
        """cond (b, L, dim), text (b, s) -> logits for the first audio token
        (b, 1, V), through the caches."""
        bos = self.audio_emb(torch.full((text_ids.shape[0], 1), self.cfg.audio_start,
                                        dtype=torch.long, device=text_ids.device))
        x = torch.cat([cond, self.text_emb(text_ids), bos], dim=1)
        h, caches = self.lm(x, pos=torch.arange(x.shape[1], device=x.device), caches=caches)
        return self.audio_head(h[:, -1:].float()), caches

    def step(self, tokens, pos, caches):
        """tokens (b, 1) audio ids at ``pos`` (1,) -> next-token logits."""
        h, caches = self.lm(self.audio_emb(tokens), pos=pos, caches=caches)
        return self.audio_head(h.float()), caches


class XttsVocoder(nn.Module):
    """Audio codes -> waveform: code embeddings plus the projected speaker
    vector through BigVGAN (rates 8, 8, 4)."""

    def __init__(self, cfg: XTTSConfig):
        super().__init__()
        c = cfg
        self.code_emb = nn.Embedding(c.n_codes, c.mel_bins)
        self.spk_proj = nn.Linear(c.dim, c.mel_bins)
        self.bigvgan = BigVGAN(BigVGANConfig(
            n_mels=c.mel_bins, upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
            upsample_initial_channel=256))

    def forward(self, codes, spk):
        return self.bigvgan(self.code_emb(codes) + self.spk_proj(spk)[:, None, :])


class XTTS:
    """The three modules on one device (default the card; raises without
    one) and the generate path (the engine core)."""

    def __init__(self, cfg: XTTSConfig, cond_enc: ConditioningEncoder, gpt: XttsGPT,
                 vocoder: XttsVocoder, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cond_enc = cond_enc.to(self.device).eval()
        self.gpt = gpt.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval()

    @classmethod
    def random_init(cls, cfg: XTTSConfig, seed: int = 0,
                    device: str | torch.device = "cuda") -> "XTTS":
        """Random weights by utils/fast_init's rules, made on ``device``."""
        dev = resolve_device(device)
        with dev:
            mods = [fast_init(m(cfg), seed + i)
                    for i, m in enumerate((ConditioningEncoder, XttsGPT, XttsVocoder))]
        return cls(cfg, *mods, device=dev)

    @torch.inference_mode()
    def embed_reference(self, wav: np.ndarray, sr: int):
        """Reference clip -> (cond latents, speaker vector)."""
        x = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)[None]
        mel = log_mel(mel_spectrogram(x, sr=sr, n_fft=1024, hop=256, n_mels=self.cfg.mel_bins))
        return self.cond_enc(mel)

    @torch.inference_mode()
    def generate_codes(self, cond, text_ids, steps: int, seed: int = 0,
                       draws=None) -> torch.Tensor:
        """Greedy first token from the prefill, then ``decode`` (temperature
        0.75, top-k 50, the stop token held) for ``steps`` tokens.  ``draws``:
        (steps, b, audio_vocab) Gumbel draws, a callable, or None (seed)."""
        c = self.cfg
        dev, graph = model_device(self.gpt, self.device, None, "generate_codes")
        text_ids = torch.as_tensor(text_ids, dtype=torch.long, device=dev)
        caches = init_cache(c.lm(), text_ids.shape[0], c.max_seq_len, dev)
        logits, caches = self.gpt.prefill(cond, text_ids, caches)
        start = cond.shape[1] + text_ids.shape[1] + 1
        return decode(self.gpt.step, caches, logits[:, -1].argmax(dim=-1), start, steps,
                      temperature=0.75, top_k=50, stop_token=c.audio_stop,
                      vocab=c.audio_vocab, seed=seed, draws=draws, graph=graph)

    @torch.inference_mode()
    def tts(self, text: str, ref_wav: np.ndarray, ref_sr: int, max_codes: int = 256,
            seed: int = 0, draws=None) -> tuple[np.ndarray, int]:
        c = self.cfg
        cond, spk = self.embed_reference(ref_wav, ref_sr)
        ids = np.asarray([min(b, c.text_vocab - 1) for b in text.encode("utf-8")],
                         np.int64)[None]
        codes = self.generate_codes(cond, ids, max_codes, seed, draws)
        # BOS/STOP ids clamped into the vocoder's range
        wav = self.vocoder(torch.clamp(codes, 0, c.n_codes - 1), spk)
        return wav[0].cpu().numpy(), c.sr


# ------------------------------------------- checkpoint HiFi-GAN decoder

class _ResBlock1(nn.Module):
    """Coqui ResBlock1: [lrelu(0.1) -> dilated conv -> lrelu(0.1) -> conv]
    per dilation, residual, under ``convs1.j`` / ``convs2.j``."""

    def __init__(self, ch: int, kernel: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(ch, ch, kernel, dilation=d,
                                              padding=d * (kernel - 1) // 2)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(ch, ch, kernel, padding=(kernel - 1) // 2)
                                    for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, 0.1)), 0.1))
        return x


class XttsHifiganDecoder(nn.Module):
    """XTTS-v2's waveform decoder (hifigan_decoder.py -> HifiganGenerator):
    GPT latents (b, t, input_dim) and the speaker d-vector (b, cond_dim) ->
    24 kHz waveform (b, t * prod(upsample_rates)).  ``conv_pre``/``conv_post``
    carry no weight norm, ``conv_post`` no bias; the d-vector enters through
    ``cond_layer`` at the stem and a 1x1 ``conds.i`` at every upsample stage;
    the last leaky ReLU has torch's default slope 0.01.  Weight-normed
    convolutions hold the folded weight as a plain ``.weight``."""

    def __init__(self, input_dim: int = 1024, cond_dim: int = 512,
                 upsample_rates=(8, 8, 2, 2), upsample_kernels=(16, 16, 4, 4),
                 resblock_kernels=(3, 7, 11), resblock_dilations=((1, 3, 5),) * 3,
                 initial_channel: int = 512):
        super().__init__()
        ch = initial_channel
        self.conv_pre = nn.Conv1d(input_dim, ch, 7, padding=3)
        self.cond_layer = nn.Conv1d(cond_dim, ch, 1)
        ups, conds, res = [], [], []
        for u, k in zip(upsample_rates, upsample_kernels):
            ups.append(nn.ConvTranspose1d(ch, ch // 2, k, u, padding=(k - u) // 2))
            ch //= 2
            conds.append(nn.Conv1d(cond_dim, ch, 1))
            res.extend(_ResBlock1(ch, rk, rd)
                       for rk, rd in zip(resblock_kernels, resblock_dilations))
        self.ups, self.conds, self.resblocks = (nn.ModuleList(ups), nn.ModuleList(conds),
                                                nn.ModuleList(res))
        self.n_kernels = len(resblock_kernels)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, latents, g):
        g = g[:, :, None]
        x = self.conv_pre(latents.transpose(1, 2)) + self.cond_layer(g)
        for i, (up, cond) in enumerate(zip(self.ups, self.conds)):
            x = up(F.leaky_relu(x, 0.1)) + cond(g)
            blocks = self.resblocks[i * self.n_kernels:(i + 1) * self.n_kernels]
            x = sum(rb(x) for rb in blocks) / self.n_kernels
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))[:, 0]


# --------------------------------------- checkpoint ResNet speaker encoder

class _SELayer(nn.Module):
    def __init__(self, ch: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(ch, ch // reduction), nn.ReLU(),
                                nn.Linear(ch // reduction, ch), nn.Sigmoid())

    def forward(self, x):                                         # (b, c, h, w)
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class _SEBasicBlock(nn.Module):
    """resnet.py's block in its op order conv1 -> relu -> bn1 (bn after
    relu) -> conv2 -> bn2 -> SE, plus the (1x1 conv, bn) downsample."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.se = _SELayer(planes)
        self.downsample = (nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride=stride,
                                                   bias=False), nn.BatchNorm2d(planes))
                           if downsample else None)

    def forward(self, x):
        h = self.bn2(self.conv2(self.bn1(F.relu(self.conv1(x)))))
        h = self.se(h)
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class XttsSpeakerEncoder(nn.Module):
    """XTTS-v2's H/ASP ResNet34-SE d-vector network (encoder/models/
    resnet.py, input_dim 64, proj_dim 512, log_input): mel-power frames
    (b, t, 64) from :func:`speaker_mel` -> (b, proj_dim), optionally L2
    normalised.  BatchNorm runs on its running statistics (eval mode)."""

    def __init__(self, input_dim: int = 64, proj_dim: int = 512, layers=(3, 4, 6, 3),
                 num_filters=(32, 64, 128, 256)):
        super().__init__()
        self.conv1 = nn.Conv2d(1, num_filters[0], 3, padding=1)
        self.bn1 = nn.BatchNorm2d(num_filters[0])
        inplanes = num_filters[0]
        for li, (planes, blocks) in enumerate(zip(num_filters, layers)):
            stride = 1 if li == 0 else 2
            mods = []
            for j in range(blocks):
                s = stride if j == 0 else 1
                mods.append(_SEBasicBlock(inplanes, planes, s,
                                          j == 0 and (s != 1 or inplanes != planes)))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*mods))
        self.n_layers = len(layers)
        out = num_filters[-1] * (input_dim // 8)
        self.attention = nn.Sequential(nn.Conv1d(out, 128, 1), nn.ReLU(), nn.BatchNorm1d(128),
                                       nn.Conv1d(128, out, 1))
        self.fc = nn.Linear(2 * out, proj_dim)

    def forward(self, mel, l2_norm: bool = False):
        x = torch.log(mel + 1e-6)
        # InstanceNorm1d over time per mel channel (no affine, eps 1e-5)
        mu = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        x = ((x - mu) / torch.sqrt(var + 1e-5)).transpose(1, 2)[:, None]   # (b, 1, mel, t)
        x = self.bn1(F.relu(self.conv1(x)))
        for li in range(self.n_layers):
            x = getattr(self, f"layer{li + 1}")(x)
        b, cc, hh, ww = x.shape
        x = x.permute(0, 3, 1, 2).reshape(b, ww, cc * hh)                  # torch's c-major flatten
        w = torch.softmax(self.attention(x.transpose(1, 2)), dim=2).transpose(1, 2)
        mu = (x * w).sum(dim=1)
        sg = torch.sqrt(torch.clamp((x * x * w).sum(dim=1) - mu * mu, min=1e-5))
        out = self.fc(torch.cat([mu, sg], dim=-1))
        if l2_norm:
            out = out / torch.linalg.norm(out, dim=-1, keepdim=True)
        return out


def speaker_mel(wav16k: torch.Tensor) -> torch.Tensor:
    """The speaker encoder's front end (base_encoder.py:39-65): reflect-pad
    pre-emphasis 0.97, then torchaudio's default mel power spectrogram (fft
    512, win 400 Hamming, hop 160, 64 HTK mels, no norm, centred).  (b, t)
    16 kHz -> (b, frames, 64)."""
    x = torch.cat([wav16k[:, 1:2], wav16k], dim=1)
    x = x[:, 1:] - 0.97 * x[:, :-1]
    spec = spectrogram(x, n_fft=512, hop=160, win_length=400, window="hamming", center=True,
                       power=2.0)
    fb = torch.from_numpy(mel_filterbank(16000, 512, 64, 0.0, 8000.0, htk=True, norm=None))
    return spec @ fb.to(spec.device)


# ----------------------------------------------- checkpoint GPT-2 backbone

class _Conv1D(nn.Module):
    """transformers' Conv1D: ``weight`` (in, out) and ``bias``."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(din, dout))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x):
        return x @ self.weight + self.bias


class _Attn(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_attn = _Conv1D(dim, 3 * dim)
        self.c_proj = _Conv1D(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = _Conv1D(dim, 4 * dim)
        self.c_proj = _Conv1D(4 * dim, dim)

    def forward(self, x):
        return self.c_proj(gelu_tanh(self.c_fc(x)))


class _Gpt2Block(nn.Module):
    """transformers GPT2Block: pre-LN (eps 1e-5), fused [q | k | v] causal
    attention (scores / sqrt(d_head), masked with finfo.min), tanh GELU MLP."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = _Attn(dim)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim)

    def _qkv(self, x):
        b, t, d = x.shape
        return (a.reshape(b, t, self.heads, d // self.heads)
                for a in self.attn.c_attn(_flax_layer_norm(x, self.ln_1)).chunk(3, dim=-1))

    def _finish(self, x, q, k, v, mask):
        b, t, d = x.shape
        logits = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d // self.heads)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        o = torch.einsum("bhts,bshd->bthd", torch.softmax(logits, dim=-1), v).reshape(b, t, d)
        x = x + self.attn.c_proj(o)
        return x + self.mlp(_flax_layer_norm(x, self.ln_2))

    def forward(self, x):
        q, k, v = self._qkv(x)
        t = x.shape[1]
        return self._finish(x, q, k, v,
                            torch.ones(t, t, dtype=torch.bool, device=x.device).tril())

    def prefill(self, x, cache):
        """Forward over x (b, t, d) that writes k/v into ``cache`` [k, v]
        (b, L, heads, d_head) at positions 0..t-1."""
        q, k, v = self._qkv(x)
        t = x.shape[1]
        cache[0][:, :t] = k
        cache[1][:, :t] = v
        return self._finish(x, q, k, v,
                            torch.ones(t, t, dtype=torch.bool, device=x.device).tril())

    def step(self, x, pos, cache):
        """One position x (b, 1, d) at ``pos`` (1,): writes its k/v into the
        cache in place and attends over positions <= pos."""
        q, k, v = self._qkv(x)
        cache[0].index_copy_(1, pos, k)
        cache[1].index_copy_(1, pos, v)
        mask = (torch.arange(cache[0].shape[1], device=x.device) <= pos)[None, :]
        return self._finish(x, q, cache[0], cache[1], mask)


class _PosEmb(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.emb = nn.Embedding(n, dim)


class _Gpt2(nn.Module):
    def __init__(self, layers: int, dim: int, heads: int):
        super().__init__()
        self.h = nn.ModuleList(_Gpt2Block(dim, heads) for _ in range(layers))
        self.ln_f = nn.LayerNorm(dim, eps=1e-5)


class XttsGPT2(nn.Module):
    """XTTS-v2's autoregressive core (TTS/tts/layers/xtts/gpt.py around a
    GPT2Model with nulled wpe/wte): text and mel token embeddings with
    per-stream learned positions -> GPT-2 stack -> ``ln_f`` -> ``final_norm``
    -> text and mel heads.  The conditioning prefix (the perceiver's output)
    is passed pre-embedded as ``cond``.  The state_dict is the checkpoint's
    ``gpt.`` subtree without that prefix."""

    def __init__(self, layers: int = 30, dim: int = 1024, heads: int = 16,
                 n_text: int = 6681, n_audio: int = 1026, max_text: int = 402,
                 max_mel: int = 605, start_text: int = 261, stop_text: int = 0):
        super().__init__()
        self.dim, self.heads, self.n_text, self.n_audio = dim, heads, n_text, n_audio
        self.max_text, self.max_mel = max_text, max_mel
        self.start_text, self.stop_text = start_text, stop_text
        self.text_embedding = nn.Embedding(n_text, dim)
        self.text_pos_embedding = _PosEmb(max_text, dim)
        self.mel_embedding = nn.Embedding(n_audio, dim)
        self.mel_pos_embedding = _PosEmb(max_mel, dim)
        self.gpt = _Gpt2(layers, dim, heads)
        self.final_norm = nn.LayerNorm(dim, eps=1e-5)
        self.text_head = nn.Linear(dim, n_text)
        self.mel_head = nn.Linear(dim, n_audio)

    def _embed(self, text_ids, mel_ids, cond):
        te = self.text_embedding(text_ids) + self.text_pos_embedding.emb.weight[:text_ids.shape[1]]
        me = self.mel_embedding(mel_ids) + self.mel_pos_embedding.emb.weight[:mel_ids.shape[1]]
        return torch.cat(([] if cond is None else [cond]) + [te, me], dim=1)

    def _norm(self, x):
        return _flax_layer_norm(_flax_layer_norm(x, self.gpt.ln_f), self.final_norm)

    def forward(self, text_ids, mel_ids, cond=None, return_latents: bool = False):
        """(b, tt), (b, tm), cond (b, tc, dim) -> (text_logits, mel_logits)
        teacher-forced over [cond | text | mel] (+ the final-normed mel
        hidden states with ``return_latents``)."""
        x = self._embed(text_ids, mel_ids, cond)
        for blk in self.gpt.h:
            x = blk(x)
        x = self._norm(x)
        tc = 0 if cond is None else cond.shape[1]
        tt = text_ids.shape[1]
        text_h, mel_h = x[:, tc:tc + tt], x[:, tc + tt:]
        out = (self.text_head(text_h), self.mel_head(mel_h))
        return out + (mel_h,) if return_latents else out

    def init_cache(self, batch: int, length: int, device) -> list[list[torch.Tensor]]:
        shape = (batch, length, self.heads, self.dim // self.heads)
        return [[torch.zeros(shape, device=device) for _ in range(2)] for _ in self.gpt.h]

    def prefill(self, text_ids, mel_ids, cond, caches):
        """[cond | text | mel] through the caches -> the last position's mel
        logits (b, n_audio)."""
        x = self._embed(text_ids, mel_ids, cond)
        for blk, cache in zip(self.gpt.h, caches):
            x = blk.prefill(x, cache)
        return self.mel_head(self._norm(x[:, -1]))

    def step(self, mel_tok, seq_pos, mel_pos, caches):
        """mel_tok (b,) at sequence position ``seq_pos`` and mel position
        ``mel_pos`` ((1,) each) -> its mel logits (b, n_audio)."""
        x = (self.mel_embedding(mel_tok) + self.mel_pos_embedding.emb(mel_pos))[:, None]
        for blk, cache in zip(self.gpt.h, caches):
            x = blk.step(x, seq_pos, cache)
        return self.mel_head(self._norm(x[:, 0]))


# ------------------------------------- checkpoint conditioning encoders

class _TortoiseAttnBlock(nn.Module):
    """tortoise AttentionBlock with XTTS's settings: GroupNorm, a 1x1 qkv with
    per-head [q | k | v] channels, softmax attention, a 1x1 proj_out; the
    residual is taken from the normalised input, as upstream does."""

    def __init__(self, ch: int, heads: int):
        super().__init__()
        groups = 32 if ch > 64 else (16 if ch > 16 else 8)
        while ch % groups:
            groups //= 2
        self.heads = heads
        self.norm = nn.GroupNorm(groups, ch, eps=1e-5)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x):                                         # (b, c, t)
        b, c, t = x.shape
        xn = self.norm(x)
        ch = c // self.heads
        qkv = self.qkv(xn).reshape(b, self.heads, 3 * ch, t)
        q, k, v = qkv[:, :, :ch], qkv[:, :, ch:2 * ch], qkv[:, :, 2 * ch:]
        w = torch.softmax(torch.einsum("bhdt,bhds->bhts", q, k) / math.sqrt(ch), dim=-1)
        o = torch.einsum("bhts,bhds->bhdt", w, v).reshape(b, c, t)
        return xn + self.proj_out(o)


class XttsConditioningEncoder(nn.Module):
    """gpt.py's ConditioningEncoder: a 1x1 lift of 80-mel frames to ``dim``
    and ``blocks`` tortoise attention blocks.  (b, t, 80) -> (b, t, dim)."""

    def __init__(self, dim: int = 1024, heads: int = 16, blocks: int = 6):
        super().__init__()
        self.init = nn.Conv1d(80, dim, 1)
        self.attn = nn.ModuleList(_TortoiseAttnBlock(dim, heads) for _ in range(blocks))

    def forward(self, mel):
        x = self.init(mel.transpose(1, 2))
        for blk in self.attn:
            x = blk(x)
        return x.transpose(1, 2)


class _GEGLU(nn.Module):
    def forward(self, h):
        val, gate = h.chunk(2, dim=-1)
        return val * F.gelu(gate)


class _PerceiverAttn(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)


class XttsPerceiverResampler(nn.Module):
    """XTTS-v2's conditioning perceiver: ``num_latents`` learned latents
    attend to [latents | context] (no biases in the attention), a GEGLU
    feed-forward (inner dim * 4 * 2 / 3, exact GELU), a final gamma
    RMSNorm.  (b, t, dim) -> (b, num_latents, dim)."""

    def __init__(self, dim: int = 1024, depth: int = 2, num_latents: int = 32, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head, self.dim = heads, dim_head, dim
        inner, ff_inner = heads * dim_head, int(dim * 4 * 2 / 3)
        self.latents = nn.Parameter(torch.zeros(num_latents, dim))
        self.layers = nn.ModuleList(nn.ModuleList([
            _PerceiverAttn(dim, inner),
            nn.Sequential(nn.Linear(dim, 2 * ff_inner), _GEGLU(), nn.Linear(ff_inner, dim)),
        ]) for _ in range(depth))
        self.norm = nn.Module()
        self.norm.gamma = nn.Parameter(torch.ones(dim))

    def _heads(self, a):
        b, t, _ = a.shape
        return a.reshape(b, t, self.heads, -1).transpose(1, 2)

    def forward(self, x):
        b = x.shape[0]
        lat = self.latents.expand(b, -1, -1)
        for att, ff in self.layers:
            ctx = torch.cat([lat, x], dim=1)
            k, v = att.to_kv(ctx).chunk(2, dim=-1)
            q, k, v = self._heads(att.to_q(lat)), self._heads(k), self._heads(v)
            w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(self.dim_head), dim=-1)
            o = (w @ v).transpose(1, 2).reshape(b, lat.shape[1], -1)
            lat = lat + att.to_out(o)
            lat = lat + ff(lat)
        n = torch.clamp(torch.linalg.norm(lat, dim=-1, keepdim=True), min=1e-12)
        return lat / n * math.sqrt(self.dim) * self.norm.gamma


# ------------------------------------------------------ generation

@torch.inference_mode()
def xtts_gpt2_generate(model: XttsGPT2, text_ids, cond, max_steps: int, temperature: float = 0.85,
                       top_k: int = 50, start_audio: int | None = None,
                       stop_audio: int | None = None, seed: int = 0, draws=None,
                       stats: dict | None = None, device: str | torch.device = "cuda"):
    """AR mel-code generation for XttsGPT2 and the final-norm latents the
    HiFi decoder takes (the JAX package's ``xtts_gpt2_generate``).

    Text ids are wrapped in the checkpoint's [START]/[STOP] text tokens
    (clamped for small vocabularies).  The mel stream starts at
    ``start_audio``; step i samples mel token i + 1 from the logits at mel
    position i (top-k, temperature; a row is held at ``stop_audio`` after its
    first stop).  The logits come from a static KV cache: a prefill over
    [cond | text | start], then one step per token, captured once and
    replayed on the card.  ``draws``: (max_steps, b, n_audio) Gumbel draws,
    a callable, or None (from ``seed``).  Returns (codes (b, max_steps),
    latents (b, max_steps, dim) from one teacher-forced forward, zero past
    each row's first stop, lengths (b,): the first stop's step, or
    max_steps)."""
    dev, graph = model_device(model, device, None, "xtts_gpt2_generate")
    start_audio = model.n_audio - 2 if start_audio is None else start_audio
    stop_audio = model.n_audio - 1 if stop_audio is None else stop_audio
    text_ids = torch.as_tensor(text_ids, dtype=torch.long, device=dev)
    cond = torch.as_tensor(cond, dtype=torch.float32, device=dev)
    b = text_ids.shape[0]
    mark = StageTimer(stats, dev)
    draws = resolve_draws(draws, (max_steps, b, model.n_audio), seed, dev)
    wrap = lambda tok: torch.full((b, 1), min(int(tok), model.n_text - 1),  # noqa: E731
                                  dtype=torch.long, device=dev)
    text_ids = torch.cat([wrap(model.start_text), text_ids, wrap(model.stop_text)], dim=1)
    mel = torch.full((b, max_steps + 1), stop_audio, dtype=torch.long, device=dev)
    mel[:, 0] = start_audio
    offset = cond.shape[1] + text_ids.shape[1]
    caches = model.init_cache(b, offset + max_steps + 1, dev)
    logits = model.prefill(text_ids, mel[:, :1], cond, caches)
    mark("prefill_s")
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    i = torch.zeros(1, dtype=torch.long, device=dev)

    def step():
        lg = top_k_mask(logits / max(temperature, 1e-6), top_k)
        tok = (lg + draws.index_select(0, i)[0]).argmax(dim=-1)
        tok = torch.where(done, stop_audio, tok)
        done.logical_or_(tok == stop_audio)
        i.add_(1)
        mel.index_copy_(1, i, tok[:, None])
        logits.copy_(model.step(tok, i + offset, i, caches))

    replay(step, max_steps, dev, graph)
    mark("decode_s")
    _, _, latents = model(text_ids, mel, cond, return_latents=True)
    codes, latents = mel[:, 1:], latents[:, 1:]
    is_eos = codes == stop_audio
    lengths = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1),
                          torch.full((b,), max_steps, device=dev))
    keep = torch.arange(max_steps, device=dev)[None, :] < lengths[:, None]
    latents = torch.where(keep[..., None], latents, 0.0)
    mark("latents_s")
    mark.put("steps", max_steps)
    return codes, latents, lengths


# --------------------------------------------------- checkpoint DVAE

class _DVAEResBlock(nn.Module):
    """dvae.py ResBlock: conv3-relu-conv3-relu-conv1 + residual (``net``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.net = nn.Sequential(nn.Conv1d(ch, ch, 3, padding=1), nn.ReLU(),
                                 nn.Conv1d(ch, ch, 3, padding=1), nn.ReLU(),
                                 nn.Conv1d(ch, ch, 1))

    def forward(self, x):
        return x + self.net(x)


class _UpsampledConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class XttsDVAE(nn.Module):
    """XTTS's discrete mel VAE (dvae.py at the trainer's settings: 1-d, 80
    mels, 2 stride-2 convolutions, 3 resblocks, a 1024-token codebook,
    nearest-upsample decoder) under the Sequential index names of dvae.pth;
    ``codebook.embed`` (codebook_dim, num_tokens) is a buffer, as upstream's
    EMA codebook is."""

    def __init__(self, channels: int = 80, num_tokens: int = 1024, codebook_dim: int = 512,
                 hidden_dim: int = 512, num_layers: int = 2, num_resnet_blocks: int = 3):
        super().__init__()
        inner = hidden_dim * 2 ** (num_layers - 1)
        enc, cin = [], channels
        for i in range(num_layers):
            enc.append(nn.Sequential(nn.Conv1d(cin, hidden_dim * 2 ** i, 3, stride=2,
                                               padding=1), nn.ReLU()))
            cin = hidden_dim * 2 ** i
        enc += [_DVAEResBlock(inner) for _ in range(num_resnet_blocks)]
        enc.append(nn.Conv1d(inner, codebook_dim, 1))
        self.encoder = nn.Sequential(*enc)
        self.codebook = nn.Module()
        self.codebook.register_buffer("embed", torch.zeros(codebook_dim, num_tokens))
        dec = [nn.Conv1d(codebook_dim, inner, 1)]
        dec += [_DVAEResBlock(inner) for _ in range(num_resnet_blocks)]
        cin = inner
        for i in range(num_layers):
            cout = hidden_dim * 2 ** (num_layers - 1 - i)
            dec.append(nn.Sequential(_UpsampledConv(cin, cout), nn.ReLU()))
            cin = cout
        dec.append(nn.Conv1d(cin, channels, 1))
        self.decoder = nn.Sequential(*dec)

    def encode(self, mel):
        """(b, t, 80) -> codes (b, t // 2**num_layers)."""
        z = self.encoder(mel.transpose(1, 2)).transpose(1, 2)
        e = self.codebook.embed
        dist = (z * z).sum(-1, keepdim=True) - 2.0 * z @ e + (e * e).sum(0)[None, None]
        return dist.argmin(dim=-1)

    def decode(self, codes):
        """codes (b, n) -> mel (b, n * 2**num_layers, 80)."""
        z = self.codebook.embed.t()[codes]
        return self.decoder(z.transpose(1, 2)).transpose(1, 2)

    def forward(self, mel):
        return self.decode(self.encode(mel))
