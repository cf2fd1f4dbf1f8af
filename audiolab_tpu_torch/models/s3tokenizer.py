"""S3 speech tokenizer v2 (25 Hz): reference audio -> FSQ speech-token ids
(counterpart of audiolab_tpu/models/s3tokenizer.py), the tokenizer that
Chatterbox's ``s3gen.safetensors`` bundles under ``tokenizer.``.

  encoder   whisper-style 128-mel front end, two GELU convs (k3, strides 2
            and 2 -> 25 Hz), sinusoidal positions, N FSMN attention blocks
            (whisper query/key/value/out, key bias-free, q and k each
            scaled by d^-0.25, plus a depthwise k31 FSMN memory over the
            value projection, added after the out projection), ln_post
  quantizer FSQ: Linear(n_state -> 8), tanh, x (1 - 1e-3), round to
            {-1, 0, 1}, + 1, base-3 digits -> id in [0, 6561)

The mel is whisper's log_mel_spectrogram at 128 mels without the 30 s
padding.  Attention is plain PyTorch ops, as in the JAX package.
Parameter names are the s3tokenizer package's (``encoder.blocks.N.attn.
{query,key,value,out,fsmn_block}``, ``attn_ln``, ``mlp.0``, ``mlp.2``,
``mlp_ln``, ``encoder.ln_post``, ``quantizer.vq.project_down``), the names
``convert_s3tokenizer`` maps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.mel import mel_spectrogram

# float32(0.999): the FSQ's pre-rounding scale
_FSQ_SCALE = 0.9990000128746033


@dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 12
    n_ctx: int = 1500
    fsmn_kernel: int = 31
    fsq_dim: int = 8
    fsq_level: int = 3
    conv1_stride: int = 2  # v2 25 Hz; v1 50 Hz uses 1


def sinusoids(length: int, dim: int) -> np.ndarray:
    """Whisper's sinusoidal position table (length, dim) in float32 (a copy of
    audiolab_tpu/models/whisper.py::sinusoids)."""
    inv = np.exp(-np.log(10000.0) * np.arange(dim // 2) / (dim // 2 - 1))
    pos = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=1).astype(np.float32)


class FSMNAttention(nn.Module):
    """Whisper multi-head attention plus the FSMN memory over the values."""

    def __init__(self, cfg: S3TokenizerConfig):
        super().__init__()
        self.cfg = c = cfg
        self.query = nn.Linear(c.n_state, c.n_state)
        self.key = nn.Linear(c.n_state, c.n_state, bias=False)
        self.value = nn.Linear(c.n_state, c.n_state)
        self.out = nn.Linear(c.n_state, c.n_state)
        self.fsmn_block = nn.Conv1d(c.n_state, c.n_state, c.fsmn_kernel, groups=c.n_state,
                                    bias=False)

    def forward(self, x):
        c = self.cfg
        d = c.n_state // c.n_head
        b, t, _ = x.shape
        q, k, v = self.query(x), self.key(x), self.value(x)
        left = (c.fsmn_kernel - 1) // 2
        vp = F.pad(v.transpose(1, 2), (left, c.fsmn_kernel - 1 - left))
        fsm = self.fsmn_block(vp).transpose(1, 2) + v
        scale = d ** -0.25
        qh = (q.reshape(b, t, c.n_head, d) * scale).transpose(1, 2)
        kh = (k.reshape(b, t, c.n_head, d) * scale).permute(0, 2, 3, 1)
        vh = v.reshape(b, t, c.n_head, d).transpose(1, 2)
        w = torch.softmax(qh @ kh, dim=-1)
        o = (w @ vh).transpose(1, 2).reshape(b, t, c.n_state)
        return self.out(o) + fsm


class S3Block(nn.Module):
    def __init__(self, cfg: S3TokenizerConfig):
        super().__init__()
        self.attn_ln = nn.LayerNorm(cfg.n_state, eps=1e-5)
        self.attn = FSMNAttention(cfg)
        self.mlp_ln = nn.LayerNorm(cfg.n_state, eps=1e-5)
        self.mlp = nn.Sequential(nn.Linear(cfg.n_state, 4 * cfg.n_state), nn.GELU(),
                                 nn.Linear(4 * cfg.n_state, cfg.n_state))

    def forward(self, x):
        x = x + self.attn(self.attn_ln(x))
        return x + self.mlp(self.mlp_ln(x))


class S3AudioEncoder(nn.Module):
    def __init__(self, cfg: S3TokenizerConfig):
        super().__init__()
        self.cfg = c = cfg
        self.conv1 = nn.Conv1d(c.n_mels, c.n_state, 3, stride=c.conv1_stride, padding=1)
        self.conv2 = nn.Conv1d(c.n_state, c.n_state, 3, stride=2, padding=1)
        self.register_buffer("positional_embedding", torch.tensor(sinusoids(c.n_ctx, c.n_state)),
                             persistent=False)
        self.blocks = nn.ModuleList(S3Block(c) for _ in range(c.n_layer))
        self.ln_post = nn.LayerNorm(c.n_state, eps=1e-5)

    def forward(self, mel):
        """(b, t_mel, n_mels) -> (b, t_mel / 4, n_state) for v2."""
        h = F.gelu(self.conv1(mel.transpose(1, 2)))
        h = F.gelu(self.conv2(h)).transpose(1, 2)
        h = h + self.positional_embedding[: h.shape[1]]
        for block in self.blocks:
            h = block(h)
        return self.ln_post(h)


class S3TokenizerV2(nn.Module):
    """(b, t_mel, n_mels) log-mel -> (b, t_tok) int64 FSQ ids."""

    def __init__(self, cfg: S3TokenizerConfig = S3TokenizerConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = S3AudioEncoder(cfg)
        self.quantizer = nn.Module()
        self.quantizer.vq = nn.Module()
        self.quantizer.vq.project_down = nn.Linear(cfg.n_state, cfg.fsq_dim)

    def project(self, mel):
        """The FSQ's pre-rounding values tanh(W h) * 0.999, (b, t_tok, fsq_dim)."""
        h = self.quantizer.vq.project_down(self.encoder(mel))
        return torch.tanh(h) * _FSQ_SCALE

    def forward(self, mel):
        c = self.cfg
        digits = torch.round(self.project(mel)) + 1.0
        powers = torch.tensor(float(c.fsq_level) ** np.arange(c.fsq_dim), dtype=digits.dtype,
                              device=digits.device)
        return (digits * powers).sum(dim=-1).long()


def s3_log_mel(audio16k: torch.Tensor, n_mels: int = 128) -> torch.Tensor:
    """Whisper's log_mel_spectrogram without the 30 s padding: (b, n) 16 kHz
    -> (b, frames, n_mels)."""
    mel = mel_spectrogram(audio16k.float(), sr=16000, n_fft=400, hop=160, n_mels=n_mels,
                          htk=False, norm="slaney", power=2.0, center=True)
    mel = mel[:, :-1]  # whisper drops the trailing stft frame
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    mx = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, mx - 8.0)
    return (log_spec + 4.0) / 4.0


@torch.inference_mode()
def tokenize_wav(model: S3TokenizerV2, wav16k) -> np.ndarray:
    """(n,) 16 kHz reference -> (1, t) int32 25 Hz speech-token ids on the
    host; the model runs on its own device."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(wav16k, np.float32), device=dev)[None]
    return model(s3_log_mel(x, model.cfg.n_mels)).cpu().numpy().astype(np.int32)
