"""CLAP's two branches in the laion_clap checkpoint's layout (counterpart
of audiolab_tpu/models/clap.py).

- Text (clap_module/model.py's "roberta" path): a RobertaModel (positions
  start at pad_id + 1 for tokens that are not padding) whose pooler output
  goes through ``text_projection`` (Linear, ReLU, Linear) into the 512-d
  joint space.
- Audio (HTSAT, htsat.py:774-860): a patch embedding, four Swin stages
  with shifted-window masks and patch merging, a final LayerNorm, the mean
  over tokens and ``audio_projection``.  The TSCAM head is left out, as
  CLAP's ``get_audio_embedding`` does not use it.  Swin's
  ``relative_position_index`` and ``attn_mask`` are buffers computed here
  and kept out of the ``state_dict``.
- :func:`clap_mel_image`: torchlibrosa's log-mel (power STFT, 10 log10 with
  amin 1e-10, a slaney filterbank) and HTSAT's ``reshape_wav2img``.

No pipeline of the port uses CLAP yet.  flax defaults mirrored: LayerNorm
eps 1e-5, the exact GELU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.mel import mel_filterbank
from audiolab_tpu_torch.kernels.stft import spectrogram


@dataclass(frozen=True)
class ClapTextConfig:
    vocab_size: int = 50265
    dim: int = 768
    layers: int = 12
    heads: int = 12
    ffn_dim: int = 3072
    max_positions: int = 514
    type_vocab: int = 1
    pad_id: int = 1
    joint_dim: int = 512


class _Named(nn.Module):
    """An empty module that holds children under upstream's names."""

    def __init__(this, **children):  # "self" is one of the children's names
        nn.Module.__init__(this)
        for k, v in children.items():
            this.add_module(k, v)


class _RobertaLayer(nn.Module):
    def __init__(self, c: ClapTextConfig):
        super().__init__()
        d = c.dim
        self.heads = c.heads
        self.attention = _Named(
            self=_Named(query=nn.Linear(d, d), key=nn.Linear(d, d), value=nn.Linear(d, d)),
            output=_Named(dense=nn.Linear(d, d), LayerNorm=nn.LayerNorm(d, eps=1e-5)))
        self.intermediate = _Named(dense=nn.Linear(d, c.ffn_dim))
        self.output = _Named(dense=nn.Linear(c.ffn_dim, d), LayerNorm=nn.LayerNorm(d, eps=1e-5))

    def forward(self, x, mask):
        b, t, d = x.shape
        sa, ao = self.attention.self, self.attention.output
        q, k, v = (m(x).reshape(b, t, self.heads, -1).transpose(1, 2)
                   for m in (sa.query, sa.key, sa.value))
        w = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) / np.sqrt(d // self.heads)
        w = torch.where(mask[:, None, None, :] > 0, w, torch.finfo(torch.float32).min)
        o = torch.einsum("bhij,bhjd->bhid", torch.softmax(w, dim=-1), v.float()).to(x.dtype)
        x = ao.LayerNorm(x + ao.dense(o.transpose(1, 2).reshape(b, t, d)))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class ClapTextBranch(nn.Module):
    """input_ids (b, t) and attention_mask (b, t) -> the 512-d joint embedding."""

    def __init__(self, cfg: ClapTextConfig = ClapTextConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        emb = _Named(word_embeddings=nn.Embedding(c.vocab_size, c.dim),
                     position_embeddings=nn.Embedding(c.max_positions, c.dim),
                     token_type_embeddings=nn.Embedding(c.type_vocab, c.dim),
                     LayerNorm=nn.LayerNorm(c.dim, eps=1e-5))
        self.text_branch = _Named(
            embeddings=emb,
            encoder=_Named(layer=nn.ModuleList(_RobertaLayer(c) for _ in range(c.layers))),
            pooler=_Named(dense=nn.Linear(c.dim, c.dim)))
        self.text_projection = nn.Sequential(nn.Linear(c.dim, c.joint_dim), nn.ReLU(),
                                             nn.Linear(c.joint_dim, c.joint_dim))

    def forward(self, input_ids, attention_mask):
        c, tb = self.cfg, self.text_branch
        ids = input_ids.long()
        keep = (ids != c.pad_id).long()
        pos = torch.cumsum(keep, dim=1) * keep + c.pad_id
        e = tb.embeddings
        x = (e.word_embeddings(ids) + e.position_embeddings(pos)
             + e.token_type_embeddings(torch.zeros_like(ids)))
        x = e.LayerNorm(x)
        for layer in tb.encoder.layer:
            x = layer(x, attention_mask)
        pooled = torch.tanh(tb.pooler.dense(x[:, 0]))
        return self.text_projection(pooled)


# --------------------------------------------------- HTSAT audio branch

def _rel_position_index(w: int) -> np.ndarray:
    """Swin's relative-position index table, (w*w, w*w)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w_res: int, window: int, shift: int) -> np.ndarray:
    """The shifted-window attention mask, (nW, n, n) of 0 and -100."""
    img = np.zeros((h, w_res))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w_res // window, window).transpose(
        0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0)


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             torch.tensor(_rel_position_index(window).reshape(-1)),
                             persistent=False)


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)


class _SwinBlock(nn.Module):
    """htsat.py's SwinTransformerBlock (norm_before_mlp "ln")."""

    def __init__(self, dim: int, resolution: tuple, heads: int, window: int, shift: int):
        super().__init__()
        if min(resolution) <= window:
            window, shift = min(resolution), 0
        self.resolution, self.heads, self.window, self.shift = resolution, heads, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = _WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim)
        mask = (torch.tensor(_shift_attn_mask(*resolution, window, shift), dtype=torch.float32)
                if shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x):  # (b, H*W, C)
        (h_res, w_res), window, shift = self.resolution, self.window, self.shift
        b, n, c = x.shape
        dk = c // self.heads
        nwh, nww = h_res // window, w_res // window
        y = self.norm1(x).reshape(b, h_res, w_res, c)
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        yw = y.reshape(b, nwh, window, nww, window, c).permute(0, 1, 3, 2, 4, 5).reshape(
            b * nwh * nww, window * window, c)
        q, k, v = (a.reshape(yw.shape[0], -1, self.heads, dk).transpose(1, 2)
                   for a in self.attn.qkv(yw).chunk(3, dim=-1))
        att = torch.einsum("whid,whjd->whij", q.float() * dk ** -0.5, k.float())
        ww = window * window
        bias = self.attn.relative_position_bias_table[self.attn.relative_position_index]
        att = att + bias.reshape(ww, ww, self.heads).permute(2, 0, 1)[None]
        if shift > 0:
            amask = self.attn_mask.to(att.dtype)
            att = att.reshape(b, nwh * nww, self.heads, ww, ww) + amask[None, :, None]
            att = att.reshape(-1, self.heads, ww, ww)
        o = torch.einsum("whij,whjd->whid", torch.softmax(att, dim=-1), v.float()).to(x.dtype)
        o = self.attn.proj(o.transpose(1, 2).reshape(yw.shape[0], -1, c))
        o = o.reshape(b, nwh, nww, window, window, c).permute(0, 1, 3, 2, 4, 5).reshape(
            b, h_res, w_res, c)
        if shift > 0:
            o = torch.roll(o, (shift, shift), dims=(1, 2))
        x = x + o.reshape(b, n, c)
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


@dataclass(frozen=True)
class ClapAudioConfig:
    spec_size: int = 256
    patch_size: int = 4
    patch_stride: int = 4
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    heads: tuple = (4, 8, 16, 32)
    window: int = 8
    joint_dim: int = 512


class _PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class ClapAudioBranch(nn.Module):
    """HTSAT's embedding path: the mel image (b, 1, spec, spec) -> the
    512-d joint embedding."""

    def __init__(self, cfg: ClapAudioConfig = ClapAudioConfig()):
        super().__init__()
        c = cfg
        self.cfg = c
        grid = (c.spec_size - c.patch_size) // c.patch_stride + 1
        res, dim = (grid, grid), c.embed_dim
        layers = []
        for li, (depth, heads) in enumerate(zip(c.depths, c.heads)):
            blocks = nn.ModuleList(_SwinBlock(dim, res, heads, c.window,
                                              0 if bi % 2 == 0 else c.window // 2)
                                   for bi in range(depth))
            stage = _Named(blocks=blocks)
            if li < len(c.depths) - 1:
                stage.add_module("downsample", _PatchMerging(dim))
                res, dim = (res[0] // 2, res[1] // 2), 2 * dim
            layers.append(stage)
        self.audio_branch = _Named(
            patch_embed=_Named(proj=nn.Conv2d(1, c.embed_dim, c.patch_size, c.patch_stride),
                               norm=nn.LayerNorm(c.embed_dim, eps=1e-5)),
            layers=nn.ModuleList(layers), norm=nn.LayerNorm(dim, eps=1e-5))
        self.audio_projection = nn.Sequential(nn.Linear(dim, c.joint_dim), nn.ReLU(),
                                              nn.Linear(c.joint_dim, c.joint_dim))

    def forward(self, mel_img):
        ab = self.audio_branch
        x = ab.patch_embed.proj(mel_img.float())        # (b, C, gh, gw)
        b, dim, gh, gw = x.shape
        x = ab.patch_embed.norm(x.flatten(2).transpose(1, 2))
        res = (gh, gw)
        for stage in ab.layers:
            for blk in stage.blocks:
                x = blk(x)
            if hasattr(stage, "downsample"):
                h_res, w_res = res
                x = x.reshape(b, h_res, w_res, dim)
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                               x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
                x = x.reshape(b, (h_res // 2) * (w_res // 2), 4 * dim)
                x = stage.downsample.reduction(stage.downsample.norm(x))
                res, dim = (h_res // 2, w_res // 2), 2 * dim
        emb = ab.norm(x).mean(dim=1)
        return self.audio_projection(emb)


def clap_mel_image(wav: torch.Tensor, sr: int = 48000, n_fft: int = 1024, hop: int = 480,
                   n_mels: int = 64, fmin: float = 50.0, fmax: float = 14000.0,
                   spec_size: int = 256) -> torch.Tensor:
    """(b, t) -> the (b, 1, spec, spec) image: the log-mel's frequency axis
    stacked ``spec // n_mels`` times along the height.  The clip must
    cover spec * ratio frames (cut or zero-padded here; upstream's bicubic
    stretch of short clips is not reproduced)."""
    spec = spectrogram(wav, n_fft=n_fft, hop=hop, center=True, power=2.0)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=False,
                                         norm="slaney")).to(spec.device)
    logmel = 10.0 * torch.log10(torch.clamp(spec @ fb, min=1e-10))
    ratio = spec_size // n_mels
    target_t = spec_size * ratio
    t = logmel.shape[1]
    logmel = F.pad(logmel, (0, 0, 0, target_t - t)) if t < target_t else logmel[:, :target_t]
    b = logmel.shape[0]
    x = logmel.transpose(1, 2).reshape(b, n_mels, ratio, target_t // ratio)
    x = x.transpose(1, 2).reshape(b, ratio * n_mels, target_t // ratio)
    return x[:, None]
