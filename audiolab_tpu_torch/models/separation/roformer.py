"""Band-Split RoFormer source separation (counterpart of
audiolab_tpu/models/separation/roformer.py).

  stereo STFT -> per-band RMSNorm + Linear ("band split") -> axial
  transformer (attention over time, then over bands, rotary embeddings)
  -> per-band tanh-MLP + GLU mask estimators -> complex mask * STFT -> iSTFT

Parameter names are those of the published lucidrains/BS-RoFormer
checkpoints (``band_split.to_features.{i}.{0,1}``, ``layers.{d}.{0,1}...``,
``mask_estimators.{s}.to_freqs.{i}.0.{2k}``).  The rope is the checkpoints'
interleaved-pair one; attention goes through kernels/attention.py (K1 on
the card for both axes).  Activations and matrix products run in
``cfg.dtype`` (bf16 by default) with fp32 parameters; RMSNorm accumulates in
fp32; the STFT, the complex mask product and the iSTFT stay fp32.  The
per-band layers run as one batched product over zero-padded band slots,
as the JAX model does.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.kernels.attention import flash_attention
from audiolab_tpu_torch.kernels.mel import mel_filterbank
from audiolab_tpu_torch.kernels.stft import istft, stft

DEFAULT_BANDS: tuple[int, ...] = (
    (2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8 + (128,) + (129,)
)


@dataclass(frozen=True)
class RoformerConfig:
    dim: int = 192
    depth: int = 6                  # axial (time, freq) pairs
    heads: int = 8
    dim_head: int = 64
    stems: Sequence[str] = ("vocals", "other")  # one mask estimator each
    residual_stem: str | None = None  # stem synthesized as mix - sum(stems)
    freqs_per_bands: Sequence[int] = DEFAULT_BANDS
    n_fft: int = 2048
    hop: int = 512
    channels: int = 2
    ff_mult: int = 4
    time_depth: int = 1
    freq_depth: int = 1
    mask_est_depth: int = 2
    band_bins: tuple | None = None  # explicit (possibly overlapping) bands
    dtype: str = "bfloat16"         # activation / matmul type

    @property
    def n_bands(self) -> int:
        return (len(self.band_bins) if self.band_bins is not None
                else len(self.freqs_per_bands))


def band_bin_table(cfg: RoformerConfig) -> list[tuple[int, ...]]:
    """Per-band STFT-bin index tuples: explicit or contiguous runs."""
    if cfg.band_bins is not None:
        return [tuple(b) for b in cfg.band_bins]
    out, start = [], 0
    for w in cfg.freqs_per_bands:
        out.append(tuple(range(start, start + w)))
        start += w
    return out


def mel_band_bins(n_bands: int, n_fft: int, sr: int) -> tuple[tuple[int, ...], ...]:
    """Mel-band layout of lucidrains/Mel-Band-RoFormer: the nonzero bins of
    an htk mel filterbank (norm=None), DC forced into the first band and
    Nyquist into the last, uncovered bins handed to the nearest band."""
    fb = np.asarray(mel_filterbank(sr, n_fft, n_mels=n_bands, fmin=0.0,
                                   fmax=sr / 2, htk=True, norm=None)).T.copy()
    fb[0, 0] = 1.0
    fb[-1, -1] = 1.0
    uncovered = np.flatnonzero(~(fb > 0).any(axis=0))
    for bb in uncovered:
        centers = np.array([np.mean(np.flatnonzero(fb[i] > 0))
                            if (fb[i] > 0).any() else 1e9
                            for i in range(n_bands)])
        fb[int(np.argmin(np.abs(centers - bb))), bb] = 1.0
    bands = [tuple(np.flatnonzero(fb[i] > 0).tolist()) for i in range(n_bands)]
    if not all(len(b) for b in bands):
        raise ValueError("a mel band has no bins")
    return tuple(bands)


@lru_cache(maxsize=None)
def _rope_tables(t: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """(t, d/2) cos/sin of position * 10000^(-i/(d/2)); angles in float64."""
    half = d // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, half, dtype=np.float32) / half))
    ang = np.arange(t)[:, None] * freqs[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rope(x: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotary embedding over axis -2 (rotary_embedding_torch's
    convention, which the checkpoints were trained with); fp32 rotation,
    result in the input type."""
    t, d = x.shape[-2], x.shape[-1]
    cos, sin = (torch.from_numpy(a).to(x.device) for a in _rope_tables(t, d))
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    """lucidrains RMSNorm: x / max(||x||, 1e-12) * sqrt(d) * gamma, the norm
    accumulated in fp32; at bf16 the factor is applied as a bf16 scalar."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        d = x.shape[-1]
        xf = x.float()
        r = (d ** 0.5) / torch.clamp(torch.sqrt((xf * xf).sum(-1, keepdim=True)), min=1e-12)
        if x.dtype == torch.bfloat16:
            return x * r.to(x.dtype) * self.gamma.to(x.dtype)
        return (xf * r * self.gamma).to(x.dtype)


def _dense(x, layer: nn.Linear, dt: torch.dtype):
    """Linear in the activation type ``dt`` (flax Dense(dtype=dt))."""
    x = x.to(dt)
    if dt == torch.float32:
        return precision.linear(x, layer.weight, layer.bias)
    return F.linear(x, layer.weight.to(dt), None if layer.bias is None else layer.bias.to(dt))


class Attention(nn.Module):
    """Gated multi-head attention (bs_roformer.Attention): RMSNorm, fused
    bias-free qkv, rope on q and k, per-head sigmoid gates."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_gates = nn.Linear(dim, heads)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=False))

    def forward(self, x):
        b, t, _ = x.shape
        h, d, dt = self.heads, self.dim_head, self.dtype
        x = self.norm(x)
        q, k, v = _dense(x, self.to_qkv, dt).chunk(3, dim=-1)
        q, k, v = (z.reshape(b, t, h, d).transpose(1, 2) for z in (q, k, v))
        q, k = rope(q), rope(k)
        # one key block per call, as the JAX model chose its Pallas blocks:
        # the whole row for short sequences, 768 keys otherwise
        o = flash_attention(q, k, v, block_k=t if t < 256 else 768)
        gates = torch.sigmoid(_dense(x, self.to_gates, dt))       # (b, t, h)
        o = o * gates.transpose(1, 2)[..., None]
        o = o.transpose(1, 2).reshape(b, t, h * d)
        return _dense(o, self.to_out[0], dt)


class FeedForward(nn.Module):
    """RMSNorm -> Linear -> GELU (tanh form, as flax's default) -> Linear."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.net = nn.Sequential(RMSNorm(dim), nn.Linear(dim, dim * mult),
                                 nn.GELU(approximate="tanh"), nn.Identity(),
                                 nn.Linear(dim * mult, dim), nn.Identity())

    def forward(self, x):
        x = self.net[0](x)
        x = F.gelu(_dense(x, self.net[1], self.dtype), approximate="tanh")
        return _dense(x, self.net[4], self.dtype)


class Transformer(nn.Module):
    """``depth`` (attention, feed-forward) residual pairs + output RMSNorm."""

    def __init__(self, dim, heads, dim_head, ff_mult, depth=1, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([Attention(dim, heads, dim_head, dtype),
                           FeedForward(dim, ff_mult, dtype)])
            for _ in range(depth)])
        self.norm = RMSNorm(dim)

    def forward(self, x):
        for attn, ff in self.layers:
            x = x + attn(x)
            x = x + ff(x)
        return self.norm(x)


class AxialPair(nn.ModuleList):
    """One (time transformer, band transformer) depth step over (b, t, bands, dim)."""

    def __init__(self, cfg: RoformerConfig, dtype):
        c = cfg
        super().__init__([
            Transformer(c.dim, c.heads, c.dim_head, c.ff_mult, c.time_depth, dtype),
            Transformer(c.dim, c.heads, c.dim_head, c.ff_mult, c.freq_depth, dtype)])

    def forward(self, x):
        b, t, nb, dim = x.shape
        xt = x.permute(0, 2, 1, 3).reshape(b * nb, t, dim)
        xt = self[0](xt)
        x = xt.reshape(b, nb, t, dim).permute(0, 2, 1, 3)
        xf = self[1](x.reshape(b * t, nb, dim))
        return xf.reshape(b, t, nb, dim)


class _BandLayout:
    """Zero-padded band slots: gather index, validity mask and scatter map."""

    def __init__(self, bands, ch2: int):
        self.widths = [len(b) * ch2 for b in bands]
        self.maxw = max(self.widths)
        nb, maxbins = len(bands), self.maxw // ch2
        self.n_bins = 1 + max(max(b) for b in bands)
        idx = np.zeros((nb, maxbins), np.int64)
        valid = np.zeros((nb, self.maxw), np.float32)
        slot_bin = np.full((nb * maxbins,), self.n_bins, np.int64)
        counts = np.zeros((self.n_bins,), np.float32)
        for i, bins in enumerate(bands):
            idx[i, : len(bins)] = bins
            valid[i, : len(bins) * ch2] = 1.0
            for j, bb in enumerate(bins):
                slot_bin[i * maxbins + j] = bb
                counts[bb] += 1.0
        self.idx = torch.from_numpy(idx)
        self.valid = torch.from_numpy(valid)
        self.slot_bin = torch.from_numpy(slot_bin)
        self.counts = torch.from_numpy(np.maximum(counts, 1.0))


class BandSplit(nn.Module):
    """Per-band RMSNorm + Linear, run as one batched product over padded
    band slots (zero padding adds nothing to the norms or the products)."""

    def __init__(self, cfg: RoformerConfig, dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.layout = _BandLayout(band_bin_table(cfg), 2 * cfg.channels)
        self.to_features = nn.ModuleList([
            nn.Sequential(RMSNorm(w), nn.Linear(w, cfg.dim)) for w in self.layout.widths])

    def forward(self, spec):
        # spec (b, t, n_bins, 2*channels) fp32
        lay, dev, dt = self.layout, spec.device, self.dtype
        maxw = lay.maxw
        gathered = spec[:, :, lay.idx.to(dev), :]                 # (b,t,nb,maxb,ch2)
        x = gathered.reshape(*gathered.shape[:3], maxw) * lay.valid.to(dev)
        scale = torch.stack([F.pad(f[0].gamma, (0, maxw - w))
                             for f, w in zip(self.to_features, lay.widths)])
        kern = torch.stack([F.pad(f[1].weight.t(), (0, 0, 0, maxw - w))
                            for f, w in zip(self.to_features, lay.widths)])
        bias = torch.stack([f[1].bias for f in self.to_features])
        xf = x.float()
        norm = torch.clamp(torch.sqrt((xf * xf).sum(-1, keepdim=True)), min=1e-12)
        sqrt_d = torch.tensor([w ** 0.5 for w in lay.widths], dtype=torch.float32, device=dev)
        xn = xf / norm * sqrt_d[None, None, :, None] * scale
        return precision.einsum("btkw,kwd->btkd", xn.to(dt), kern.to(dt)) + bias.to(dt)


class MaskEstimator(nn.Module):
    """Per-band tanh-MLP -> GLU, batched over padded band slots; the GLU's
    value and gate halves are padded separately so the split stays exact.
    Overlapping (mel) bands sum per bin and divide by the band count."""

    def __init__(self, cfg: RoformerConfig, dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.layout = _BandLayout(band_bin_table(cfg), 2 * cfg.channels)
        hidden = cfg.dim * 4

        def mlp(dout):
            dims = (cfg.dim,) + (hidden,) * cfg.mask_est_depth + (dout,)
            mods = []
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                mods.append(nn.Linear(a, b))
                if i < len(dims) - 2:
                    mods.append(nn.Tanh())
            return nn.Sequential(*mods)

        self.to_freqs = nn.ModuleList([
            nn.Sequential(mlp(2 * w), nn.GLU(dim=-1)) for w in self.layout.widths])

    def forward(self, x):
        # x (b, t, bands, dim) -> complex mask (b, t, n_bins, 2*channels)
        lay, dt, dev = self.layout, self.dtype, x.device
        ch2 = 2 * self.cfg.channels
        maxo = lay.maxw
        mlps = [f[0] for f in self.to_freqs]
        h = x.to(dt)
        for k in range(self.cfg.mask_est_depth):
            kk = torch.stack([m[2 * k].weight.t() for m in mlps])
            bb = torch.stack([m[2 * k].bias for m in mlps])
            h = torch.tanh(precision.einsum("btkd,kdh->btkh", h, kk.to(dt)) + bb.to(dt))
        last = 2 * self.cfg.mask_est_depth
        ok, ob = [], []
        for m, wo in zip(mlps, lay.widths):
            kern, bias = m[last].weight.t(), m[last].bias
            pad = maxo - wo
            ok.append(torch.cat([F.pad(kern[:, :wo], (0, pad)), F.pad(kern[:, wo:], (0, pad))], -1))
            ob.append(torch.cat([F.pad(bias[:wo], (0, pad)), F.pad(bias[wo:], (0, pad))]))
        out = precision.einsum("btkh,kho->btko", h, torch.stack(ok).to(dt)) \
            + torch.stack(ob).to(dt)
        mask = out[..., :maxo] * torch.sigmoid(out[..., maxo:])   # (b, t, nb, maxo)
        m = mask.reshape(*mask.shape[:2], -1, ch2)
        summed = m.new_zeros(*m.shape[:2], lay.n_bins + 1, ch2)
        summed.index_add_(2, lay.slot_bin.to(dev), m)
        return summed[:, :, : lay.n_bins] / lay.counts.to(dev)[None, None, :, None].to(m.dtype)


def _complex_mul(spec: torch.Tensor, mask: torch.Tensor, ch: int) -> torch.Tensor:
    """spec * mask where the last axis packs (ch*2) re/im pairs."""
    b, t, f, _ = spec.shape
    s = spec.reshape(b, t, f, ch, 2)
    m = mask.reshape(b, t, f, ch, 2)
    re = s[..., 0] * m[..., 0] - s[..., 1] * m[..., 1]
    im = s[..., 0] * m[..., 1] + s[..., 1] * m[..., 0]
    return torch.stack([re, im], dim=-1).reshape(b, t, f, ch * 2)


class BSRoformer(nn.Module):
    def __init__(self, cfg: RoformerConfig = RoformerConfig()):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        self.band_split = BandSplit(cfg, dt)
        self.layers = nn.ModuleList([AxialPair(cfg, dt) for _ in range(cfg.depth)])
        self.final_norm = RMSNorm(cfg.dim)
        self.mask_estimators = nn.ModuleList([MaskEstimator(cfg, dt) for _ in cfg.stems])

    def forward(self, audio: torch.Tensor) -> dict[str, torch.Tensor]:
        """audio (b, channels, n) -> dict stem -> (b, channels, n)."""
        c = self.cfg
        b, ch, n = audio.shape
        real, imag = stft(audio, n_fft=c.n_fft, hop=c.hop)       # (b, ch, t, bins)
        t_frames, n_bins = real.shape[-2], real.shape[-1]
        spec = torch.stack([real, imag], dim=-1)                  # (b, ch, t, bins, 2)
        # per bin: (ch0 re, ch0 im, ch1 re, ch1 im), bs_roformer's packing
        spec = spec.permute(0, 2, 3, 1, 4).reshape(b, t_frames, n_bins, ch * 2)
        x = self.band_split(spec)
        for pair in self.layers:
            x = pair(x)
        x = self.final_norm(x)
        out, acc = {}, None
        for stem, est in zip(c.stems, self.mask_estimators):
            masked = _complex_mul(spec, est(x).float(), ch)
            masked = masked.reshape(b, t_frames, n_bins, ch, 2).permute(0, 3, 1, 2, 4)
            wav = istft(masked[..., 0], masked[..., 1], n_fft=c.n_fft, hop=c.hop, length=n)
            out[stem] = wav
            acc = wav if acc is None else acc + wav
        if c.residual_stem is not None:
            out[c.residual_stem] = audio - acc
        return out
