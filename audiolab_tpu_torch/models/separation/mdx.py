"""MDX-style TFC-TDF U-Net and the MDX-NET ONNX ensemble member
(counterpart of audiolab_tpu/models/separation/mdx.py).

- :class:`MDXNet`: the JAX package's own TFC-TDF U-Net (no published
  checkpoint; the state_dict follows the flax module names,
  ``utils/weights.py::mdxnet_from_jax``), NCHW with time
  as H and frequency as W; GroupNorm(4) with flax's eps 1e-6 and flax's
  default GELU, the tanh approximation.
- :class:`MDXOnnxSeparator`: a published MDX-NET ``.onnx`` graph run by
  utils/onnx.py inside the ConvTDFNetTrim framing, with demix_base's
  trim-margin windowing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.kernels.stft import istft, stft
from audiolab_tpu_torch.utils.onnx import OnnxRunner, load_onnx


@dataclass(frozen=True)
class MDXConfig:
    n_fft: int = 6144
    hop: int = 1024
    dim_f: int = 2560          # retained freq bins (< n_fft//2+1)
    channels: int = 2          # stereo
    g: int = 32                # base conv width
    depth: int = 4             # U-Net scales
    tfc_layers: int = 2        # convs per TFC block
    bn: int = 8                # TDF bottleneck factor
    stems: Sequence[str] = ("vocals", "other")


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class TFC_TDF(nn.Module):
    """``tfc_layers`` x (GroupNorm, GELU, 3x3 conv) and a frequency MLP
    residual; the first conv replaces its input when the width changes."""

    def __init__(self, in_ch: int, ch: int, dim_f: int, tfc_layers: int, bn: int):
        super().__init__()
        self.tfc_layers = tfc_layers
        for i in range(tfc_layers):
            c_in = in_ch if i == 0 else ch
            setattr(self, f"gn_{i}", nn.GroupNorm(4, c_in, eps=1e-6))
            setattr(self, f"conv_{i}", precision.Conv2d(c_in, ch, 3, padding=1))
        self.gn_tdf = nn.GroupNorm(4, ch, eps=1e-6)
        self.tdf1 = precision.Linear(dim_f, dim_f // bn)
        self.tdf2 = precision.Linear(dim_f // bn, dim_f)

    def forward(self, x):
        for i in range(self.tfc_layers):
            y = getattr(self, f"conv_{i}")(_gelu(getattr(self, f"gn_{i}")(x)))
            x = y if i == 0 and x.shape[1] != y.shape[1] else x + y
        return x + self.tdf2(_gelu(self.tdf1(_gelu(self.gn_tdf(x)))))


class MDXNet(nn.Module):
    """audio (b, channels, n) -> {stem: (b, channels, n)}."""

    def __init__(self, cfg: MDXConfig = MDXConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.stem = precision.Conv2d(c.channels * 2, c.g, 1)
        chs, dim_f = c.g, c.dim_f
        for i in range(c.depth):
            setattr(self, f"enc_{i}", TFC_TDF(chs, chs, dim_f, c.tfc_layers, c.bn))
            setattr(self, f"down_{i}", precision.Conv2d(chs, chs + c.g, 2, stride=2))
            chs += c.g
            dim_f //= 2
        self.mid = TFC_TDF(chs, chs, dim_f, c.tfc_layers, c.bn)
        for i in range(c.depth - 1, -1, -1):
            setattr(self, f"up_{i}", precision.ConvTranspose2d(chs, chs - c.g, 2, stride=2))
            chs -= c.g
            dim_f *= 2
            setattr(self, f"dec_{i}", TFC_TDF(2 * chs, chs, dim_f, c.tfc_layers, c.bn))
        for stem in c.stems:
            setattr(self, f"head_{stem}", precision.Conv2d(chs, c.channels * 2, 1))

    def forward(self, audio):
        c = self.cfg
        b, ch, n = audio.shape
        real, imag = stft(audio, n_fft=c.n_fft, hop=c.hop)       # (b, ch, T, bins)
        n_bins = c.n_fft // 2 + 1
        t_frames = real.shape[-2]
        # channel ch * 2 + (0 real, 1 imag), only dim_f bins
        spec = torch.stack([real, imag], dim=2).reshape(b, ch * 2, t_frames, n_bins)
        x = self.stem(spec[..., : c.dim_f])
        skips = []
        for i in range(c.depth):
            x = getattr(self, f"enc_{i}")(x)
            skips.append(x)
            # flax's SAME padding of a 2x2 stride-2 conv: one row / column at
            # the end of an odd axis
            x = F.pad(x, (0, x.shape[-1] % 2, 0, x.shape[-2] % 2))
            x = getattr(self, f"down_{i}")(x)
        x = self.mid(x)
        for i in range(c.depth - 1, -1, -1):
            x = getattr(self, f"up_{i}")(x)
            x = x[:, :, : skips[i].shape[2], : skips[i].shape[3]]
            x = getattr(self, f"dec_{i}")(torch.cat([x, skips[i]], dim=1))
        out = {}
        for stem in c.stems:
            m = F.pad(getattr(self, f"head_{stem}")(x), (0, n_bins - c.dim_f))
            m = m.reshape(b, ch, 2, t_frames, n_bins)
            out[stem] = istft(m[:, :, 0], m[:, :, 1], n_fft=c.n_fft, hop=c.hop, length=n)
        return out


class MDXOnnxSeparator:
    """A published MDX-NET ``.onnx`` graph as an ensemble member, in the
    ConvTDFNetTrim framing of the reference:

      stereo chunk (b, 2, hop*(dim_t-1)) -> (b, 4, dim_f, dim_t), channels
      [ch0_re, ch0_im, ch1_re, ch1_im] -> the graph (the target stem's
      spectrum) -> bins zero-padded back to n_fft//2+1 -> iSTFT;
      the complement stem is mix - target.

    Long inputs follow demix_base's trim-margin windowing: windows of the
    model's chunk length stride by gen = chunk - 2*trim (trim = n_fft//2),
    the input is zero-padded by trim at both ends, and only each window's
    middle gen samples are kept.  All windows run as one batch."""

    def __init__(self, graph_or_path, dim_f: int = 3072, dim_t: int = 256,
                 n_fft: int = 7680, hop: int = 1024, target: str = "vocals"):
        g = load_onnx(graph_or_path) if isinstance(graph_or_path, str) else graph_or_path
        self.runner = OnnxRunner(g)
        self.input_name = next(n for n in g.inputs if n not in g.initializers)
        self.dim_f, self.dim_t = dim_f, dim_t
        self.n_fft, self.hop = n_fft, hop
        self.target = target
        self.chunk = hop * (dim_t - 1)

    def _spec(self, audio):
        """(b, 2, chunk) -> (b, 4, dim_f, dim_t)."""
        re, im = stft(audio, n_fft=self.n_fft, hop=self.hop)     # (b, 2, T, bins)
        x = torch.stack([re, im], dim=2)
        x = x.reshape(x.shape[0], 4, x.shape[3], x.shape[4]).transpose(2, 3)
        return x[:, :, : self.dim_f, : self.dim_t]

    def _unspec(self, spec, length: int):
        """(b, 4, dim_f, dim_t) -> (b, 2, length)."""
        n_bins = self.n_fft // 2 + 1
        x = F.pad(spec, (0, 0, 0, n_bins - self.dim_f)).transpose(2, 3)
        x = x.reshape(x.shape[0], 2, 2, x.shape[2], n_bins)
        return istft(x[:, :, 0], x[:, :, 1], n_fft=self.n_fft, hop=self.hop, length=length)

    def _forward(self, audio):
        (est,) = self.runner(**{self.input_name: self._spec(audio)})
        return self._unspec(est, audio.shape[-1])

    def __call__(self, audio):
        """(b, 2, n) -> {target: (b, 2, n), complement: (b, 2, n)}, the
        EnsembleMember contract (pipelines/separate.py)."""
        b, ch, n = audio.shape
        trim = self.n_fft // 2
        gen = self.chunk - 2 * trim
        if gen <= 0:
            raise ValueError("model chunk shorter than 2 * trim")
        pad = (-n) % gen
        x = F.pad(audio, (trim, pad + trim))
        k = (n + pad) // gen
        xw = x.unfold(-1, self.chunk, gen)                      # (b, ch, k, chunk)
        xw = xw.transpose(1, 2).reshape(b * k, ch, self.chunk)
        y = self._forward(xw).reshape(b, k, ch, self.chunk)[..., trim:-trim]
        y = y.transpose(1, 2).reshape(b, ch, -1)[..., :n]
        comp = "instrumental" if self.target == "vocals" else "vocals"
        return {self.target: y, comp: audio - y}
