"""RVC GAN discriminators (counterpart of
audiolab_tpu/models/rvc/discriminator.py; reference:
modules/rvc/lib/discriminator.py — MultiPeriodDiscriminatorV2 with periods
[2, 3, 5, 7, 11, 17, 23, 37] plus the scale discriminator DiscriminatorS).

NCT / NCHW layouts and the upstream key names (``discriminators.0`` is the
scale discriminator, ``discriminators.{1..}`` the period ones, each with
``convs.{j}`` and ``conv_post``), so that a published D checkpoint loads with
``load_state_dict`` once its weight norm is folded.  Weight norm is folded, as
in the JAX module: each convolution holds a plain ``weight``.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.core import precision
from audiolab_tpu_torch.models.layers import lrelu

V2_PERIODS = (2, 3, 5, 7, 11, 17, 23, 37)


class DiscriminatorP(nn.Module):
    """Period discriminator: fold time into (t/p, p) and run 2-D convs."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [precision.Conv2d(ci, co, (5, 1), (3, 1), padding=(2, 0))
             for ci, co in zip(chans[:-1], chans[1:])]
            + [precision.Conv2d(1024, 1024, (5, 1), 1, padding=(2, 0))])
        self.conv_post = precision.Conv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x):
        """x (b, 1, n) -> (scores (b, -1), feature maps NCHW)."""
        b, c, n = x.shape
        p = self.period
        pad = (-n) % p
        if pad:
            x = F.pad(x, (0, pad), mode="reflect" if n > 1 else "constant")
        x = x.view(b, c, (n + pad) // p, p)
        fmaps = []
        for conv in self.convs:
            x = lrelu(conv(x))
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.flatten(1), fmaps


class DiscriminatorS(nn.Module):
    """Scale discriminator: strided (grouped) 1-D convs on the waveform."""

    SPECS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16), (1024, 41, 4, 64),
             (1024, 41, 4, 256), (1024, 5, 1, 1))    # (out, kernel, stride, groups)

    def __init__(self):
        super().__init__()
        convs, cin = [], 1
        for co, k, s, g in self.SPECS:
            convs.append(precision.Conv1d(cin, co, k, s, padding=k // 2, groups=min(g, cin)))
            cin = co
        self.convs = nn.ModuleList(convs)
        self.conv_post = precision.Conv1d(1024, 1, 3, 1, padding=1)

    def forward(self, x):
        """x (b, 1, n) -> (scores (b, -1), feature maps NCT)."""
        fmaps = []
        for conv in self.convs:
            x = lrelu(conv(x))
            fmaps.append(x)
        x = self.conv_post(x)
        fmaps.append(x)
        return x.flatten(1), fmaps


class MultiPeriodDiscriminatorV2(nn.Module):
    def __init__(self, periods: Sequence[int] = V2_PERIODS):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in self.periods])

    def forward(self, y, y_hat):
        """y, y_hat (b, n) or (b, 1, n) -> (real_outs, fake_outs, real_fmaps,
        fake_fmaps), one entry per discriminator."""
        y = y[:, None] if y.dim() == 2 else y
        y_hat = y_hat[:, None] if y_hat.dim() == 2 else y_hat
        r_outs, f_outs, r_fmaps, f_fmaps = [], [], [], []
        for d in self.discriminators:
            ro, rf = d(y)
            fo, ff = d(y_hat)
            r_outs.append(ro)
            f_outs.append(fo)
            r_fmaps.append(rf)
            f_fmaps.append(ff)
        return r_outs, f_outs, r_fmaps, f_fmaps
