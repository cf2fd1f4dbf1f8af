"""AudioSR's 48 kHz HiFi-GAN vocoder (counterpart of
audiolab_tpu/models/audiosr_vocoder.py; upstream: the audiosr wheel's
hifigan/models_v2.py:154-230 at utilities/model.py's 48k config): 256-bin
mel -> waveform at 480x upsample (rates 6·5·4·2·2, 1536 initial channels,
four MRF kernels 3/7/11/15 with dilations 1/3/5).

Parameter names are the upstream ones (``conv_pre``, ``ups.i``,
``resblocks.{i * 4 + j}.convs{1,2}.d``, ``conv_post``), which
``convert_audiosr_vocoder`` maps; the weight norms are folded into plain
``weight`` tensors.  The upsampling layers are torch's ConvTranspose1d(k =
2u, padding u//2 + u%2, output_padding u%2), as upstream.  Takes the mel as
(b, num_mels, t), the upstream layout, and returns (b, t * 480).
Everything is fp32, and on the card TF32 is off (core/precision.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class ResBlock1(nn.Module):
    """models_v2 ResBlock1: [lrelu(0.1) -> dilated conv -> lrelu(0.1) ->
    conv] x 3, each residual."""

    def __init__(self, ch: int, kernel: int, dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(ch, ch, kernel, dilation=d, padding=d * (kernel - 1) // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(ch, ch, kernel, padding=(kernel - 1) // 2) for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, 0.1)), 0.1))
        return x


class AudioSRVocoder(nn.Module):
    """mel (b, num_mels, t) -> waveform (b, t * prod(rates)) at 48 kHz."""

    def __init__(self, num_mels: int = 256, initial_channel: int = 1536,
                 upsample_rates: Sequence[int] = (6, 5, 4, 2, 2),
                 resblock_kernels: Sequence[int] = (3, 7, 11, 15),
                 resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5),) * 4):
        super().__init__()
        self.num_kernels = len(resblock_kernels)
        self.conv_pre = nn.Conv1d(num_mels, initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = initial_channel
        for u in upsample_rates:
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, 2 * u, stride=u,
                                               padding=u // 2 + u % 2, output_padding=u % 2))
            ch //= 2
            for k, d in zip(resblock_kernels, resblock_dilations):
                self.resblocks.append(ResBlock1(ch, k, d))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel):
        x = self.conv_pre(mel)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, 0.1))
            blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            xs = blocks[0](x)
            for block in blocks[1:]:
                xs = xs + block(x)
            x = xs / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01))   # F.leaky_relu's default slope
        return torch.tanh(x)[:, 0]
