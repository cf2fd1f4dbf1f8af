"""CAMPPlus speaker (x-vector) encoder (counterpart of
audiolab_tpu/models/campplus.py): the 3D-Speaker CAMPPlus that Chatterbox's
``s3gen.safetensors`` bundles under ``speaker_encoder.`` and that embeds
reference audio for the S3Gen flow.

  head      FCM: a 2-D conv front end over (1, mel, T), two residual
            stages of BasicResBlock pairs (frequency stride 2 on the first
            of each), conv2 + bn2 with stride (2, 1); reshaped to
            (C * mel / 8, T) channels
  xvector   tdnn (Conv1d k5 stride 2 + BN + ReLU), three CAM dense blocks
            (bottleneck 1x1, CAM-gated k3 conv to the growth rate), a
            transit layer after each (BN + ReLU + 1x1 halving), BN + ReLU,
            mean ++ unbiased std over time, a 1x1 conv and a BatchNorm
            without affine

Parameter names are 3D-Speaker's (``head.layer1.0.conv1``,
``xvector.block1.tdnnd1.cam_layer.linear_local``, ...), the names
``convert_campplus`` maps; BatchNorms are torch's, in eval mode (the JAX
package's ``BNInfer`` holds the same running statistics as parameters).
Layouts are torch's: (b, C, F, T) and (b, C, T).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.kaldi import kaldi_fbank


@dataclass(frozen=True)
class CAMPPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128
    m_channels: int = 32
    block_layers: tuple = (12, 24, 16)
    block_kernels: tuple = (3, 3, 3)
    block_dilations: tuple = (1, 2, 2)
    seg_len: int = 100

    @property
    def head_out_channels(self) -> int:
        return self.m_channels * (self.feat_dim // 8)


class BNReLU(nn.Module):
    """get_nonlinear('batchnorm-relu'): ``batchnorm`` then ReLU."""

    def __init__(self, channels: int):
        super().__init__()
        self.batchnorm = nn.BatchNorm1d(channels)

    def forward(self, x):
        return F.relu(self.batchnorm(x))


class BasicResBlock(nn.Module):
    """FCM residual 2-D block; the stride downsamples the frequency axis only."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        s = (stride, 1)
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=s, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride=s, bias=False),
                                          nn.BatchNorm2d(planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.shortcut(x))


class FCM(nn.Module):
    def __init__(self, cfg: CAMPPlusConfig):
        super().__init__()
        m = cfg.m_channels
        self.conv1 = nn.Conv2d(1, m, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(m)
        self.layer1 = nn.Sequential(BasicResBlock(m, m, 2), BasicResBlock(m, m, 1))
        self.layer2 = nn.Sequential(BasicResBlock(m, m, 2), BasicResBlock(m, m, 1))
        self.conv2 = nn.Conv2d(m, m, 3, stride=(2, 1), padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(m)

    def forward(self, feat):
        """(b, t, mel) -> (b, m_channels * mel / 8, t)."""
        x = feat.transpose(1, 2)[:, None]                      # (b, 1, mel, t)
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer2(self.layer1(x))
        x = F.relu(self.bn2(self.conv2(x)))
        b, c, f, t = x.shape
        return x.reshape(b, c * f, t)


class CAMLayer(nn.Module):
    """Context-aware mask: the local conv gated by a sigmoid MLP over the
    global mean plus the segment means."""

    def __init__(self, bn_channels: int, out_channels: int, kernel: int, dilation: int,
                 seg_len: int = 100, reduction: int = 2):
        super().__init__()
        self.seg_len = seg_len
        self.linear_local = nn.Conv1d(bn_channels, out_channels, kernel, dilation=dilation,
                                      padding=(kernel - 1) // 2 * dilation, bias=False)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = nn.Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x):
        y = self.linear_local(x)
        b, c, t = x.shape
        sl = self.seg_len
        n_seg = -(-t // sl)
        seg = F.pad(x, (0, n_seg * sl - t)).reshape(b, c, n_seg, sl).sum(dim=-1)
        # avg_pool1d(ceil_mode=True): the tail window divides by its valid length
        lens = torch.clamp(t - torch.arange(n_seg, device=x.device) * sl, max=sl)
        seg = (seg / lens).repeat_interleave(sl, dim=-1)[..., :t]
        context = x.mean(dim=-1, keepdim=True) + seg
        m = torch.sigmoid(self.linear2(F.relu(self.linear1(context))))
        return y * m


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, cfg: CAMPPlusConfig, in_channels: int, kernel: int, dilation: int):
        super().__init__()
        bn_ch = cfg.bn_size * cfg.growth_rate
        self.nonlinear1 = BNReLU(in_channels)
        self.linear1 = nn.Conv1d(in_channels, bn_ch, 1, bias=False)
        self.nonlinear2 = BNReLU(bn_ch)
        self.cam_layer = CAMLayer(bn_ch, cfg.growth_rate, kernel, dilation, cfg.seg_len)

    def forward(self, x):
        return self.cam_layer(self.nonlinear2(self.linear1(self.nonlinear1(x))))


class CAMPPlus(nn.Module):
    """(b, t, feat_dim) CMN fbank -> (b, embedding_size)."""

    def __init__(self, cfg: CAMPPlusConfig = CAMPPlusConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.head = FCM(c)
        xv = nn.ModuleDict()
        tdnn = nn.Module()
        tdnn.linear = nn.Conv1d(c.head_out_channels, c.init_channels, 5, stride=2, padding=2,
                                bias=False)
        tdnn.nonlinear = BNReLU(c.init_channels)
        xv["tdnn"] = tdnn
        ch = c.init_channels
        for i, (n_layers, k, d) in enumerate(zip(c.block_layers, c.block_kernels,
                                                 c.block_dilations)):
            xv[f"block{i + 1}"] = nn.ModuleDict({
                f"tdnnd{li + 1}": CAMDenseTDNNLayer(c, ch + li * c.growth_rate, k, d)
                for li in range(n_layers)})
            ch += n_layers * c.growth_rate
            transit = nn.Module()
            transit.nonlinear = BNReLU(ch)
            transit.linear = nn.Conv1d(ch, ch // 2, 1, bias=False)
            xv[f"transit{i + 1}"] = transit
            ch //= 2
        xv["out_nonlinear"] = BNReLU(ch)
        dense = nn.Module()
        dense.linear = nn.Conv1d(2 * ch, c.embedding_size, 1, bias=False)
        dense.nonlinear = nn.Module()
        dense.nonlinear.batchnorm = nn.BatchNorm1d(c.embedding_size, affine=False)
        xv["dense"] = dense
        self.xvector = xv

    def forward(self, feat):
        xv = self.xvector
        x = self.head(feat)
        x = xv["tdnn"].nonlinear(xv["tdnn"].linear(x))
        for i in range(len(self.cfg.block_layers)):
            for layer in xv[f"block{i + 1}"].values():
                x = torch.cat([x, layer(x)], dim=1)
            transit = xv[f"transit{i + 1}"]
            x = transit.linear(transit.nonlinear(x))
        x = xv["out_nonlinear"](x)
        stats = torch.cat([x.mean(dim=-1), x.std(dim=-1, unbiased=True)], dim=-1)
        dense = xv["dense"]
        return dense.nonlinear.batchnorm(dense.linear(stats[:, :, None]))[:, :, 0]


@torch.inference_mode()
def campplus_xvector(model: CAMPPlus, wav16k) -> np.ndarray:
    """Reference waveform (n,) at 16 kHz -> (embedding_size,) x-vector on the
    host: kaldi fbank over ``feat_dim`` mels, per-utterance mean removal, the
    model on its own device."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(wav16k, np.float32), device=dev)[None]
    feat = kaldi_fbank(x, n_mels=model.cfg.feat_dim)
    feat = feat - feat.mean(dim=1, keepdim=True)
    return model(feat)[0].float().cpu().numpy()
