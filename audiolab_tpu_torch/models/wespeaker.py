"""WeSpeaker ResNet34 speaker-embedding model, the r-vector of
pyannote/speaker-diarization-3.1 (counterpart of
audiolab_tpu/models/wespeaker.py).

A plain ResNet-34 (m_channels 32, blocks 3/4/6/3) over the 80-bin kaldi
fbank as a (freq, time) image, temporal statistics pooling (mean ++
unbiased std over time of the flattened channel x freq map) and one
linear projection to a 256-d embedding.  Front end: kaldi fbank (80 mels,
25 ms, 10 ms, dither 0) and per-utterance mean removal.

Parameter names are wespeaker's (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.shortcut.0``, ``seg_1``), the names
``convert_wespeaker`` maps; the BatchNorms are torch's with their running
statistics (the JAX package folds them into per-channel affines at
conversion).  Layout (b, C, F, T).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audiolab_tpu_torch.kernels.kaldi import kaldi_fbank


@dataclass(frozen=True)
class WeSpeakerConfig:
    feat_dim: int = 80
    embed_dim: int = 256
    m_channels: int = 32
    num_blocks: tuple = (3, 4, 6, 3)      # ResNet34
    two_emb_layer: bool = False           # voxceleb-resnet34-LM: False
    sr: int = 16000


class BasicBlock(nn.Module):
    """conv3x3-bn-relu, conv3x3-bn, += shortcut (1x1 conv + bn when the
    shape changes), relu."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + self.shortcut(x))


class WeSpeakerResNet(nn.Module):
    def __init__(self, cfg: WeSpeakerConfig = WeSpeakerConfig()):
        super().__init__()
        self.cfg = c = cfg
        m = c.m_channels
        self.conv1 = nn.Conv2d(1, m, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(m)
        cin = m
        for li, (nb, stride) in enumerate(zip(c.num_blocks, (1, 2, 2, 2)), start=1):
            planes = m * 2 ** (li - 1)
            blocks = []
            for bi in range(nb):
                blocks.append(BasicBlock(cin, planes, stride if bi == 0 else 1))
                cin = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        stats_dim = cin * -(-c.feat_dim // 8) * 2    # three stride-2 stages
        self.seg_1 = nn.Linear(stats_dim, c.embed_dim)
        if c.two_emb_layer:
            self.seg_bn_1 = nn.BatchNorm1d(c.embed_dim, affine=False)
            self.seg_2 = nn.Linear(c.embed_dim, c.embed_dim)

    def forward(self, fbank):
        """fbank (b, t, feat_dim), mean-removed -> (b, embed_dim)."""
        x = fbank.transpose(1, 2)[:, None]                  # (b, 1, F, T)
        x = F.relu(self.bn1(self.conv1(x)))
        for li in range(1, len(self.cfg.num_blocks) + 1):
            x = getattr(self, f"layer{li}")(x)
        b, ch, fdim, tdim = x.shape
        x = x.reshape(b, ch * fdim, tdim)
        mean = x.mean(dim=-1)
        var = ((x - mean[..., None]) ** 2).sum(dim=-1) / max(tdim - 1, 1)
        embed_a = self.seg_1(torch.cat([mean, torch.sqrt(var + 1e-7)], dim=-1))
        if not self.cfg.two_emb_layer:
            return embed_a
        return self.seg_2(self.seg_bn_1(F.relu(embed_a)))


def wespeaker_fbank(wav, sr: int = 16000, n_mels: int = 80,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """Kaldi fbank (dither 0) with per-utterance mean removal; ``wav`` (b, n)
    or (n,), a tensor (its device) or an array (put on ``device``)."""
    if not torch.is_tensor(wav):
        wav = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    w = wav.float()
    if w.dim() == 1:
        w = w[None]
    fb = kaldi_fbank(w, sr=sr, n_mels=n_mels)
    return fb - fb.mean(dim=1, keepdim=True)


@torch.inference_mode()
def wespeaker_embed(model: WeSpeakerResNet, wav, sr: int = 16000) -> torch.Tensor:
    """Raw waveforms (b, n) -> L2-normalised (b, embed_dim) embeddings on the
    model's device."""
    dev = next(model.parameters()).device
    fb = wespeaker_fbank(wav, sr=sr, n_mels=model.cfg.feat_dim, device=dev)
    e = model(fb.to(dev))
    return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-9)
