"""UVR "VR architecture" nets (counterpart of
audiolab_tpu/models/separation/vr.py), under the key names of the published
``.pth`` checkpoints (tsurumeso vocal-remover lib_v5), so a checkpoint loads
with ``load_state_dict`` and the JAX package's ``convert_vr`` maps a
``state_dict`` of these modules to its flax tree.

* ``CascadedASPPNet`` (lib_v5 nets.py): three cascaded ASPP U-Nets over a
  low/high band split, separable dilated convolutions in the ASPP.
* ``CascadedNet`` (lib_v5 nets_new.py): per-band two-stage cascades of
  BaseNets with a bidirectional LSTM over the bins at the dec2 level.

Both take a magnitude spectrogram ``(b, 2, bins, frames)`` and return a
sigmoid mask ``(b, 2, n_fft // 2 + 1, frames)``.  Batch norms run in eval
mode from their running statistics; the auxiliary heads of training are
kept for the checkpoint's keys and not run.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class VRConfig:
    arch: str = "cascaded_net"   # cascaded_net (nets_new) | cascaded_asppnet
    n_fft: int = 2048            # 2 * combined-spec bins (the model's param json)
    ch: int = 32                 # old arch width
    nout: int = 32               # new arch widths
    nout_lstm: int = 128
    dilations: tuple = (4, 8, 16)                       # old arch ASPP
    dilations_new: tuple = ((4, 2), (8, 4), (12, 6))    # new arch ASPP (freq, time)

    @property
    def max_bin(self) -> int:
        return self.n_fft // 2

    @property
    def output_bin(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def offset(self) -> int:
        """Frames cropped from each side of an inference window."""
        return 128 if self.arch == "cascaded_asppnet" else 64


def _up2(x: torch.Tensor, size=None) -> torch.Tensor:
    size = size or (x.shape[2] * 2, x.shape[3] * 2)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def _crop_center(skip: torch.Tensor, w: int) -> torch.Tensor:
    """Centre-crop the frame axis of a skip connection to ``w``."""
    sw = skip.shape[3]
    if sw == w:
        return skip
    s = (sw - w) // 2
    return skip[..., s:s + w]


def _activ(kind: str) -> nn.Module:
    return nn.ReLU() if kind == "relu" else nn.LeakyReLU(0.01)


class Conv2DBNActiv(nn.Module):
    """Convolution without bias, batch norm, activation (``conv.0/1/2``)."""

    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1, activ="relu"):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, ksize, stride, pad, dilation, bias=False),
            nn.BatchNorm2d(nout), _activ(activ))

    def forward(self, x):
        return self.conv(x)


class SeperableConv2DBNActiv(nn.Module):
    """Depthwise and pointwise convolutions, batch norm, activation."""

    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1, activ="relu"):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nin, ksize, stride, pad, dilation, groups=nin, bias=False),
            nn.Conv2d(nin, nout, 1, bias=False), nn.BatchNorm2d(nout), _activ(activ))

    def forward(self, x):
        return self.conv(x)


# ----------------------------------------------------- old arch (nets.py)

class EncoderV5(nn.Module):
    def __init__(self, nin, nout, stride=2):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, 1, 1, activ="leaky")
        self.conv2 = Conv2DBNActiv(nout, nout, 3, stride, 1, activ="leaky")

    def forward(self, x):
        skip = self.conv1(x)
        return self.conv2(skip), skip


class DecoderV5(nn.Module):
    def __init__(self, nin, nout):
        super().__init__()
        self.conv = Conv2DBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x, skip):
        x = _up2(x)
        return self.conv(torch.cat([x, _crop_center(skip, x.shape[3])], dim=1))


class ASPPModuleV5(nn.Module):
    def __init__(self, nin, nout, dilations=(4, 8, 16)):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   Conv2DBNActiv(nin, nin, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nin, 1, 1, 0)
        self.conv3 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[0], dilations[0])
        self.conv4 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[1], dilations[1])
        self.conv5 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[2], dilations[2])
        self.bottleneck = nn.Sequential(Conv2DBNActiv(nin * 5, nout, 1, 1, 0), nn.Dropout2d(0.1))

    def forward(self, x):
        feat1 = _up2(self.conv1(x), x.shape[2:])
        return self.bottleneck(torch.cat(
            [feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)], dim=1))


class BaseASPPNet(nn.Module):
    def __init__(self, nin, ch, dilations=(4, 8, 16)):
        super().__init__()
        self.enc1 = EncoderV5(nin, ch)
        self.enc2 = EncoderV5(ch, ch * 2)
        self.enc3 = EncoderV5(ch * 2, ch * 4)
        self.enc4 = EncoderV5(ch * 4, ch * 8)
        self.aspp = ASPPModuleV5(ch * 8, ch * 16, dilations)
        self.dec4 = DecoderV5(ch * (8 + 16), ch * 8)
        self.dec3 = DecoderV5(ch * (4 + 8), ch * 4)
        self.dec2 = DecoderV5(ch * (2 + 4), ch * 2)
        self.dec1 = DecoderV5(ch * (1 + 2), ch)

    def forward(self, x):
        h, e1 = self.enc1(x)
        h, e2 = self.enc2(h)
        h, e3 = self.enc3(h)
        h, e4 = self.enc4(h)
        h = self.aspp(h)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        return self.dec1(h, e1)


def _mask_out(mask: torch.Tensor, output_bin: int) -> torch.Tensor:
    """Pad the mask's bins to ``output_bin`` by repeating the last one."""
    return F.pad(mask, (0, 0, 0, output_bin - mask.shape[2]), mode="replicate")


class CascadedASPPNet(nn.Module):
    """lib_v5 nets.py: magnitude (b, 2, bins, frames) -> mask."""

    def __init__(self, cfg: VRConfig = VRConfig(arch="cascaded_asppnet")):
        super().__init__()
        self.cfg = cfg
        ch, dil = cfg.ch, cfg.dilations
        self.stg1_low_band_net = BaseASPPNet(2, ch, dil)
        self.stg1_high_band_net = BaseASPPNet(2, ch, dil)
        self.stg2_bridge = Conv2DBNActiv(2 + ch, ch // 2, 1, 1, 0)
        self.stg2_full_band_net = BaseASPPNet(ch // 2, ch, dil)
        self.stg3_bridge = Conv2DBNActiv(2 + 2 * ch, ch, 1, 1, 0)
        self.stg3_full_band_net = BaseASPPNet(ch, ch * 2, dil)
        self.out = nn.Conv2d(ch * 2, 2, 1, bias=False)
        self.aux1_out = nn.Conv2d(ch, 2, 1, bias=False)
        self.aux2_out = nn.Conv2d(ch, 2, 1, bias=False)

    def forward(self, x):
        x = x[:, :, : self.cfg.max_bin]
        bandw = x.shape[2] // 2
        aux1 = torch.cat([self.stg1_low_band_net(x[:, :, :bandw]),
                          self.stg1_high_band_net(x[:, :, bandw:])], dim=2)
        aux2 = self.stg2_full_band_net(self.stg2_bridge(torch.cat([x, aux1], dim=1)))
        h = self.stg3_full_band_net(self.stg3_bridge(torch.cat([x, aux1, aux2], dim=1)))
        return _mask_out(torch.sigmoid(self.out(h)), self.cfg.output_bin)


# ------------------------------------------------- new arch (nets_new.py)

class EncoderNew(nn.Module):
    def __init__(self, nin, nout, stride=2):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, stride, 1, activ="leaky")
        self.conv2 = Conv2DBNActiv(nout, nout, 3, 1, 1, activ="leaky")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class DecoderNew(nn.Module):
    def __init__(self, nin, nout):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x, skip):
        x = _up2(x)
        return self.conv1(torch.cat([x, _crop_center(skip, x.shape[3])], dim=1))


class ASPPModuleNew(nn.Module):
    def __init__(self, nin, nout, dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.conv1 = nn.Sequential(nn.AdaptiveAvgPool2d((1, None)),
                                   Conv2DBNActiv(nin, nout, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0], dilations[0])
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1], dilations[1])
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2], dilations[2])
        self.bottleneck = nn.Conv2d(nout * 5, nout, 1, bias=False)

    def forward(self, x):
        feat1 = _up2(self.conv1(x), x.shape[2:])
        return self.bottleneck(torch.cat(
            [feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)], dim=1))


class LSTMModule(nn.Module):
    """Convolution to one channel, a bidirectional LSTM along the frames
    with the bins as features, and a dense layer back to the bins."""

    def __init__(self, nin_conv, nin_lstm, nout_lstm):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(input_size=nin_lstm, hidden_size=nout_lstm // 2,
                            bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm), nn.BatchNorm1d(nin_lstm),
                                   nn.ReLU())

    def forward(self, x):
        n, _, nbins, nframes = x.shape
        h = self.conv(x)[:, 0].permute(2, 0, 1)          # (frames, b, bins)
        h, _ = self.lstm(h)
        h = self.dense(h.reshape(-1, h.shape[-1]))
        return h.reshape(nframes, n, 1, nbins).permute(1, 2, 3, 0)


class BaseNet(nn.Module):
    def __init__(self, nin, nout, nin_lstm, nout_lstm, dilations=((4, 2), (8, 4), (12, 6))):
        super().__init__()
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = EncoderNew(nout, nout * 2)
        self.enc3 = EncoderNew(nout * 2, nout * 4)
        self.enc4 = EncoderNew(nout * 4, nout * 6)
        self.enc5 = EncoderNew(nout * 6, nout * 8)
        self.aspp = ASPPModuleNew(nout * 8, nout * 8, dilations)
        self.dec4 = DecoderNew(nout * (6 + 8), nout * 6)
        self.dec3 = DecoderNew(nout * (4 + 6), nout * 4)
        self.dec2 = DecoderNew(nout * (2 + 4), nout * 2)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = DecoderNew(nout * (1 + 2) + 1, nout)

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNet(nn.Module):
    """lib_v5 nets_new.py: magnitude (b, 2, bins, frames) -> mask."""

    def __init__(self, cfg: VRConfig = VRConfig(arch="cascaded_net")):
        super().__init__()
        self.cfg = cfg
        nout, nl, dil = cfg.nout, cfg.nout_lstm, cfg.dilations_new
        nin_lstm = cfg.max_bin // 2
        self.stg1_low_band_net = nn.Sequential(
            BaseNet(2, nout // 2, nin_lstm // 2, nl, dil),
            Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0))
        self.stg1_high_band_net = BaseNet(2, nout // 4, nin_lstm // 2, nl // 2, dil)
        self.stg2_low_band_net = nn.Sequential(
            BaseNet(nout // 4 + 2, nout, nin_lstm // 2, nl, dil),
            Conv2DBNActiv(nout, nout // 2, 1, 1, 0))
        self.stg2_high_band_net = BaseNet(nout // 4 + 2, nout // 2, nin_lstm // 2, nl // 2, dil)
        self.stg3_full_band_net = BaseNet(3 * nout // 4 + 2, nout, nin_lstm, nl, dil)
        self.out = nn.Conv2d(nout, 2, 1, bias=False)
        self.aux_out = nn.Conv2d(3 * nout // 4, 2, 1, bias=False)

    def forward(self, x):
        x = x[:, :, : self.cfg.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1))
        return _mask_out(torch.sigmoid(self.out(f3)), self.cfg.output_bin)


def make_vr_net(cfg: VRConfig) -> nn.Module:
    if cfg.arch == "cascaded_asppnet":
        return CascadedASPPNet(cfg)
    return CascadedNet(cfg)


def infer_vr_config(sd: dict, n_fft: int | None = None) -> VRConfig:
    """Architecture and widths of a UVR ``.pth`` state dict."""
    if any(k.startswith("stg2_bridge.") for k in sd):
        ch = sd["stg1_low_band_net.enc1.conv1.conv.0.weight"].shape[0]
        return VRConfig(arch="cascaded_asppnet", ch=int(ch), n_fft=n_fft or 2048)
    nout = int(sd["out.weight"].shape[1])
    ih = sd["stg1_low_band_net.0.lstm_dec2.lstm.weight_ih_l0"]
    nout_lstm = int(ih.shape[0]) // 2          # 4 gates * (nout_lstm // 2)
    inferred_nfft = int(ih.shape[1]) * 8       # input = max_bin // 4
    return VRConfig(arch="cascaded_net", nout=nout, nout_lstm=nout_lstm,
                    n_fft=n_fft or inferred_nfft)
