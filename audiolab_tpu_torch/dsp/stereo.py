"""Mid/side stereo ops (counterpart of audiolab_tpu/dsp/stereo.py;
reference: handlers/stereo.py:4-23), on the input tensor's device.

Used by the Clone processor to convert the mid channel only and recombine
(modules/rvc/infer/modules/vc/pipeline.py:469-535).
"""

from __future__ import annotations

import torch


def stereo_to_ms(stereo: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(2, n)`` -> (mid, side), each ``(n,)``."""
    left, right = stereo[0], stereo[1]
    return 0.5 * (left + right), 0.5 * (left - right)


def ms_to_stereo(mid: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    """(mid, side) -> ``(2, n)``."""
    return torch.stack([mid + side, mid - side])


def resample_side(side: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear-interp length match for the side channel (handlers/stereo.py:12-17).
    Read positions are taken in fp64 and the fractions cast to fp32: an fp32
    position is off by up to half an ulp, a quarter sample at 60 s."""
    orig_len = side.shape[-1]
    if new_len == orig_len:
        return side
    pos = torch.linspace(0.0, orig_len - 1.0, new_len, dtype=torch.float64, device=side.device)
    i0 = torch.clamp(torch.floor(pos).long(), 0, orig_len - 1)
    i1 = torch.clamp(i0 + 1, 0, orig_len - 1)
    frac = (pos - i0).to(side.dtype)
    return side[..., i0] * (1.0 - frac) + side[..., i1] * frac
