"""f0 helpers of the RVC path (counterpart of part of audiolab_tpu/dsp/f0.py)."""

from __future__ import annotations

import numpy as np
import torch


def coarse_f0(f0: torch.Tensor, f0_min: float = 50.0, f0_max: float = 1100.0) -> torch.Tensor:
    """Quantize f0 (Hz) to RVC's 1-255 mel-scale pitch bins (int64)."""
    f0_mel_min = 1127.0 * np.log(1.0 + f0_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1.0 + f0_max / 700.0)
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - f0_mel_min) * 254.0 / (f0_mel_max - f0_mel_min) + 1.0
    scaled = torch.where(f0_mel > 0.0, scaled, torch.ones_like(scaled))
    return torch.clamp(torch.round(scaled), 1, 255).long()
