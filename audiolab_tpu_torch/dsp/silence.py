"""Silence restoration / amplitude-profile transfer (counterpart of
audiolab_tpu/dsp/silence.py; reference: handlers/noise_removal.py:6-136
``restore_silence``).

The framewise RMS envelopes, gains and masks are computed for all frames at
once on the device and overlap-added with ``F.fold``, which sums each
output sample's frames in a fixed order (the JAX package scatter-adds);
the clone is resampled to the original's rate on the device, and the
BS.1770 loudness match runs on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audiolab_tpu_torch.core.device import resolve_device
from audiolab_tpu_torch.dsp.loudness import integrated_loudness
from audiolab_tpu_torch.kernels.resample import resample


def overlap_add(frames: torch.Tensor, hop: int, n: int) -> torch.Tensor:
    """``(c, T, W)`` frames at stride ``hop`` -> ``(c, n)``: frame t starts at
    sample t * hop; samples no frame reaches are 0."""
    c, t_frames, w = frames.shape
    length = (t_frames - 1) * hop + w
    out = F.fold(frames.transpose(1, 2), output_size=(1, length), kernel_size=(1, w),
                 stride=(1, hop))[:, 0, 0]
    return F.pad(out, (0, n - length)) if length < n else out[:, :n]


def _restore_core(
    orig: torch.Tensor,
    clone: torch.Tensor,
    silence_threshold: float = 0.002,
    window_size: int = 1024,
    hop: int = 512,
) -> torch.Tensor:
    """Per-channel framewise gain/mask transfer; both ``(c, n)``, same n."""
    n = orig.shape[-1]
    dev = orig.device
    win = torch.from_numpy(np.hanning(window_size).astype(np.float32)).to(dev)
    t_frames = max(1, 1 + (n - window_size) // hop)
    idx = torch.arange(t_frames, device=dev)[:, None] * hop + torch.arange(
        window_size, device=dev)[None, :]
    idx = idx.clamp(max=n - 1)      # a signal shorter than a window: XLA clamps the gather

    of = orig[:, idx] * win  # (c, T, W)
    cf = clone[:, idx] * win
    orms = torch.sqrt(torch.mean(of**2, dim=-1) + 1e-8)  # (c, T)
    crms = torch.sqrt(torch.mean(cf**2, dim=-1) + 1e-8)
    silent = orms < silence_threshold
    gain = torch.where(silent, 1.0, torch.clamp(orms / (crms + 1e-8), max=10.0))
    mask = torch.where(silent, 0.0, 1.0)

    # window-weighted overlap-add of the per-frame scalars -> sample envelopes
    wsum = overlap_add(win.expand(1, t_frames, window_size), hop, n)[0]
    wsum = torch.where(wsum > 1e-8, wsum, 1.0)
    gain_env = overlap_add(gain[..., None] * win, hop, n) / wsum
    mask_env = overlap_add(mask[..., None] * win, hop, n) / wsum
    return clone * gain_env * mask_env


def restore_silence(
    original: np.ndarray,
    cloned: np.ndarray,
    sr_original: int,
    sr_cloned: int,
    silence_threshold: float = 0.002,
    window_size: int = 1024,
    hop: int = 512,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Match the clone's envelope/silences to the original's; arrays are
    ``(n,)`` or ``(channels, n)``; returns the original's shape/rate."""
    dev = resolve_device(device)
    orig = np.atleast_2d(np.asarray(original, dtype=np.float32))
    clone = torch.from_numpy(np.atleast_2d(np.asarray(cloned, dtype=np.float32))).to(dev)

    if sr_cloned != sr_original:
        clone = resample(clone, sr_cloned, sr_original)
    n = orig.shape[-1]
    if clone.shape[-1] > n:
        clone = clone[:, :n]
    elif clone.shape[-1] < n:
        clone = F.pad(clone, (0, n - clone.shape[-1]))
    if clone.shape[0] != orig.shape[0]:
        clone = clone[:1].expand(orig.shape).contiguous()

    result = _restore_core(torch.from_numpy(orig).to(dev), clone, silence_threshold,
                           window_size, hop).cpu().numpy()

    # global loudness match (reference uses pyloudnorm BS.1770; ours in dsp/loudness)
    ol = integrated_loudness(orig, sr_original)
    pl = integrated_loudness(result, sr_original)
    if ol > -70.0 and pl > -70.0:
        result = result * (10.0 ** ((ol - pl) / 20.0))
    else:
        orms, rrms = np.sqrt(np.mean(orig**2)), np.sqrt(np.mean(result**2))
        if rrms > 1e-8:
            result = result * (orms / rrms)

    peak = np.max(np.abs(result)) if result.size else 0.0
    if peak > 0.98:
        result = result * (0.98 / peak)
    return result[0] if np.asarray(original).ndim == 1 else result
