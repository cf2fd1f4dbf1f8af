"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent move to the CPU."""

from __future__ import annotations

import torch

from audiolab_tpu_torch.core.precision import apply_policy


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises when a CUDA
    device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    apply_policy()
    return dev
