"""Random weights for benchmarks and smoke runs (counterpart of
audiolab_tpu/utils/fast_init.py).

The JAX package's benchmark fills every parameter tree by name, so that a
full-width forward pass neither overflows nor collapses to zeros; the port
fills its modules by the same rules, on the module's own device:

  - norm gains (a 1-D ``weight``, ``gamma``, ``scale``) and batch-norm
    variances -> 1
  - biases, ``beta`` and batch-norm means -> 0
  - everything else -> N(0, 0.02)
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def fast_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill ``module``'s parameters and batch-norm statistics in place from a
    generator seeded with ``seed``; returns the module."""
    gen = {}
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        if not t.is_floating_point():
            continue
        if (leaf in ("gamma", "scale", "running_var")
                or (leaf == "weight" and t.dim() == 1)):
            t.fill_(1.0)
        elif leaf.startswith("bias") or leaf in ("beta", "running_mean"):
            t.zero_()
        else:
            dev = t.device
            if dev not in gen:
                gen[dev] = torch.Generator(device=dev).manual_seed(seed)
            t.normal_(0.0, 0.02, generator=gen[dev])
    return module
