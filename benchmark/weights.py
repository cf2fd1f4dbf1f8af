"""Seeded weights, made on the module's device in one draw and filled by
parameter name, so that the program's module and the reference's, which
share their parameter names, get the same values from the same seed.

Rules, by name and shape: a 1-d ``weight`` or a ``gamma`` (a norm's gain)
is 1 + 0.1 n; a bias, ``beta`` or ``running_mean`` is 0.1 n; a
``running_var`` is exp(0.2 n); every other tensor is n * gain / sqrt(fan_in),
with fan_in its size over its first axis, n standard normal.  ``gains`` maps
name prefixes to that gain (the longest prefix wins, default 1).

``shaped`` maps a parameter's full name to ``{"std": s, "smooth": w}``: its
draw is n * s, smoothed along the first axis by a Gaussian of ``w`` rows and
brought back to standard deviation s: a trained pitch classifier's
neighbouring bins answer alike.
"""

from __future__ import annotations

import numpy as np
import torch


def subseed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one use of a run's seed."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, *keys]).generate_state(
        1, np.uint64)[0] >> 1)


def _tensors(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    out = dict(module.named_parameters())
    for mod_name, mod in module.named_modules():
        for name, buf in mod.named_buffers(recurse=False):
            if name not in mod._non_persistent_buffers_set and buf.is_floating_point():
                out[f"{mod_name}.{name}" if mod_name else name] = buf
    return out


def _gain(name: str, gains: dict[str, float]) -> float:
    best = max((p for p in gains if name.startswith(p)), key=len, default=None)
    return 1.0 if best is None else float(gains[best])


@torch.no_grad()
def _smooth(v: torch.Tensor, width: float) -> torch.Tensor:
    half = int(3 * width)
    k = torch.exp(-0.5 * (torch.arange(-half, half + 1, device=v.device) / width) ** 2)
    rows = v.reshape(v.shape[0], -1).t()[:, None]                 # (cols, 1, rows)
    out = torch.nn.functional.conv1d(torch.nn.functional.pad(rows, (half, half), mode="reflect"),
                                     (k / k.sum())[None, None])
    return out[:, 0].t().reshape(v.shape)


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int, init: dict | None = None):
    """Fill every parameter and persistent float buffer of ``module`` in
    place from ``seed``; ``init`` holds the module's ``gains`` and
    ``shaped`` (a configuration's ``init`` entry for it).  Returns the
    module."""
    gains, shaped = (init or {}).get("gains", {}), (init or {}).get("shaped", {})
    tensors = _tensors(module)
    names = sorted(tensors)
    dev = tensors[names[0]].device
    total = sum(tensors[n].numel() for n in names)
    gen = torch.Generator(device=dev).manual_seed(subseed(seed, 1))
    flat = torch.randn(total, generator=gen, device=dev)
    at = 0
    for name in names:
        t = tensors[name]
        n = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
        leaf = name.rsplit(".", 1)[-1]
        if name in shaped:
            v = _smooth(n, shaped[name]["smooth"])
            v = v * (shaped[name]["std"] / v.std().clamp(min=1e-12))
        elif leaf == "gamma" or (leaf == "weight" and t.dim() == 1):
            v = 1.0 + 0.1 * n
        elif leaf.startswith("bias") or leaf in ("beta", "running_mean"):
            v = 0.1 * n
        elif leaf == "running_var":
            v = torch.exp(0.2 * n)
        else:
            v = n * (_gain(name, gains) / np.sqrt(max(1, t.numel() // t.shape[0])))
        t.copy_(v.to(t.dtype))
    return module
