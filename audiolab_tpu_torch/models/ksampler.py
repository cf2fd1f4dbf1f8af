"""k-diffusion samplers for v-objective latent diffusion (counterpart of
audiolab_tpu/models/ksampler.py): the polyexponential sigma schedule,
k-diffusion's ``VDenoiser`` scalings and DPM-Solver++(3M) SDE, as
stable_audio_tools' ``sample_k`` runs them for stable-audio-open
(sampler "dpmpp-3m-sde", sigma 0.3 to 500, rho 1).

The JAX sampler is one ``lax.scan`` whose carry masks the multistep history
by the step index (``jnp.where(i >= 2, ...)``) over placeholder values; here
the step index is a Python int, so only the order the step has the history
for is computed, and nothing of an unselected branch reaches the result.
The per-step scalars (sigmas, h, the phi terms) are fp32, as in the JAX
graph.  The SDE noise is explicit: ``draws`` (steps, *x.shape) standard
normals, or drawn before the loop from a generator seeded with ``seed``
(the JAX sampler splits a ``jax.random`` key once a step).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

_F = np.float32


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace`` in fp32 as JAX computes it: start (1 - s) + stop s
    with s = iota / (num - 1) in fp32, the last value ``stop`` itself."""
    if num == 1:
        return np.array([start], np.float32)
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.float32(start) * (np.float32(1) - step) + np.float32(stop) * step
    return np.concatenate([out, [np.float32(stop)]]).astype(np.float32)


def sigmas_polyexponential(n: int, sigma_min: float, sigma_max: float,
                           rho: float = 1.0) -> np.ndarray:
    """(n + 1,) fp32: exp(ramp^rho (ln smax - ln smin) + ln smin) over
    ramp = linspace(1, 0, n), then 0."""
    ramp = np.linspace(1.0, 0.0, n) ** rho
    sig = np.exp(ramp * (math.log(sigma_max) - math.log(sigma_min)) + math.log(sigma_min))
    return np.concatenate([sig, [0.0]]).astype(np.float32)


def v_denoiser(model_v_fn: Callable) -> Callable:
    """A v-prediction ``model_v_fn(x, t) -> v`` (t a Python float in [0, 1])
    as a denoiser ``d(x, sigma) -> x0``: c_skip = 1/(s^2+1), c_out =
    -s/sqrt(s^2+1), c_in = 1/sqrt(s^2+1), t = atan(s) 2/pi, in fp32."""

    def denoise(x: torch.Tensor, sigma) -> torch.Tensor:
        s = _F(sigma)
        s2 = _F(s * s + _F(1.0))
        c_skip = _F(_F(1.0) / s2)
        c_out = _F(-s / np.sqrt(s2))
        c_in = _F(_F(1.0) / np.sqrt(s2))
        t = _F(_F(np.arctan(s)) / _F(math.pi) * _F(2.0))
        return model_v_fn(x * float(c_in), float(t)) * float(c_out) + x * float(c_skip)

    return denoise


def sde_draws(steps: int, shape: tuple, seed: int, device) -> torch.Tensor:
    """(steps, *shape) standard normals from a generator on ``device`` seeded
    with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((steps, *shape), generator=gen, device=device)


@torch.no_grad()
def sample_dpmpp_3m_sde(denoise_fn: Callable, x: torch.Tensor, sigmas, eta: float = 1.0,
                        s_noise: float = 1.0, draws: torch.Tensor | None = None,
                        seed: int = 0) -> torch.Tensor:
    """DPM-Solver++(3M) SDE; ``denoise_fn(x, sigma) -> x0`` with sigma a Python
    float.  ``sigmas`` is (n + 1,) ending in 0; the last step returns its
    denoised estimate, as in k-diffusion.  ``draws``: (n, *x.shape) standard
    normals for the SDE noise (``eta`` 0 needs none)."""
    sig = np.asarray(sigmas, np.float32)
    n = sig.shape[0] - 1
    if eta and draws is None:
        draws = sde_draws(n, tuple(x.shape), seed, x.device)
    if eta and tuple(draws.shape) != (n, *x.shape):
        raise ValueError(f"draws {tuple(draws.shape)}, expected {(n, *x.shape)}")
    d1 = d2 = None
    h1 = h2 = None
    for i in range(n):
        s_cur, s_next = sig[i], sig[i + 1]
        denoised = denoise_fn(x, float(s_cur))
        if s_next <= 0:
            # sigma_next == 0: the solution is the denoised estimate itself
            x = denoised
            break
        t, s = _F(-np.log(s_cur)), _F(-np.log(s_next))
        h = _F(s - t)
        h_eta = _F(h * _F(eta + 1.0))
        x_new = x * float(np.exp(-h_eta)) - denoised * float(np.expm1(-h_eta))
        phi_2 = _F(_F(np.expm1(-h_eta)) / h_eta + _F(1.0))
        if i >= 2:
            r0, r1 = _F(h1 / h), _F(h2 / h)
            d1_0 = (denoised - d1) / float(r0)
            d1_1 = (d1 - d2) / float(r1)
            d1c = d1_0 + (d1_0 - d1_1) * float(_F(r0 / _F(r0 + r1)))
            d2c = (d1_0 - d1_1) / float(_F(r0 + r1))
            phi_3 = _F(phi_2 / h_eta - _F(0.5))
            x_new = x_new + d1c * float(phi_2) - d2c * float(phi_3)
        elif i == 1:
            r0 = _F(h1 / h)
            x_new = x_new + ((denoised - d1) / float(r0)) * float(phi_2)
        if eta:
            amp = _F(s_next * _F(s_noise) * np.sqrt(-np.expm1(_F(_F(-2.0) * h * _F(eta)))))
            x_new = x_new + draws[i].to(x.dtype) * float(amp)
        x = x_new
        d1, d2 = denoised, d1
        h1, h2 = h, h1
    return x
