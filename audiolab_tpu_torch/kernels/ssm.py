"""Selective-state-space (Mamba-style) scan and causal depthwise convolution
(counterpart of audiolab_tpu/kernels/ssm.py, which is plain XLA, not Pallas).

The recurrence

    h_t = exp(delta_t A) * h_{t-1} + delta_t B_t x_t,    y_t = C_t . h_t + D x_t

runs as a log-depth (Hillis-Steele) scan over t in PyTorch ops: ceil(log2 t)
passes of the combine (a1, s1), (a2, s2) -> (a1 a2, s1 a2 + s2) over
(b, t, d_inner, d_state) panels, so prefill launches O(log t) kernels and no
loop runs per token.  The JAX package's ``lax.associative_scan`` combines
in another order, so the two agree to fp32 rounding (1e-5 relative in the
tests), not bit for bit.  ``ssm_step`` and ``causal_conv1d_step`` serve the
decode step.  Layouts are the JAX package's: activations (b, t, channels),
depthwise kernels (k, channels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def scan_states(da: torch.Tensor, dbu: torch.Tensor) -> torch.Tensor:
    """Every state of h_t = da_t * h_{t-1} + dbu_t (h_{-1} = 0) along dim 1."""
    a, s = da, dbu
    t = a.shape[1]
    off = 1
    while off < t:
        s = torch.cat([s[:, :off], s[:, :-off] * a[:, off:] + s[:, off:]], dim=1)
        if 2 * off < t:
            a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return s


def selective_scan(u, delta, a, b, c, d, return_state: bool = False):
    """Full-sequence selective scan.

    u, delta (b, t, d_inner); a (d_inner, d_state), negative; b, c
    (b, t, d_state); d (d_inner,).  Returns y (b, t, d_inner), and with
    ``return_state`` also the last state h_T (b, d_inner, d_state)."""
    da = torch.exp(delta[..., None] * a[None, None])         # (b, t, d, n)
    dbu = (delta * u)[..., None] * b[:, :, None, :]
    h = scan_states(da, dbu)
    y = torch.einsum("btdn,btn->btd", h, c) + u * d[None, None, :]
    return (y, h[:, -1]) if return_state else y


def ssm_step(h, u_t, delta_t, a, b_t, c_t, d):
    """One decode step: h (b, d_inner, d_state), u_t and delta_t
    (b, d_inner), b_t and c_t (b, d_state).  Returns (new state, y_t)."""
    da = torch.exp(delta_t[..., None] * a[None])
    dbu = (delta_t * u_t)[..., None] * b_t[:, None, :]
    h = h * da + dbu
    y = torch.einsum("bdn,bn->bd", h, c_t) + u_t * d[None]
    return h, y


def causal_conv1d(x, weight, bias=None):
    """Depthwise causal convolution: x (b, t, c), weight (k, c), bias (c,)."""
    k, ch = weight.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))
    return F.conv1d(xp, weight.t()[:, None, :], bias, groups=ch).transpose(1, 2)


def causal_conv1d_step(cache, x_t, weight, bias=None):
    """Single-token causal convolution with the rolled cache (b, k - 1, c);
    returns (new cache, y_t)."""
    window = torch.cat([cache, x_t[:, None, :]], dim=1)     # (b, k, c)
    y = torch.einsum("bkc,kc->bc", window, weight)
    if bias is not None:
        y = y + bias
    return window[:, 1:, :], y
