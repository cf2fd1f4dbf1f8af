"""Products of the plain reference: fp32 with TF32 off, or a lower precision
for the control.

Every matrix product and convolution of the reference models goes through
this module.  By default the operands stay fp32 and cuBLAS and cuDNN take
no TF32 (the caller turns the flags off, see :func:`fp32_flags`).  Inside
:func:`lowered` the operands are first rounded to a lower format (the
control of the comparison that decides ``correct``): ``"fp8"`` rounds each
operand to float8 e4m3 under a per-tensor scale (its absolute maximum
mapped to 448, as fp8 inference does), the sums stay fp32.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_LOWER = contextvars.ContextVar("benchmark_reference_lower", default=None)
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_flags(tf32: bool = False):
    """cuBLAS and cuDNN in full fp32 (``tf32=False``) or in TF32 inside the
    block; the flags are restored after it."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@contextlib.contextmanager
def lowered(fmt: str | None):
    """Round every product's operands to ``fmt`` (None or ``"fp8"``) inside
    the block."""
    if fmt not in (None, "fp8"):
        raise ValueError(f"unknown format {fmt!r}")
    token = _LOWER.set(fmt)
    try:
        yield
    finally:
        _LOWER.reset(token)


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the product sees it: itself, or rounded to the control's
    format and brought back to fp32."""
    if _LOWER.get() is None or not x.is_floating_point():
        return x
    x = x.float()
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def linear(x, weight, bias=None):
    y = F.linear(q(x), q(weight))
    return y if bias is None else y + bias


def einsum(eq: str, a, b):
    return torch.einsum(eq, q(a), q(b))


def matmul(a, b):
    return torch.matmul(q(a), q(b))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return F.conv1d(q(x), q(weight), bias, stride, padding, dilation, groups)


def conv_transpose1d(x, weight, bias=None, stride=1, padding=0, output_padding=0):
    return F.conv_transpose1d(q(x), q(weight), bias, stride, padding, output_padding)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    return F.conv2d(q(x), q(weight), bias, stride, padding, dilation, groups)


def conv_transpose2d(x, weight, bias=None, stride=1, padding=0, output_padding=0):
    return F.conv_transpose2d(q(x), q(weight), bias, stride, padding, output_padding)


class Linear(torch.nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv1d(torch.nn.Conv1d):
    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)


class ConvTranspose1d(torch.nn.ConvTranspose1d):
    def forward(self, x):
        return conv_transpose1d(x, self.weight, self.bias, self.stride, self.padding)


class Conv2d(torch.nn.Conv2d):
    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)
