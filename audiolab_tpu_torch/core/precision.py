"""Precision policy of the port, as in the JAX package.

- fp32 matrix products and convolutions run in full fp32 on the card:
  TF32 is off for cuBLAS and cuDNN alike (the cuDNN default would put every
  fp32 convolution on TF32), and bf16 products reduce in fp32.
- ``matmul_precision("bfloat16")`` is the counterpart of
  ``jax.default_matmul_precision("bfloat16")``: inside it, the port's
  linear layers and convolutions given fp32 inputs round both operands to
  bf16 and accumulate in fp32 (cuBLAS/cuDNN return the product in bf16,
  which is widened back to fp32 before the bias).  The setting is a
  context variable, scoped to the ``with`` block.
- Spectral code (STFT, iSTFT, mel) never consults it: it stays fp32.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F

_LOW = contextvars.ContextVar("audiolab_tpu_torch_matmul_bf16", default=False)


def apply_policy() -> None:
    """Turn TF32 off and keep bf16 reductions in fp32 (process-wide torch
    flags; the entry points call this)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


@contextlib.contextmanager
def matmul_precision(name: str | None):
    """``"bfloat16"`` rounds fp32 operands to bf16; ``"highest"``,
    ``"float32"`` or None keep fp32."""
    if name not in (None, "bfloat16", "highest", "float32"):
        raise ValueError(f"unknown matmul precision {name!r}")
    token = _LOW.set(name == "bfloat16")
    try:
        yield
    finally:
        _LOW.reset(token)


def low_precision(x: torch.Tensor) -> bool:
    return _LOW.get() and x.dtype == torch.float32


def _bf16(fn, x, weight, *args):
    """``fn(x, weight, *args)`` with both operands rounded to bf16, the sum
    taken in fp32 and the result rounded to bf16, returned as fp32.  On the
    card the library runs the bf16 call itself (fp32 accumulation, bf16
    result); on the CPU the rounded operands go through the fp32 call, since
    the CPU's bf16 grouped convolution returns wrong results."""
    if x.is_cuda:
        return fn(x.bfloat16(), weight.bfloat16(), *args).float()
    y = fn(x.bfloat16().float(), weight.bfloat16().float(), *args)
    return y.bfloat16().float()


def linear(x, weight, bias=None):
    if low_precision(x):
        y = _bf16(F.linear, x, weight)
        return y if bias is None else y + bias
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def einsum(eq: str, a, b):
    """Two-operand einsum under the policy (operands in ``a``'s type)."""
    if low_precision(a):
        return _bf16(lambda x, y: torch.einsum(eq, x, y), a, b)
    return torch.einsum(eq, a, b.to(a.dtype))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    if low_precision(x):
        y = _bf16(F.conv1d, x, weight, None, stride, padding, dilation, groups)
        return y if bias is None else y + bias[:, None]
    return F.conv1d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride, padding, dilation, groups)


def conv_transpose1d(x, weight, bias=None, stride=1, padding=0):
    if low_precision(x):
        y = _bf16(F.conv_transpose1d, x, weight, None, stride, padding)
        return y if bias is None else y + bias[:, None]
    return F.conv_transpose1d(x, weight.to(x.dtype),
                              None if bias is None else bias.to(x.dtype), stride, padding)


class Linear(torch.nn.Linear):
    """nn.Linear under the precision policy (same parameters and keys)."""

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv1d(torch.nn.Conv1d):
    """nn.Conv1d (NCT) under the precision policy (same parameters and keys)."""

    def forward(self, x):
        if self.padding_mode != "zeros":
            raise ValueError("only zero padding")
        return conv1d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)


class ConvTranspose1d(torch.nn.ConvTranspose1d):
    """nn.ConvTranspose1d (NCT) under the precision policy."""

    def forward(self, x):
        return conv_transpose1d(x, self.weight, self.bias, self.stride, self.padding)
