"""Precision policy of the port, as in the JAX package.

- fp32 matrix products and convolutions run in full fp32 on the card:
  TF32 is off for cuBLAS and cuDNN alike (the cuDNN default would put every
  fp32 convolution on TF32), and bf16 products reduce in fp32.
- ``matmul_precision("bfloat16")`` is the counterpart of
  ``jax.default_matmul_precision("bfloat16")``: inside it, the port's
  linear layers, einsums and convolutions given fp32 inputs round both
  operands to bf16, accumulate in fp32 and return the fp32 sum, unrounded.
  On the card linear layers and einsums run the bf16 GEMM with an fp32
  result (``torch.mm`` / ``torch.bmm`` with ``out_dtype``; an einsum is
  reshaped to one ``bmm``).  PyTorch has no bf16 convolution with an fp32
  result, so convolutions take the rounded operands through cuDNN's TF32
  convolution, TF32 allowed for that call only: a bf16 value is exact in
  TF32 and a product of two is exact in fp32, so this is the reference's
  function up to summation order, on the tensor cores (the fp32
  convolution computes the same on the CUDA cores, several times slower).
  On the CPU every op takes the rounded operands through its fp32 call
  (the CPU's own bf16 grouped convolution returns wrong results).  The
  setting is a context variable, scoped to the ``with`` block.
- Spectral code (STFT, iSTFT, mel) never consults it: it stays fp32.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

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


def _round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to the nearest bf16 value, kept in fp32."""
    return x.bfloat16().float()


@contextlib.contextmanager
def _tf32_convolutions():
    """cuDNN may take TF32 inside the block (the process keeps it off)."""
    allowed = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = allowed


def _conv(fn, x, weight, *args):
    """``fn(x, weight, None, *args)`` of fp32 operands under the policy (the
    flag is cuDNN's, so a CPU call is the fp32 call)."""
    with _tf32_convolutions():
        return fn(_round(x), _round(weight), None, *args)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) of fp32 operands under the policy, fp32 out."""
    if a.is_cuda:
        return torch.mm(a.bfloat16(), b.bfloat16(), out_dtype=torch.float32)
    return torch.mm(_round(a), _round(b))


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(g, m, k) @ (g, k, n) of fp32 operands under the policy, fp32 out."""
    if a.is_cuda:
        return torch.bmm(a.bfloat16(), b.bfloat16(), out_dtype=torch.float32)
    return torch.bmm(_round(a), _round(b))


def _einsum_as_bmm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A two-operand einsum as one ``bmm``: indices in both operands and the
    output are the batch, indices in both operands only are contracted, the
    rest are the rows of ``a`` and the columns of ``b``.  An index of one
    operand that the output drops must have size 1; repeated indices within
    an operand are not taken."""
    lhs, out = eq.replace(" ", "").split("->")
    ia, ib = lhs.split(",")
    if len(set(ia)) != len(ia) or len(set(ib)) != len(ib):
        raise ValueError(f"einsum {eq!r}: repeated index within an operand")
    for name, idx, x in (("a", ia, a), ("b", ib, b)):
        other = ib if name == "a" else ia
        for c in [c for c in idx if c not in other and c not in out]:
            if x.shape[idx.index(c)] != 1:
                raise ValueError(f"einsum {eq!r}: summed index {c!r} of size > 1")
    a = a.reshape([s for c, s in zip(ia, a.shape) if c in ib or c in out])
    b = b.reshape([s for c, s in zip(ib, b.shape) if c in ia or c in out])
    ia = "".join(c for c in ia if c in ib or c in out)
    ib = "".join(c for c in ib if c in ia or c in out)
    batch = [c for c in out if c in ia and c in ib]
    rows = [c for c in out if c in ia and c not in ib]
    cols = [c for c in out if c in ib and c not in ia]
    contr = [c for c in ia if c in ib and c not in out]
    size = {c: a.shape[ia.index(c)] for c in ia} | {c: b.shape[ib.index(c)] for c in ib}

    def prod(cs):
        return math.prod(size[c] for c in cs)

    am = a.permute([ia.index(c) for c in batch + rows + contr]).reshape(
        prod(batch), prod(rows), prod(contr))
    bm = b.permute([ib.index(c) for c in batch + contr + cols]).reshape(
        prod(batch), prod(contr), prod(cols))
    order = batch + rows + cols
    y = _bmm(am, bm).reshape([size[c] for c in order])
    return y.permute([order.index(c) for c in out])


def linear(x, weight, bias=None):
    if low_precision(x):
        y = _mm(x.reshape(-1, x.shape[-1]), weight.t()).reshape(*x.shape[:-1], -1)
        return y if bias is None else y + bias
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def einsum(eq: str, a, b):
    """Two-operand einsum under the policy (operands in ``a``'s type)."""
    if low_precision(a):
        return _einsum_as_bmm(eq, a, b.float())
    return torch.einsum(eq, a, b.to(a.dtype))


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    if low_precision(x):
        y = _conv(F.conv1d, x, weight, stride, padding, dilation, groups)
        return y if bias is None else y + bias[:, None]
    return F.conv1d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride, padding, dilation, groups)


def conv_transpose1d(x, weight, bias=None, stride=1, padding=0):
    if low_precision(x):
        y = _conv(F.conv_transpose1d, x, weight, stride, padding)
        return y if bias is None else y + bias[:, None]
    return F.conv_transpose1d(x, weight.to(x.dtype),
                              None if bias is None else bias.to(x.dtype), stride, padding)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    if low_precision(x):
        y = _conv(F.conv2d, x, weight, stride, padding, dilation, groups)
        return y if bias is None else y + bias[:, None, None]
    return F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride, padding, dilation, groups)


def conv_transpose2d(x, weight, bias=None, stride=1, padding=0):
    if low_precision(x):
        y = _conv(F.conv_transpose2d, x, weight, stride, padding)
        return y if bias is None else y + bias[:, None, None]
    return F.conv_transpose2d(x, weight.to(x.dtype),
                              None if bias is None else bias.to(x.dtype), stride, padding)


def matmul(a, b):
    """``a @ b`` (numpy broadcasting of the leading axes) under the policy."""
    if not low_precision(a):
        return torch.matmul(a, b.to(a.dtype))
    b = b.float()
    if b.dim() == 2:
        return _mm(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], b.shape[-1])
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return _bmm(a, b).reshape(*lead, a.shape[-2], b.shape[-1])


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


class Conv2d(torch.nn.Conv2d):
    """nn.Conv2d (NCHW) under the precision policy (same parameters and keys)."""

    def forward(self, x):
        if self.padding_mode != "zeros":
            raise ValueError("only zero padding")
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)


class ConvTranspose2d(torch.nn.ConvTranspose2d):
    """nn.ConvTranspose2d (NCHW) under the precision policy."""

    def forward(self, x):
        return conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding)
