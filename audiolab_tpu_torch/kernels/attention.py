"""Softmax attention over ``(batch, heads, seq, head_dim)``: the public
:func:`flash_attention` and the two hand-written CUDA kernels under it.

``flash_attention`` routes as the JAX package's does
(audiolab_tpu/kernels/attention.py): a non-causal call whose keys fit one
block goes to K1 (:func:`attention_nk1`), anything else to K2
(:func:`flash_attention_fwd`), and ``head_dim > 256`` to the plain
:func:`attention_reference`.  Two differences, both forced by the card:
K1 takes 16-bit inputs only (it runs on the tensor cores, and fp32 inputs
must keep fp32 products), so an fp32 single-block call goes to K2, which is
the same function; and K1 takes head dims 16/32/64/128, others go to K2.

Each kernel wrapper launches its kernel for a CUDA tensor and uses the
kernel's plain PyTorch version for a CPU tensor; there is no other route.
It counts its launches in a plain integer attribute (``.launches``).
The plain versions repeat each kernel's rounding points, so a CPU run
computes what the card computes up to summation order.
"""

from __future__ import annotations

import ctypes
import math

import torch

from audiolab_tpu_torch.kernels import _build

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_K1_HEAD_DIMS = (16, 32, 64, 128)
_K1_BLOCK_Q = 64   # query rows per CTA in csrc/attention.cu


def attention_reference(q, k, v, causal: bool = False, scale: float | None = None,
                        mask=None):
    """Plain softmax attention with the JAX package's semantics
    (attention.py:39-53): scores in the input type then fp32, the
    ``tril(k=tk-tq)`` causal mask, fp32 softmax, probabilities cast to v's
    type.  ``mask``: optional bool, broadcastable to (b, h, tq, tk)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        logits = torch.where(cmask, logits, torch.full_like(logits, _NEG_INF))
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def attention_nk1_reference(q, k, v, scale: float):
    """K1's plain version: q*scale rounded to the input type, fp32 scores,
    p = exp(s - rowmax) rounded to the input type, numerator and row sum
    from that p, output acc / l in the input type."""
    dt = q.dtype
    qs = q * torch.tensor(scale, dtype=dt)
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), k.float())
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)).to(dt).float()
    acc = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    l = p.sum(dim=-1, keepdim=True)
    return (acc / torch.where(l > 0, l, torch.ones_like(l))).to(dt)


def flash_attention_reference(q, k, v, causal: bool, scale: float):
    """K2's plain version: fp32 scores times scale, keys masked as the
    kernel masks them, row sum from the fp32 p, numerator from p rounded to
    v's type (the online rescaling is exact arithmetic and left out)."""
    tq, tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / torch.where(l > 0, l, torch.ones_like(l))).to(q.dtype)


def _check(name: str, q, k, v, dtypes) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q, k, v must be (b, h, t, d)")
    b, h, tq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match")
    if tq == 0 or k.shape[2] == 0:
        raise ValueError(f"{name}: empty sequence")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {q.dtype} not in {dtypes}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if q.is_cuda and not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.k1_attention_nk1.argtypes = [p, p, p, p, i, i, i, i, f, i, i, p]
        lib.k1_attention_nk1.restype = i
        lib.k2_flash_attention.argtypes = [p, p, p, p, i, i, i, i, f, i, i, p]
        lib.k2_flash_attention.restype = i
        lib._typed = True
    return lib


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def k1_slices_per_cta(bh: int, tq: int) -> int:
    """Slices one K1 CTA walks through: short sequences (one 64-row query
    tile) pack 8 slices per CTA so 44k band-axis slices are 5.5k CTAs."""
    return 8 if tq <= _K1_BLOCK_Q and bh >= 8 * 132 else 1


def attention_nk1(q, k, v, scale: float | None = None):
    """K1: non-causal attention over one key block, 16-bit inputs.
    CUDA tensors launch ``k1_attention_nk1``; CPU tensors take
    :func:`attention_nk1_reference`."""
    _check("attention_nk1", q, k, v, (torch.bfloat16, torch.float16))
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if not q.is_cuda:
        return attention_nk1_reference(q, k, v, scale)
    if d not in _K1_HEAD_DIMS:
        raise ValueError(f"attention_nk1: head dim {d} not in {_K1_HEAD_DIMS}")
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    out = torch.empty_like(q)
    # the TPU kernel multiplies by the scale rounded to the input type
    scale_dt = float(torch.tensor(scale, dtype=q.dtype))
    err = _lib().k1_attention_nk1(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, tq, tk, d,
        scale_dt, _DTYPE_CODE[q.dtype], k1_slices_per_cta(b * h, tq),
        torch.cuda.current_stream(q.device).cuda_stream)
    attention_nk1.launches += 1
    _raise_on(err, "attention_nk1")
    return out


attention_nk1.launches = 0


def flash_attention_fwd(q, k, v, causal: bool = False, scale: float | None = None):
    """K2: online-softmax attention over key tiles, fp32/bf16/fp16 inputs,
    head dim <= 256, optional causal mask with diagonal offset tk - tq.
    CUDA tensors launch ``k2_flash_attention``; CPU tensors take
    :func:`flash_attention_reference`.  A causal call with tq > tk leaves
    its first tq - tk rows, which see no key, undefined: the TPU kernel's
    value there depends on its block layout, and so does this kernel's."""
    _check("flash_attention_fwd", q, k, v, tuple(_DTYPE_CODE))
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal, scale)
    if d > 256:
        raise ValueError("flash_attention_fwd: head dim > 256")
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    out = torch.empty_like(q)
    err = _lib().k2_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, tq, tk, d,
        scale, int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_fwd.launches += 1
    _raise_on(err, "flash_attention_fwd")
    return out


flash_attention_fwd.launches = 0


def reset_launch_counts() -> None:
    attention_nk1.launches = 0
    flash_attention_fwd.launches = 0


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    block_q: int = 128, block_k: int = 128, block_h: int = 1):
    """Attention over ``(b, h, t, d)`` with the JAX package's signature.

    ``block_k`` decides the route as on the TPU: when every key fits one
    block (``tk <= block_k``) and the call is not causal, the single-block
    kernel K1 runs.  ``block_q`` and ``block_h`` were TPU tiling knobs; the
    CUDA kernels pick their own tiles and ignore them."""
    del block_q, block_h
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if d > 256:
        return attention_reference(q, k, v, causal=causal, scale=scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bk = min(block_k, max(8, tk))
    single_block = -(-tk // bk) == 1
    if (single_block and not causal and q.dtype in (torch.bfloat16, torch.float16)
            and d in _K1_HEAD_DIMS):
        return attention_nk1(q, k, v, scale=scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)
