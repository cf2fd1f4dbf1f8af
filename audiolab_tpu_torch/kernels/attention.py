"""Softmax attention over ``(batch, heads, seq, head_dim)``: the public
:func:`flash_attention`, the hand-written CUDA kernels under it, and the
two probe kernels of the JAX package's tools.

``flash_attention`` routes as the JAX package's does
(audiolab_tpu/kernels/attention.py): a non-causal call whose keys fit one
block goes to K1 (:func:`attention_nk1`), or to K3
(:func:`attention_nk1_rope`) when rope tables are given; anything else to
K2 (:func:`flash_attention_fwd`), with rope applied before it by
:func:`apply_rope_tables`; and ``head_dim > 256`` to the plain
:func:`attention_reference`.  Two differences, both forced by the card:
K1 and K3 take 16-bit inputs only (they run on the tensor cores, and fp32
inputs must keep fp32 products), so an fp32 single-block call goes to K2,
which is the same function; and they take head dims 16/32/64/128, others go
to K2.

K6 (:func:`slim_attention`, tools/probe_freq_bh128.py) and K7
(:func:`packed_attention`, tools/probe_packed_attn.py) are K1's function
with the row sum taken apart and with q/k/v read from the packed
``(b, t, heads*d)`` layout; nothing in the package calls them.

K1 has two CUDA designs, chosen by shape alone (:func:`k1_route`): the
Hopper design (TMA, wgmma, warp specialisation) for d = 64 and tk <= 768,
which covers both RoFormer axes, and the WMMA core for every other shape.
K6 and K7 run on the same two designs, because what held them back on the
WMMA core was the core (keys staged once per query tile by plain loads,
scores and p through shared memory), not their own functions:
K6 takes the Hopper band route with the row sum reduced from the rounded p
in registers and no ones-widened v (:func:`k6_route`: d = 64, 16-bit,
tq <= 64 and tk <= 64, 16-byte aligned bases); K7 takes the Hopper time route with 4-D tensor maps
over the packed rows, K and V resident per (batch, head) slice
(:func:`k7_route`: d = 64, 16-bit, t <= 768, rows TMA can address); every
other shape of either stays on its WMMA core variant.  K3 takes the Hopper
time route too, with K roped once a slice in shared memory and q per tile
(:func:`k3_route`: d = 64, 16-bit, tk <= 768, 16-byte aligned bases and
tables; a band-shaped call runs the same kernel over one chunk), else the
WMMA core's rope variant.  K2 runs a register-tiled fp32 kernel for fp32
inputs; for 16-bit inputs the Hopper design of its own (TMA ring, wgmma,
online softmax in registers) at d = 64 and 128 on 16-byte aligned bases
(:func:`k2_route`), else the row-per-thread-group kernel.  A route is chosen
before any launch and nothing gives way to another route after a failure.

Each kernel wrapper launches its kernel for a CUDA tensor and uses the
kernel's plain PyTorch version for a CPU tensor; there is no other route.
It counts its launches in a plain integer attribute (``.launches``), and
those on the Hopper design in ``.sm90_launches`` (K1, K2, K3, K6, K7).
The plain versions repeat each kernel's rounding points, so a CPU run
computes what the card computes up to summation order.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from audiolab_tpu_torch.kernels import _build

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_K1_HEAD_DIMS = (16, 32, 64, 128)
_K1_BLOCK_Q = 64   # query rows per CTA in csrc/attention.cu
_K1H_MAX_KEYS = 768  # the Hopper design keeps up to 12 64-key chunks resident
_K2H_HEAD_DIMS = (64, 128)  # one or two swizzled 64-column boxes a row
_HALF_TYPES = (torch.bfloat16, torch.float16)


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


def rope_tables(t: int, d: int, scale: float = 1.0):
    """(t, d) fp32 cos/sin tables for half-split rotary embedding,
    duplicated across the two halves, with ``scale`` folded in; the JAX
    package's ``rope_tables`` (attention.py:129), computed by the same numpy
    expressions and returned as CPU tensors."""
    half = d // 2
    freqs = 1.0 / (10000.0 ** (np.arange(0, half, dtype=np.float32) / half))
    ang = np.arange(t)[:, None] * freqs[None, :]
    cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32) * scale
    sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32) * scale
    return torch.from_numpy(cos), torch.from_numpy(sin)


def _table(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def apply_rope_tables(x, cos, sin):
    """Half-split rope on ``(..., t, d)`` from ``(t, d)`` tables (tensors or
    arrays): ``x*cos + rot(x)*sin`` in fp32, rounded to x's type once.
    ``rot`` swaps the two halves and negates the first, which is exactly the
    JAX package's ±1 rotate-half product (attention.py:263)."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * _table(cos, x.device) + rot * _table(sin, x.device)).to(x.dtype)


def attention_nk1_rope_reference(q, k, v, rope_cos, rope_sin, scale: float):
    """K3's plain version: the scale folded into q's tables in fp32, q and k
    roped by :func:`apply_rope_tables` (each rounded once), then K1's plain
    version with scale 1, so q is not rounded again."""
    tq, tk = q.shape[2], k.shape[2]
    cos, sin = _table(rope_cos, q.device), _table(rope_sin, q.device)
    qr = apply_rope_tables(q, cos[:tq] * scale, sin[:tq] * scale)
    kr = apply_rope_tables(k, cos[:tk], sin[:tk])
    return attention_nk1_reference(qr, kr, v, 1.0)


def packed_attention_reference(q, k, v, heads: int, dim_head: int, scale: float):
    """K7's plain version: q/k/v ``(b, t, heads*dim_head)`` split into heads,
    K1's plain version, and the heads packed back."""
    b, t = q.shape[0], q.shape[1]

    def heads_first(x):
        return x.reshape(b, t, heads, dim_head).transpose(1, 2)

    out = attention_nk1_reference(heads_first(q), heads_first(k), heads_first(v), scale)
    return out.transpose(1, 2).reshape(b, t, heads * dim_head)


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
        lib.k1_attention_nk1_sm90.argtypes = [p, p, p, p, i, i, i, f, i, i, p]
        lib.k1_attention_nk1_sm90.restype = i
        lib.k2_flash_attention.argtypes = [p, p, p, p, i, i, i, i, f, i, i, p]
        lib.k2_flash_attention.restype = i
        lib.k2_flash_attention_sm90.argtypes = [p, p, p, p, i, i, i, i, f, i, i, p]
        lib.k2_flash_attention_sm90.restype = i
        lib.k3_attention_nk1_rope.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, i, p]
        lib.k3_attention_nk1_rope.restype = i
        lib.k3_attention_nk1_rope_sm90.argtypes = [p, p, p, p, p, p, i, i, i, f, i, p]
        lib.k3_attention_nk1_rope_sm90.restype = i
        lib.k6_attention_slim.argtypes = [p, p, p, p, i, i, i, i, f, i, i, p]
        lib.k6_attention_slim.restype = i
        lib.k6_attention_slim_sm90.argtypes = [p, p, p, p, i, i, i, f, i, p]
        lib.k6_attention_slim_sm90.restype = i
        lib.k7_attention_packed_sm90.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
        lib.k7_attention_packed_sm90.restype = i
        lib.k7_attention_packed.argtypes = [p, p, p, p, i, i, i, i, i, f, i, p]
        lib.k7_attention_packed.restype = i
        lib._typed = True
    return lib


def _scale_in(dtype, scale: float) -> float:
    """The scale rounded to the input type: the TPU kernel multiplies q by
    it in that type."""
    return float(torch.tensor(scale, dtype=dtype))


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def k1_slices_per_cta(bh: int, tq: int) -> int:
    """Slices one K1 CTA walks through: short sequences (one 64-row query
    tile) pack 8 slices per CTA so 44k band-axis slices are 5.5k CTAs."""
    return 8 if tq <= _K1_BLOCK_Q and bh >= 8 * 132 else 1


def k1_route(bh: int, tq: int, tk: int, d: int, dtype) -> str:
    """Which K1 kernel a CUDA call of this shape launches, by shape alone:
    ``"band"`` or ``"time"`` for the Hopper design (d = 64, 16-bit,
    tk <= 768; band when tq and tk both fit one 64-row tile), ``"core"`` for
    the WMMA core (every other shape)."""
    del bh  # any number of slices: both designs are persistent
    if d != 64 or dtype not in (torch.bfloat16, torch.float16) or tk > _K1H_MAX_KEYS:
        return "core"
    return "band" if tq <= _K1_BLOCK_Q and tk <= _K1_BLOCK_Q else "time"


def _launch_k1_core(q, k, v, scale: float):
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    err = _lib().k1_attention_nk1(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, tq, k.shape[2], d,
        _scale_in(q.dtype, scale), _DTYPE_CODE[q.dtype], k1_slices_per_cta(b * h, tq),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out, err


def attention_nk1(q, k, v, scale: float | None = None):
    """K1: non-causal attention over one key block, 16-bit inputs.
    CUDA tensors launch ``k1_attention_nk1_sm90`` on the route
    :func:`k1_route` gives (counted in ``.sm90_launches`` too), or the
    WMMA core ``k1_attention_nk1``; CPU tensors take
    :func:`attention_nk1_reference`."""
    _check("attention_nk1", q, k, v, (torch.bfloat16, torch.float16))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if not q.is_cuda:
        return attention_nk1_reference(q, k, v, scale)
    if d not in _K1_HEAD_DIMS:
        raise ValueError(f"attention_nk1: head dim {d} not in {_K1_HEAD_DIMS}")
    route = k1_route(b * h, tq, tk, d, q.dtype)
    if route == "core":
        out, err = _launch_k1_core(q, k, v, scale)
    else:
        out = torch.empty_like(q)
        if not _aligned(q, k, v):
            raise ValueError("attention_nk1: TMA needs 16-byte aligned q, k, v")
        err = _lib().k1_attention_nk1_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, tq, tk,
            _scale_in(q.dtype, scale), _DTYPE_CODE[q.dtype],
            int(route == "band"), torch.cuda.current_stream(q.device).cuda_stream)
        attention_nk1.sm90_launches += 1
    attention_nk1.launches += 1
    _raise_on(err, "attention_nk1")
    return out


attention_nk1.launches = 0
attention_nk1.sm90_launches = 0


def attention_nk1_core(q, k, v, scale: float | None = None):
    """K1's function on the WMMA core whatever the shape: the yardstick the
    Hopper design is timed against.  The package routes through
    :func:`attention_nk1`; CPU tensors take :func:`attention_nk1_reference`."""
    _check("attention_nk1_core", q, k, v, (torch.bfloat16, torch.float16))
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if not q.is_cuda:
        return attention_nk1_reference(q, k, v, scale)
    if d not in _K1_HEAD_DIMS:
        raise ValueError(f"attention_nk1_core: head dim {d} not in {_K1_HEAD_DIMS}")
    out, err = _launch_k1_core(q, k, v, scale)
    attention_nk1_core.launches += 1
    _raise_on(err, "attention_nk1_core")
    return out


attention_nk1_core.launches = 0


def _aligned(*tensors) -> bool:
    """Every base on the 16-byte boundary TMA (and a 16-byte load) needs."""
    return not any(x.data_ptr() % 16 for x in tensors)


def k2_route(bh: int, tq: int, tk: int, d: int, dtype, causal: bool, aligned: bool) -> str:
    """Which K2 kernel a CUDA call of 16-bit or fp32 inputs launches, by
    shape, type and alignment alone: ``"sm90"`` for the Hopper design (16-bit,
    d = 64 or 128, q, k and v on 16-byte boundaries: ``aligned``), ``"core"``
    for the rest (fp32 inputs on the register-tiled kernel, other head dims
    and bases TMA cannot address on the row-per-thread-group kernel).  Any
    tq, tk and mask: short calls were measured on both and the Hopper design
    did not lose (PERF.md)."""
    del bh, tq, tk, causal
    if d not in _K2H_HEAD_DIMS or dtype not in _HALF_TYPES or not aligned:
        return "core"
    return "sm90"


def _launch_k2(entry: str, q, k, v, causal: bool, scale: float):
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    err = getattr(_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, tq, k.shape[2], d,
        scale, int(bool(causal)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    return out, err


def flash_attention_fwd(q, k, v, causal: bool = False, scale: float | None = None):
    """K2: online-softmax attention over key tiles, fp32/bf16/fp16 inputs,
    head dim <= 256, optional causal mask with diagonal offset tk - tq.
    CUDA tensors launch, by :func:`k2_route`, ``k2_flash_attention_sm90``
    (the Hopper design, counted in ``.sm90_launches`` too) or
    ``k2_flash_attention``; CPU tensors take
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
    bh = q.shape[0] * q.shape[1]
    route = k2_route(bh, q.shape[2], k.shape[2], d, q.dtype, causal, _aligned(q, k, v))
    # the Hopper kernel takes the row max over the raw scores, which is the
    # max of the scaled ones only for a scale that is not negative
    if route == "sm90" and scale >= 0:
        out, err = _launch_k2("k2_flash_attention_sm90", q, k, v, causal, scale)
        flash_attention_fwd.sm90_launches += 1
    else:
        out, err = _launch_k2("k2_flash_attention", q, k, v, causal, scale)
    flash_attention_fwd.launches += 1
    _raise_on(err, "flash_attention_fwd")
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.sm90_launches = 0


def flash_attention_fwd_core(q, k, v, causal: bool = False, scale: float | None = None):
    """K2's function for 16-bit inputs on the row-per-thread-group kernel
    whatever the shape: the yardstick the Hopper design is timed against.
    The package routes through :func:`flash_attention_fwd`; CPU tensors take
    :func:`flash_attention_reference`."""
    _check("flash_attention_fwd_core", q, k, v, _HALF_TYPES)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if not q.is_cuda:
        return flash_attention_reference(q, k, v, causal, scale)
    if d > 256:
        raise ValueError("flash_attention_fwd_core: head dim > 256")
    out, err = _launch_k2("k2_flash_attention", q, k, v, causal, scale)
    flash_attention_fwd_core.launches += 1
    _raise_on(err, "flash_attention_fwd_core")
    return out


flash_attention_fwd_core.launches = 0


def _rope_tables_for(name: str, rope_cos, rope_sin, t: int, d: int, device):
    """The tables as fp32 tensors on ``device``; at least ``t`` rows of width
    ``d``, of which only the first ``t`` are used."""
    if rope_cos is None or rope_sin is None:
        raise ValueError(f"{name}: rope_cos and rope_sin are given together")
    cos, sin = _table(rope_cos, device), _table(rope_sin, device)
    for tab in (cos, sin):
        if tab.dim() != 2 or tab.shape[1] != d or tab.shape[0] < t:
            raise ValueError(f"{name}: rope table of shape {tuple(tab.shape)}; needs at "
                             f"least {t} rows of width {d}")
    return cos.contiguous(), sin.contiguous()


def k3_route(bh: int, tq: int, tk: int, d: int, dtype, aligned: bool) -> str:
    """Which K3 kernel a CUDA call launches, by shape and alignment alone:
    ``"time"`` for the rope variant of K1's Hopper time design (d = 64,
    16-bit, tk <= 768, and q, k, v and both tables on 16-byte boundaries:
    ``aligned``), ``"core"`` for the WMMA core's rope variant (everything
    else).  A band-shaped call (tq and tk within one 64-row tile) takes the
    time design over one chunk: there is no rope variant of the band
    kernel."""
    if not aligned or k1_route(bh, tq, tk, d, dtype) == "core":
        return "core"
    return "time"


def _launch_k3_core(q, k, v, cos, sin, scale: float):
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    err = _lib().k3_attention_nk1_rope(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), b * h, tq, k.shape[2], d, scale, _DTYPE_CODE[q.dtype],
        k1_slices_per_cta(b * h, tq), torch.cuda.current_stream(q.device).cuda_stream)
    return out, err


def attention_nk1_rope(q, k, v, rope_cos, rope_sin, scale: float | None = None):
    """K3: K1 with half-split rope fused onto q and k, 16-bit inputs;
    ``rope_cos``/``rope_sin`` are tables from :func:`rope_tables` without the
    scale, with at least max(tq, tk) rows.  CUDA tensors launch, by
    :func:`k3_route`, ``k3_attention_nk1_rope_sm90`` (the rope variant of the
    Hopper time design, counted in ``.sm90_launches`` too) or the WMMA core
    ``k3_attention_nk1_rope``; CPU tensors take
    :func:`attention_nk1_rope_reference`."""
    _check("attention_nk1_rope", q, k, v, _HALF_TYPES)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    cos, sin = _rope_tables_for("attention_nk1_rope", rope_cos, rope_sin, max(tq, tk), d,
                                q.device)
    if not q.is_cuda:
        return attention_nk1_rope_reference(q, k, v, cos, sin, scale)
    if d not in _K1_HEAD_DIMS:
        raise ValueError(f"attention_nk1_rope: head dim {d} not in {_K1_HEAD_DIMS}")
    if k3_route(b * h, tq, tk, d, q.dtype, _aligned(q, k, v, cos, sin)) == "time":
        out = torch.empty_like(q)
        err = _lib().k3_attention_nk1_rope_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), b * h, tq, tk, scale, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
        attention_nk1_rope.sm90_launches += 1
    else:
        out, err = _launch_k3_core(q, k, v, cos, sin, scale)
    attention_nk1_rope.launches += 1
    _raise_on(err, "attention_nk1_rope")
    return out


attention_nk1_rope.launches = 0
attention_nk1_rope.sm90_launches = 0


def attention_nk1_rope_core(q, k, v, rope_cos, rope_sin, scale: float | None = None):
    """K3's function on the WMMA core whatever the shape: the yardstick the
    Hopper time design is timed against.  The package routes through
    :func:`attention_nk1_rope`; CPU tensors take
    :func:`attention_nk1_rope_reference`."""
    name = "attention_nk1_rope_core"
    _check(name, q, k, v, _HALF_TYPES)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    cos, sin = _rope_tables_for(name, rope_cos, rope_sin, max(q.shape[2], k.shape[2]), d,
                                q.device)
    if not q.is_cuda:
        return attention_nk1_rope_reference(q, k, v, cos, sin, scale)
    if d not in _K1_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {_K1_HEAD_DIMS}")
    out, err = _launch_k3_core(q, k, v, cos, sin, scale)
    attention_nk1_rope_core.launches += 1
    _raise_on(err, name)
    return out


attention_nk1_rope_core.launches = 0


def k6_route(bh: int, tq: int, tk: int, d: int, dtype, aligned: bool) -> str:
    """Which K6 kernel a CUDA call launches, by shape and alignment alone:
    ``"band"`` for the Hopper band design (d = 64, 16-bit, tq and tk both
    within one 64-row tile, q, k and v on the 16-byte boundaries TMA needs:
    ``aligned``), ``"core"`` for the WMMA core (everything else)."""
    return "band" if aligned and k1_route(bh, tq, tk, d, dtype) == "band" else "core"


def _launch_k6_core(q, k, v, scale: float):
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    err = _lib().k6_attention_slim(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, tq, k.shape[2], d,
        _scale_in(q.dtype, scale), _DTYPE_CODE[q.dtype], 2 * k1_slices_per_cta(b * h, tq),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out, err


def _launch_k6_band(q, k, v, scale: float):
    b, h, tq, _ = q.shape
    out = torch.empty_like(q)
    err = _lib().k6_attention_slim_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, tq, k.shape[2],
        _scale_in(q.dtype, scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    return out, err


def slim_attention(q, k, v, scale: float | None = None):
    """K6: K1's function with the row sum a separate fp32 reduction over the
    rounded p and no ones-widened v, 16-bit inputs, no causal mask.  Its
    plain version is :func:`attention_nk1_reference`, which sums p that way.
    CUDA tensors launch, by :func:`k6_route`, ``k6_attention_slim_sm90``
    (the Hopper band design, counted in ``.sm90_launches`` too) or the WMMA
    core ``k6_attention_slim`` with twice K1's slices per CTA.  The probe's
    question, a fold of 128 slices per TPU grid step against K1's 64, is on
    this card the number of slices the band design keeps in flight; depths
    of 4 to 9 measured alike, so it keeps K1's."""
    _check("slim_attention", q, k, v, (torch.bfloat16, torch.float16))
    b, h, tq, d = q.shape
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if not q.is_cuda:
        return attention_nk1_reference(q, k, v, scale)
    if d not in _K1_HEAD_DIMS:
        raise ValueError(f"slim_attention: head dim {d} not in {_K1_HEAD_DIMS}")
    aligned = _aligned(q, k, v)
    if k6_route(b * h, tq, k.shape[2], d, q.dtype, aligned) == "band":
        out, err = _launch_k6_band(q, k, v, scale)
        slim_attention.sm90_launches += 1
    else:
        out, err = _launch_k6_core(q, k, v, scale)
    slim_attention.launches += 1
    _raise_on(err, "slim_attention")
    return out


slim_attention.launches = 0
slim_attention.sm90_launches = 0


def slim_attention_core(q, k, v, scale: float | None = None):
    """K6's function on the WMMA core whatever the shape: the yardstick the
    Hopper band design is timed against.  The package routes through
    :func:`slim_attention`; CPU tensors take :func:`attention_nk1_reference`."""
    _check("slim_attention_core", q, k, v, (torch.bfloat16, torch.float16))
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if not q.is_cuda:
        return attention_nk1_reference(q, k, v, scale)
    if q.shape[-1] not in _K1_HEAD_DIMS:
        raise ValueError(f"slim_attention_core: head dim {q.shape[-1]} not in {_K1_HEAD_DIMS}")
    out, err = _launch_k6_core(q, k, v, scale)
    slim_attention_core.launches += 1
    _raise_on(err, "slim_attention_core")
    return out


slim_attention_core.launches = 0


def k7_route(b: int, heads: int, t: int, d: int, ld: int, dtype, aligned: bool) -> str:
    """Which K7 kernel a CUDA call launches, by shape, stride and alignment
    alone: ``"time"`` for the Hopper time design (d = 64, 16-bit, t <= 768,
    and rows TMA can address: q, k and v on 16-byte boundaries (``aligned``)
    with a row stride ``ld`` (elements) whose bytes are a multiple of 16),
    ``"core"`` for the WMMA core's packed variant (everything else)."""
    del b, heads  # any number of slices: both designs walk them
    if d != 64 or dtype not in (torch.bfloat16, torch.float16) or t > _K1H_MAX_KEYS:
        return "core"
    return "time" if aligned and (2 * ld) % 16 == 0 else "core"


def _packed_check(name: str, q, k, v, heads: int, dim_head: int) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one (b, t, heads*dim_head) shape")
    b, t, inner = q.shape
    if inner != heads * dim_head or b == 0 or t == 0:
        raise ValueError(f"{name}: shape {tuple(q.shape)} is not (b, t, {heads}*{dim_head})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"{name}: dtype {q.dtype} not in (bfloat16, float16)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")


def _packed_cuda_check(name: str, q, k, v, dim_head: int) -> int:
    """The row stride (elements) of CUDA q/k/v the kernels can walk."""
    if dim_head not in _K1_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {dim_head} not in {_K1_HEAD_DIMS}")
    ld = q.stride(1)
    if (any(x.stride() != q.stride() for x in (k, v)) or q.stride(2) != 1
            or q.stride(0) != q.shape[1] * ld):
        raise ValueError(f"{name}: the kernel takes rows of one stride with a unit last "
                         f"axis; got strides {q.stride()}, {k.stride()}, {v.stride()}")
    return ld


def _launch_k7_core(q, k, v, heads: int, dim_head: int, ld: int, scale: float):
    b, t, inner = q.shape
    out = torch.empty(b, t, inner, dtype=q.dtype, device=q.device)
    err = _lib().k7_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads, t, dim_head, ld,
        _scale_in(q.dtype, scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    return out, err


def _launch_k7_time(q, k, v, out, heads: int, ld: int, scale: float) -> int:
    """The Hopper time design on packed rows, into ``out``: ``(b, t, heads*64)``
    contiguous and written only at rows below t of each batch."""
    b, t, _ = q.shape
    return _lib().k7_attention_packed_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads, t, ld,
        _scale_in(q.dtype, scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)


def packed_attention(q, k, v, heads: int, dim_head: int, scale: float | None = None):
    """K7: K1's function on already-roped q/k/v in the packed
    ``(b, t, heads*dim_head)`` layout, output in the same layout, 16-bit
    inputs.  The rows may be strided (a view of a fused qkv activation):
    the last axis must be unit-stride and q, k, v must share their strides.
    CUDA tensors launch, by :func:`k7_route`, ``k7_attention_packed_sm90``
    (the Hopper time design over 4-D tensor maps of the packed rows, counted
    in ``.sm90_launches`` too) or the WMMA core ``k7_attention_packed``; CPU
    tensors take :func:`packed_attention_reference`."""
    name = "packed_attention"
    _packed_check(name, q, k, v, heads, dim_head)
    b, t, inner = q.shape
    scale = 1.0 / math.sqrt(dim_head) if scale is None else float(scale)
    if not q.is_cuda:
        return packed_attention_reference(q, k, v, heads, dim_head, scale)
    ld = _packed_cuda_check(name, q, k, v, dim_head)
    aligned = _aligned(q, k, v)
    if k7_route(b, heads, t, dim_head, ld, q.dtype, aligned) == "time":
        out = torch.empty(b, t, inner, dtype=q.dtype, device=q.device)
        err = _launch_k7_time(q, k, v, out, heads, ld, scale)
        packed_attention.sm90_launches += 1
    else:
        out, err = _launch_k7_core(q, k, v, heads, dim_head, ld, scale)
    packed_attention.launches += 1
    _raise_on(err, name)
    return out


packed_attention.launches = 0
packed_attention.sm90_launches = 0


def packed_attention_core(q, k, v, heads: int, dim_head: int, scale: float | None = None):
    """K7's function on the WMMA core whatever the shape: the yardstick the
    Hopper time design is timed against.  The package routes through
    :func:`packed_attention`; CPU tensors take
    :func:`packed_attention_reference`."""
    name = "packed_attention_core"
    _packed_check(name, q, k, v, heads, dim_head)
    scale = 1.0 / math.sqrt(dim_head) if scale is None else float(scale)
    if not q.is_cuda:
        return packed_attention_reference(q, k, v, heads, dim_head, scale)
    ld = _packed_cuda_check(name, q, k, v, dim_head)
    out, err = _launch_k7_core(q, k, v, heads, dim_head, ld, scale)
    packed_attention_core.launches += 1
    _raise_on(err, name)
    return out


packed_attention_core.launches = 0


def reset_launch_counts() -> None:
    attention_nk1.launches = 0
    attention_nk1.sm90_launches = 0
    attention_nk1_core.launches = 0
    flash_attention_fwd.launches = 0
    flash_attention_fwd.sm90_launches = 0
    flash_attention_fwd_core.launches = 0
    attention_nk1_rope.launches = 0
    attention_nk1_rope.sm90_launches = 0
    attention_nk1_rope_core.launches = 0
    slim_attention.launches = 0
    slim_attention.sm90_launches = 0
    slim_attention_core.launches = 0
    packed_attention.launches = 0
    packed_attention.sm90_launches = 0
    packed_attention_core.launches = 0


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None,
                    block_q: int = 128, block_k: int = 128, block_h: int = 1,
                    rope_cos=None, rope_sin=None):
    """Attention over ``(b, h, t, d)`` with the JAX package's signature.

    ``block_k`` decides the route as on the TPU: when every key fits one
    block (``tk <= block_k``) and the call is not causal, the single-block
    kernel K1 runs, or K3 with rope.  ``block_q`` and ``block_h`` were TPU
    tiling knobs; the CUDA kernels pick their own tiles and ignore them.

    ``rope_cos``/``rope_sin``: optional tables from :func:`rope_tables`
    WITHOUT the scale, with at least max(tq, tk) rows (the first tq rope q,
    the first tk rope k).  K3 fuses the rope and folds the scale into q's
    tables; every other route applies :func:`apply_rope_tables` to q and k
    first and keeps the scale where it was."""
    del block_q, block_h
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    bk = min(block_k, max(8, tk))
    single_block = -(-tk // bk) == 1
    nk1 = (single_block and not causal and q.dtype in (torch.bfloat16, torch.float16)
           and d in _K1_HEAD_DIMS)
    has_rope = rope_cos is not None or rope_sin is not None
    if has_rope:
        cos, sin = _rope_tables_for("flash_attention", rope_cos, rope_sin, max(tq, tk), d,
                                    q.device)
        if nk1:
            return attention_nk1_rope(q.contiguous(), k.contiguous(), v.contiguous(), cos,
                                      sin, scale=scale)
        q = apply_rope_tables(q, cos[:tq], sin[:tq])
        k = apply_rope_tables(k, cos[:tk], sin[:tk])
    if d > 256:
        return attention_reference(q, k, v, causal=causal, scale=scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if nk1:
        return attention_nk1(q, k, v, scale=scale)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)
