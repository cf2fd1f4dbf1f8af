"""RMSNorm (K4) and LayerNorm (K5) over the last axis: the port's
counterparts of audiolab_tpu/kernels/norms.py's ``rms_norm`` and
``layer_norm``, each a hand-written CUDA kernel (csrc/norms.cu).

Both compute in fp32 and return x's type.  A CUDA tensor launches the
kernel for any last axis up to :data:`MAX_D` (the TPU path ran its kernel
only when d % 128 == 0, a lane rule the card does not have) and raises
above it; a CPU tensor takes the plain version.  Each wrapper counts its
launches in ``.launches``.  Neither has a backward: a call that autograd
would have to go through raises (nothing on the port's paths trains
through them).
"""

from __future__ import annotations

import ctypes

import torch

from audiolab_tpu_torch.kernels import _build

MAX_D = 4096   # one warp holds a row in registers: 32 lanes x 128 values
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rms_norm_reference(x, weight, eps: float = 1e-5):
    """K4's plain version, the JAX fallback's formula (norms.py:62-64)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm_reference(x, weight, bias, eps: float = 1e-5):
    """K5's plain version, the JAX fallback's formula (norms.py:92-96): the
    variance is the mean of the centred square."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * weight.float() + bias.float()).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("norms")
    if not getattr(lib, "_typed", False):
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.k4_rms_norm.argtypes = [p, p, p, ll, i, f, i, p]
        lib.k4_rms_norm.restype = i
        lib.k5_layer_norm.argtypes = [p, p, p, p, ll, i, f, i, p]
        lib.k5_layer_norm.restype = i
        lib._typed = True
    return lib


def _check(name: str, x, params) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not in {tuple(_DTYPE_CODE)}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"{name}: x needs a non-empty last axis")
    d = x.shape[-1]
    for prm in params:
        if tuple(prm.shape) != (d,):
            raise ValueError(f"{name}: parameter of shape {tuple(prm.shape)}, expected ({d},)")
        if prm.device != x.device:
            raise ValueError(f"{name}: x and its parameters on different devices")
    if x.is_cuda and d > MAX_D:
        raise ValueError(f"{name}: last axis {d} above the kernel's limit {MAX_D}")


def _launch(wrapper, entry, x, params, eps: float):
    """Launches ``entry`` on a contiguous x and fp32 parameters and counts
    the launch on ``wrapper``; an x with no rows launches nothing."""
    x2 = x.contiguous()
    out = torch.empty_like(x2)
    rows = x2.numel() // x2.shape[-1]
    if rows == 0:
        return out
    prms = [prm.float().contiguous() for prm in params]
    err = entry(x2.data_ptr(), *[prm.data_ptr() for prm in prms], out.data_ptr(), rows,
                x2.shape[-1], float(eps), _DTYPE_CODE[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    wrapper.launches += 1
    if err:
        raise RuntimeError(f"{wrapper.__name__}: CUDA launch failed with cudaError {err}")
    return out


def rms_norm(x, weight, eps: float = 1e-5):
    """K4: x * rsqrt(mean(x^2) + eps) * weight over the last axis.  CUDA
    tensors launch ``k4_rms_norm``; CPU tensors take
    :func:`rms_norm_reference`."""
    _check("rms_norm", x, (weight,))
    _build.no_grad_only("rms_norm", x, weight)
    if not x.is_cuda:
        return rms_norm_reference(x, weight, eps)
    return _launch(rms_norm, _lib().k4_rms_norm, x, (weight,), eps)


rms_norm.launches = 0


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """K5: (x - mu) * rsqrt(var + eps) * weight + bias over the last axis.
    CUDA tensors launch ``k5_layer_norm``; CPU tensors take
    :func:`layer_norm_reference`."""
    _check("layer_norm", x, (weight, bias))
    _build.no_grad_only("layer_norm", x, weight, bias)
    if not x.is_cuda:
        return layer_norm_reference(x, weight, bias, eps)
    return _launch(layer_norm, _lib().k5_layer_norm, x, (weight, bias), eps)


layer_norm.launches = 0


def reset_launch_counts() -> None:
    rms_norm.launches = 0
    layer_norm.launches = 0
