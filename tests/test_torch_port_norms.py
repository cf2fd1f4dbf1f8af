"""Parity of the port's RMSNorm (K4) and LayerNorm (K5)
(audiolab_tpu_torch/kernels/norms.py) with the JAX package's, on the CPU.

- ``rms_norm``/``layer_norm`` against the JAX public functions (their
  off-TPU path), fp32 and bf16, at last axes that are and are not a
  multiple of 128.
- The plain versions (what the CPU wrappers run) against the Pallas
  kernels ``_rmsnorm_kernel``/``_layernorm_kernel`` in interpret mode.
Tolerances: fp32 1e-5 of max|out| (fp32 sums in another order); bf16 1
bf16 ulp of max|out|, taken as 2**-7 of it (one rounding of fp32 values
that differ in their last bits).  The CUDA kernels are checked on the card
by tests/test_torch_port_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audiolab_tpu.kernels import norms as JN
from audiolab_tpu_torch.kernels import norms as TN


def _tol(ref, dtype):
    return (1e-5 if dtype == "float32" else 2.0 ** -7) * np.abs(ref).max()


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (2.0 + rng.standard_normal(shape)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [96, 256, 512])
def test_norms_match_jax(kind, dtype, d):
    x, w, b = _inputs(d, (3, 5, d))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    if kind == "rms":
        ref, out = JN.rms_norm(jx, jnp.asarray(w)), TN.rms_norm(tx, tw)
    else:
        ref, out = JN.layer_norm(jx, jnp.asarray(w), jnp.asarray(b)), TN.layer_norm(tx, tw, tb)
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    np.testing.assert_allclose(out.float().numpy(), ref, atol=_tol(ref, dtype), rtol=0)


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_plain_matches_pallas_kernel(kind, dtype):
    """The plain versions vs the TPU kernels in interpret mode at (64, 256),
    16-row tiles as ``_row_tiles`` would cut them smaller."""
    rows, d, tile = 64, 256, 16
    x, w, b = _inputs(7, (rows, d))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    row = pl.BlockSpec((tile, d), lambda i: (i, 0))
    vec = pl.BlockSpec((d,), lambda i: (0,))
    kernel = JN._rmsnorm_kernel if kind == "rms" else JN._layernorm_kernel
    params = (w,) if kind == "rms" else (w, b)
    ref = pl.pallas_call(
        functools.partial(kernel, eps=1e-5),
        out_shape=jax.ShapeDtypeStruct((rows, d), jx.dtype), grid=(rows // tile,),
        in_specs=[row] + [vec] * len(params), out_specs=row, interpret=True,
    )(jx, *map(jnp.asarray, params))
    ref = np.asarray(ref.astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tp = [torch.from_numpy(p) for p in params]
    out = (TN.rms_norm_reference(tx, *tp) if kind == "rms"
           else TN.layer_norm_reference(tx, *tp))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=_tol(ref, dtype), rtol=0)


def test_layer_norm_takes_the_centred_variance():
    """A large common offset: E[x^2] - mu^2 would lose the variance to
    cancellation in fp32, the centred form keeps it."""
    x = (1e4 + torch.linspace(-1, 1, 256)).reshape(1, 256)
    out = TN.layer_norm(x, torch.ones(256), torch.zeros(256))
    xc = torch.linspace(-1, 1, 256, dtype=torch.float64)
    ref = (xc - xc.mean()) / torch.sqrt(xc.var(unbiased=False) + 1e-5)
    np.testing.assert_allclose(out[0].double().numpy(), ref.numpy(), atol=2e-3, rtol=0)


def test_norm_wrappers_check_their_inputs():
    x = torch.zeros(4, 64)
    with pytest.raises(TypeError):
        TN.rms_norm(x.double(), torch.ones(64))
    with pytest.raises(ValueError, match="shape"):
        TN.rms_norm(x, torch.ones(63))
    with pytest.raises(ValueError, match="shape"):
        TN.layer_norm(x, torch.ones(64), torch.zeros(65))
    with pytest.raises(ValueError, match="last axis"):
        TN.rms_norm(torch.zeros(4, 0), torch.ones(0))
    # the kernel's row limit binds the card only: the plain version takes any d
    big = torch.randn(2, TN.MAX_D + 1)
    assert torch.equal(TN.rms_norm(big, torch.ones(TN.MAX_D + 1)),
                       TN.rms_norm_reference(big, torch.ones(TN.MAX_D + 1)))
