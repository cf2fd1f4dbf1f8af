"""Parity of the port's attention (audiolab_tpu_torch/kernels/attention.py)
with the JAX package's, on the CPU.

- ``flash_attention``: the JAX off-TPU path (its plain reference) against
  the port's CPU path (the kernels' plain versions), fp32, tolerance 1e-5.
- K1's and K2's plain versions against the JAX Pallas kernels themselves,
  run in Pallas interpret mode on the CPU: this pins the rounding points
  the CUDA kernels reproduce (bf16 for K1).
The CUDA kernels themselves are checked on the card by
tests/test_torch_port_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audiolab_tpu.kernels import attention as JA
from audiolab_tpu_torch.kernels import attention as TA


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(np.asarray(x, np.float32))).to(dtype)


def _qkv(rng, b, h, tq, tk, d):
    return (rng.standard_normal((b, h, tq, d)).astype(np.float32),
            rng.standard_normal((b, h, tk, d)).astype(np.float32),
            rng.standard_normal((b, h, tk, d)).astype(np.float32))


@pytest.mark.parametrize("tq,tk,causal,block_k", [
    (70, 70, False, 128),      # single key block (K1 route for 16-bit inputs)
    (200, 200, False, 128),    # two key blocks, kv length not a multiple of 128
    (333, 333, False, 768),    # the RoFormer time-axis routing (block_k=768)
    (50, 130, True, 128),      # causal, tq != tk (KV-cache offset tk - tq)
    (90, 90, True, 128),       # causal, square
])
def test_flash_attention_matches_jax(tq, tk, causal, block_k):
    """fp32, tolerance 1e-5 (sums in another order)."""
    rng = np.random.default_rng(tq + tk)
    q, k, v = _qkv(rng, 2, 3, tq, tk, 32)
    ref = np.asarray(JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, block_k=block_k))
    out = TA.flash_attention(_t(q), _t(k), _t(v), causal=causal, block_k=block_k)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_reference_matches_jax(dtype):
    """Plain references agree: fp32 to 1e-5; bf16 to 2 bf16 ulps of max|o|
    (the two frameworks round the bf16 score product independently)."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 2, 40, 60, 16)
    jdt = jnp.dtype(dtype)
    ref = np.asarray(JA.attention_reference(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), causal=True
    ).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    out = TA.attention_reference(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=True).float()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, atol=tol, rtol=0)


def _pallas_nk1(q, k, v, t_pad, scale):
    bh, t, d = q.shape[1], q.shape[2], q.shape[3]

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, t_pad - t), (0, 0)))

    spec = pl.BlockSpec((1, bh, t_pad, d), lambda g, i: (g, 0, i, 0))
    out = pl.pallas_call(
        functools.partial(JA._flash_kernel_nk1, n_pad=t_pad - t, scale=scale),
        out_shape=jax.ShapeDtypeStruct((1, bh, t_pad, d), q.dtype), grid=(1, 1),
        in_specs=[spec] * 3, out_specs=spec, interpret=True)(pad(q), pad(k), pad(v))
    return out[:, :, :t]


@pytest.mark.parametrize("t,t_pad", [(62, 62), (90, 128)])
def test_k1_plain_matches_pallas_nk1(t, t_pad):
    """K1's plain version vs the TPU kernel (interpret mode) in bf16, with
    and without zero-padded keys; tolerance 2 bf16 ulps of max|o| (exp and
    the dot products are evaluated in another order)."""
    rng = np.random.default_rng(t)
    q, k, v = _qkv(rng, 1, 4, t, t, 64)
    bf = jnp.bfloat16
    ref = np.asarray(_pallas_nk1(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
                                 t_pad, 0.125).astype(jnp.float32))
    out = TA.attention_nk1(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                           _t(v, torch.bfloat16), scale=0.125).float().numpy()
    np.testing.assert_allclose(out, ref, atol=2.0 ** -6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("tq,tk,causal", [(96, 200, False), (64, 192, True)])
def test_k2_plain_matches_pallas_flash(tq, tk, causal):
    """K2's plain version vs the TPU online-softmax kernel (interpret mode),
    fp32, 64-wide key blocks with a kv_len mask; tolerance 1e-5."""
    rng = np.random.default_rng(tq)
    q, k, v = _qkv(rng, 1, 2, tq, tk, 32)
    bq, bk = 32, 64
    tq_p, tk_p = -(-tq // bq) * bq, -(-tk // bk) * bk
    qp = jnp.pad(jnp.asarray(q), ((0, 0), (0, 0), (0, tq_p - tq), (0, 0)))
    kp = jnp.pad(jnp.asarray(k), ((0, 0), (0, 0), (0, tk_p - tk), (0, 0)))
    vp = jnp.pad(jnp.asarray(v), ((0, 0), (0, 0), (0, tk_p - tk), (0, 0)))
    ref = pl.pallas_call(
        functools.partial(JA._flash_kernel, scale=1 / np.sqrt(32), causal=causal, bq=bq,
                          bk=bk, kv_len=tk, causal_offset=tk - tq),
        out_shape=jax.ShapeDtypeStruct((1, 2, tq_p, 32), jnp.float32),
        grid=(1, tq_p // bq, tk_p // bk),
        in_specs=[pl.BlockSpec((1, 2, bq, 32), lambda g, i, j: (g, 0, i, 0)),
                  pl.BlockSpec((1, 2, bk, 32), lambda g, i, j: (g, 0, j, 0)),
                  pl.BlockSpec((1, 2, bk, 32), lambda g, i, j: (g, 0, j, 0))],
        out_specs=pl.BlockSpec((1, 2, bq, 32), lambda g, i, j: (g, 0, i, 0)),
        scratch_shapes=[pltpu_vmem((2, bq, 1)), pltpu_vmem((2, bq, 1)),
                        pltpu_vmem((2, bq, 32))],
        interpret=True)(qp, kp, vp)
    out = TA.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(out, np.asarray(ref)[:, :, :tq], atol=1e-5, rtol=0)


def pltpu_vmem(shape):
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.VMEM(shape, jnp.float32)
