"""Parity of the port's rope attention and the two probe kernels
(audiolab_tpu_torch/kernels/attention.py) with the JAX package, on the CPU.

- ``rope_tables``/``apply_rope_tables`` against the JAX package's.
- ``flash_attention`` with rope tables against the JAX off-TPU path, fp32,
  on every route the port has, with tables of exactly t rows and longer.
- K3's, K6's and K7's plain versions (what the CPU wrappers run) against
  the Pallas kernels themselves in interpret mode, bf16: K3
  ``_flash_kernel_nk1_rope``; K6 ``_nk1_slim`` and K7 ``_packed_kernel``
  from the probe scripts under tools/.  Those scripts run a probe or set a
  JAX cache directory when imported, so only the kernel's definition is
  read (``ast``) and executed.
The CUDA kernels themselves are checked on the card by
tests/test_torch_port_cuda.py.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audiolab_tpu.kernels import attention as JA
from audiolab_tpu_torch.kernels import attention as TA

ROOT = Path(__file__).resolve().parent.parent
BF = jnp.bfloat16


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(np.asarray(x, np.float32))).to(dtype)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _qkv(rng, b, h, tq, tk, d):
    return (rng.standard_normal((b, h, tq, d)).astype(np.float32),
            rng.standard_normal((b, h, tk, d)).astype(np.float32),
            rng.standard_normal((b, h, tk, d)).astype(np.float32))


def probe_function(rel_path: str, name: str):
    """The top-level function ``name`` of a tools/ script, executed alone in a
    namespace holding jax, jnp and pl: the rest of the script never runs."""
    path = ROOT / rel_path
    tree = ast.parse(path.read_text(), str(path))
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"jax": jax, "jnp": jnp, "pl": pl}
    exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"), ns)
    return ns[name]


def _ulps2(ref):
    """2 bf16 ulps of max|ref| (exp and the dot products are evaluated in
    another order, which may flip an output's or a probability's rounding)."""
    return 2.0 ** -6 * np.abs(ref).max()


@pytest.mark.parametrize("t,d,scale", [(70, 32, 1.0), (690, 64, 1.0), (62, 64, 0.125)])
def test_rope_tables_match_jax(t, d, scale):
    cos, sin = TA.rope_tables(t, d, scale)
    jcos, jsin = JA.rope_tables(t, d, scale)
    assert cos.dtype == sin.dtype == torch.float32
    np.testing.assert_allclose(cos.numpy(), jcos, atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), jsin, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_tables_matches_jax(dtype):
    """fp32 to 1e-6; bf16 to 1 ulp of each element (one rounding of the same
    fp32 value on both sides)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 50, 64)).astype(np.float32)
    cos, sin = JA.rope_tables(50, 64)
    ref = _f32(JA.apply_rope_tables(jnp.asarray(x, jnp.dtype(dtype)), cos, sin))
    out = TA.apply_rope_tables(_t(x, getattr(torch, dtype)), cos, sin)
    assert out.dtype == getattr(torch, dtype)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    else:
        assert (np.abs(out - ref) <= 2.0 ** -7 * np.abs(ref)).all()


@pytest.mark.parametrize("extra_rows", [0, 37])
@pytest.mark.parametrize("tq,tk,causal,d", [
    (70, 70, False, 32),      # single key block
    (200, 200, False, 32),    # two key blocks
    (50, 130, True, 32),      # causal, tq != tk
    (40, 40, False, 320),     # d > 256: rope, then the plain reference
])
def test_flash_attention_rope_matches_jax(tq, tk, causal, d, extra_rows):
    """fp32, tolerance 1e-5 (sums in another order); tables with exactly
    max(tq, tk) rows and with more."""
    rng = np.random.default_rng(tq + tk + d)
    q, k, v = _qkv(rng, 2, 3, tq, tk, d)
    cos, sin = JA.rope_tables(max(tq, tk) + extra_rows, d)
    ref = np.asarray(JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        causal=causal, rope_cos=cos, rope_sin=sin))
    out = TA.flash_attention(_t(q), _t(k), _t(v), causal=causal, rope_cos=cos, rope_sin=sin)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,tq,tk,causal,d", [
    ("bfloat16", 64, 64, False, 64),    # K3
    ("float32", 64, 64, False, 64),     # rope, then K2
    ("bfloat16", 40, 64, True, 64),     # causal: rope, then K2
    ("float32", 8, 8, False, 320),      # rope, then the plain reference
])
def test_flash_attention_rejects_short_rope_tables(dtype, tq, tk, causal, d):
    q, k, v = (torch.zeros(1, 2, t, d, dtype=getattr(torch, dtype)) for t in (tq, tk, tk))
    cos, sin = TA.rope_tables(max(tq, tk) - 1, d)
    with pytest.raises(ValueError, match="rope table"):
        TA.flash_attention(q, k, v, causal=causal, rope_cos=cos, rope_sin=sin)
    with pytest.raises(ValueError, match="together"):
        TA.flash_attention(q, k, v, causal=causal, rope_cos=cos)


def _pallas_nk1_rope(q, k, v, cos, sin, t_pad, scale):
    """``_flash_kernel_nk1_rope`` in interpret mode, built as
    flash_attention builds it (attention.py:338-362): zero-padded keys and
    zero table rows past t, the scale folded into q's tables."""
    bh, t, d = q.shape[1], q.shape[2], q.shape[3]

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, t_pad - t), (0, 0)))

    cq, sq = np.zeros((t_pad, d), np.float32), np.zeros((t_pad, d), np.float32)
    cq[:t], sq[:t] = cos[:t] * scale, sin[:t] * scale
    ck, sk = np.zeros((t_pad, d), np.float32), np.zeros((t_pad, d), np.float32)
    ck[:t], sk[:t] = cos[:t], sin[:t]
    spec = pl.BlockSpec((1, bh, t_pad, d), lambda g, i: (g, 0, i, 0))
    tab = pl.BlockSpec((t_pad, d), lambda g, i: (i, 0))
    out = pl.pallas_call(
        functools.partial(JA._flash_kernel_nk1_rope, n_pad=t_pad - t),
        out_shape=jax.ShapeDtypeStruct((1, bh, t_pad, d), q.dtype), grid=(1, 1),
        in_specs=[spec] * 3 + [tab] * 4, out_specs=spec, interpret=True,
    )(pad(q), pad(k), pad(v), *map(jnp.asarray, (cq, sq, ck, sk)))
    return out[:, :, :t]


@pytest.mark.parametrize("t,t_pad", [(62, 62), (90, 128)])
def test_k3_plain_matches_pallas_nk1_rope(t, t_pad):
    """K3's plain version vs the TPU kernel (interpret mode) in bf16, with and
    without zero-padded keys; the port gets tables longer than t.  The
    route through flash_attention is the same function."""
    rng = np.random.default_rng(t)
    q, k, v = _qkv(rng, 1, 4, t, t, 64)
    cos, sin = JA.rope_tables(t + 37, 64)
    ref = _f32(_pallas_nk1_rope(jnp.asarray(q, BF), jnp.asarray(k, BF), jnp.asarray(v, BF),
                                cos, sin, t_pad, 0.125))
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    out = TA.attention_nk1_rope(tq, tk, tv, cos, sin, scale=0.125)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=_ulps2(ref), rtol=0)
    routed = TA.flash_attention(tq, tk, tv, block_k=t_pad, rope_cos=cos, rope_sin=sin)
    assert torch.equal(routed, out)


@pytest.mark.parametrize("b,t,bh", [(2, 62, 8), (1, 40, 4)])
def test_k6_plain_matches_pallas_slim(b, t, bh):
    """K6's plain version vs ``_nk1_slim`` (tools/probe_freq_bh128.py:36),
    built as slim_attention builds it (:50-63), bf16, interpret mode."""
    kernel = probe_function("tools/probe_freq_bh128.py", "_nk1_slim")
    rng = np.random.default_rng(t)
    h, d = 4, 64
    q, k, v = _qkv(rng, b, h, t, t, d)
    groups = b * h // bh
    spec = pl.BlockSpec((1, bh, t, d), lambda g: (g, 0, 0, 0))
    ref = pl.pallas_call(
        functools.partial(kernel, scale=0.125),
        out_shape=jax.ShapeDtypeStruct((groups, bh, t, d), BF), grid=(groups,),
        in_specs=[spec] * 3, out_specs=spec, interpret=True,
    )(*(jnp.asarray(x, BF).reshape(groups, bh, t, d) for x in (q, k, v)))
    ref = _f32(ref).reshape(b, h, t, d)
    out = TA.slim_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)), scale=0.125)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=_ulps2(ref), rtol=0)


@pytest.mark.parametrize("variant", ["C1", "C2"])
@pytest.mark.parametrize("t,bq", [(62, 62), (90, 30)])
def test_k7_plain_matches_pallas_packed(variant, t, bq):
    """K7's plain version vs ``_packed_kernel`` (tools/probe_packed_attn.py:68),
    both TPU variants, built as packed_attention builds it (:108-128), bf16,
    interpret mode; inputs and output in the packed (b, t, heads*d) layout."""
    kernel = probe_function("tools/probe_packed_attn.py", "_packed_kernel")
    rng = np.random.default_rng(t + bq)
    b, h, d = 2, 4, 64
    q, k, v = (rng.standard_normal((b, t, h * d)).astype(np.float32) for _ in range(3))
    ref = pl.pallas_call(
        functools.partial(kernel, variant=variant, scale=0.125),
        out_shape=jax.ShapeDtypeStruct((b, t, h, d), BF), grid=(b, t // bq),
        in_specs=[pl.BlockSpec((1, bq, h, d), lambda ib, iq: (ib, iq, 0, 0)),
                  pl.BlockSpec((1, t, h, d), lambda ib, iq: (ib, 0, 0, 0)),
                  pl.BlockSpec((1, t, h, d), lambda ib, iq: (ib, 0, 0, 0))],
        out_specs=pl.BlockSpec((1, bq, h, d), lambda ib, iq: (ib, iq, 0, 0)),
        interpret=True,
    )(*(jnp.asarray(x, BF).reshape(b, t, h, d) for x in (q, k, v)))
    ref = _f32(ref).reshape(b, t, h * d)
    out = TA.packed_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)), h, d, scale=0.125)
    assert out.shape == (b, t, h * d)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=_ulps2(ref), rtol=0)
