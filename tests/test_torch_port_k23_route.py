"""K2's and K3's choice between their two CUDA designs, checked on the CPU,
and the 16-bit K2's plain version against the TPU kernel.

``k2_route`` is a pure function of (slices, tq, tk, d, dtype, causal,
alignment): the Hopper design takes 16-bit inputs at d = 64 or 128 when TMA
can address the rows (16-byte aligned bases), whatever tq, tk and the mask;
fp32 inputs stay on the register-tiled fp32 kernel, other head dims and other
bases on the row-per-thread-group kernel.  ``k3_route`` is a pure function of (slices, tq, tk, d, dtype,
alignment): the rope variant of K1's Hopper time design takes d = 64 in
16-bit types with tk <= 768 when q, k, v and both tables lie on 16-byte
boundaries (a band-shaped call too: it runs the time design over one
chunk), the WMMA core everything else.  A CPU tensor takes the plain version
whatever the route and counts no launch: a spy on the plain function shows
that its call answered, output and all (the suite once saw two fp32 einsums
of the plain version, one through the wrapper and one direct, differ in a
bf16 rounding when other test files shared the worker; the port cannot fix
the CPU BLAS's summation order, so the route is asserted, not a second
evaluation's bits).  The port's side runs on one torch thread
(``one_torch_thread``), as every port test file does.

The plain version of K2 is held in bf16 against the Pallas ``_flash_kernel``
in interpret mode at d = 64 and 128, causal and not: tolerance 2 bf16 ulps
of max|out| (the two evaluate exp and the sums in another order, which may
flip a probability's or an output's rounding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from audiolab_tpu.kernels import attention as JA
from audiolab_tpu_torch.kernels import attention as TA
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

BF, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("bh,tq,tk,d,dtype,causal,aligned,route", [
    (96, 399, 399, 64, BF, False, True, "sm90"),       # the HuBERT shape in bf16
    (96, 399, 399, 64, F16, False, True, "sm90"),
    (16, 100, 333, 64, BF, True, True, "sm90"),        # causal, tq != tk
    (16, 2048, 2048, 128, BF, True, True, "sm90"),     # a language-model prefill
    (16, 2048, 2048, 128, F16, True, True, "sm90"),
    (32, 1000, 1537, 128, BF, False, True, "sm90"),    # d = 128, ragged keys
    (16, 1, 2048, 128, BF, True, True, "sm90"),        # a decode step: one query row
    (16, 1, 1, 64, BF, False, True, "sm90"),
    (16, 200, 130, 64, BF, True, True, "sm90"),        # more queries than keys
    (96, 399, 399, 64, F32, False, True, "core"),      # fp32 keeps fp32 products
    (16, 2048, 2048, 128, F32, True, True, "core"),
    (6, 150, 260, 80, BF, True, True, "core"),         # other head dims
    (6, 150, 260, 256, BF, False, True, "core"),
    (6, 150, 260, 32, F16, False, True, "core"),
    (6, 150, 260, 96, BF, False, True, "core"),
    (96, 399, 399, 64, BF, False, False, "core"),      # a base off a 16-byte boundary
    (16, 2048, 2048, 128, F16, True, False, "core"),
])
def test_k2_route(bh, tq, tk, d, dtype, causal, aligned, route):
    assert TA.k2_route(bh, tq, tk, d, dtype, causal, aligned) == route


@pytest.mark.parametrize("bh,tq,tk,d,dtype,aligned,route", [
    (3968, 690, 690, 64, BF, True, "time"),     # RoFormer time axis
    (3968, 690, 690, 64, F16, True, "time"),
    (8, 100, 690, 64, BF, True, "time"),        # tq != tk
    (8, 690, 62, 64, BF, True, "time"),
    (8, 200, 768, 64, BF, True, "time"),        # the most keys kept resident
    (8, 200, 769, 64, BF, True, "core"),
    (44160, 62, 62, 64, BF, True, "time"),      # band-shaped: the time design, one chunk
    (8, 1, 1, 64, F16, True, "time"),
    (8, 100, 100, 32, BF, True, "core"),        # other head dims
    (8, 130, 130, 128, F16, True, "core"),
    (8, 100, 100, 16, BF, True, "core"),
    (8, 690, 690, 64, F32, True, "core"),
    (3968, 690, 690, 64, BF, False, "core"),    # a base or a table off a 16-byte boundary
    (44160, 62, 62, 64, F16, False, "core"),
])
def test_k3_route(bh, tq, tk, d, dtype, aligned, route):
    assert TA.k3_route(bh, tq, tk, d, dtype, aligned) == route


def test_routes_ignore_the_slice_count():
    counts = (1, 131, 132, 133, 44160)
    assert {TA.k2_route(bh, 399, 399, 64, BF, False, True) for bh in counts} == {"sm90"}
    assert {TA.k2_route(bh, 399, 399, 80, BF, False, True) for bh in counts} == {"core"}
    assert {TA.k3_route(bh, 690, 690, 64, BF, True) for bh in counts} == {"time"}
    assert {TA.k3_route(bh, 690, 769, 64, BF, True) for bh in counts} == {"core"}


def _rand(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _counts():
    return (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches,
            TA.flash_attention_fwd_core.launches,
            TA.attention_nk1_rope.launches, TA.attention_nk1_rope.sm90_launches,
            TA.attention_nk1_rope_core.launches)


@pytest.mark.parametrize("tq,tk,d,causal", [
    (70, 130, 64, True),      # the Hopper design's shapes
    (40, 40, 128, False),
    (33, 50, 80, True),       # another head dim: the row-per-thread-group kernel's
    (20, 20, 256, False)])
@pytest.mark.parametrize("dtype", [BF, F16])
def test_k2_cpu_tensors_take_the_plain_version_on_every_route(tq, tk, d, causal, dtype,
                                                              monkeypatch):
    rng = np.random.default_rng(tq + tk + d)
    q, k, v = (_rand(rng, (1, 2, n, d), dtype) for n in (tq, tk, tk))
    plain, calls = TA.flash_attention_reference, []

    def spy(*args):
        calls.append((args, plain(*args)))
        return calls[-1][1]

    monkeypatch.setattr(TA, "flash_attention_reference", spy)
    TA.reset_launch_counts()
    for fn in (TA.flash_attention_fwd, TA.flash_attention_fwd_core):
        out = fn(q, k, v, causal=causal)
        (a_q, a_k, a_v, a_causal, a_scale), answer = calls[-1]
        assert out is answer and all(a is b for a, b in zip((a_q, a_k, a_v), (q, k, v)))
        assert a_causal is causal and a_scale == 1.0 / np.sqrt(d)
    assert len(calls) == 2
    assert _counts() == (0,) * 6


@pytest.mark.parametrize("tq,tk,d", [
    (100, 100, 64),     # the Hopper time route's shape
    (62, 62, 64),       # band-shaped
    (70, 800, 64),      # too many keys: the core's
    (40, 40, 32)])      # another head dim: the core's
@pytest.mark.parametrize("dtype", [BF, F16])
def test_k3_cpu_tensors_take_the_plain_version_on_every_route(tq, tk, d, dtype):
    rng = np.random.default_rng(tq + tk + d)
    q, k, v = (_rand(rng, (1, 2, n, d), dtype) for n in (tq, tk, tk))
    cos, sin = TA.rope_tables(max(tq, tk) + 3, d)
    TA.reset_launch_counts()
    ref = TA.attention_nk1_rope_reference(q, k, v, cos, sin, d ** -0.5)
    assert torch.equal(TA.attention_nk1_rope(q, k, v, cos, sin), ref)
    assert torch.equal(TA.attention_nk1_rope_core(q, k, v, cos, sin), ref)
    assert _counts() == (0,) * 6


def test_reset_clears_the_new_counters():
    TA.flash_attention_fwd.sm90_launches = 3
    TA.flash_attention_fwd_core.launches = 1
    TA.attention_nk1_rope.sm90_launches = 4
    TA.attention_nk1_rope_core.launches = 2
    TA.reset_launch_counts()
    assert _counts() == (0,) * 6


def test_core_yardsticks_check_types_before_the_device():
    q = torch.zeros(1, 1, 4, 64)
    cos, sin = TA.rope_tables(4, 64)
    with pytest.raises(TypeError):
        TA.flash_attention_fwd_core(q, q, q)            # fp32 has its own kernel
    with pytest.raises(TypeError):
        TA.attention_nk1_rope_core(q, q, q, cos, sin)
    with pytest.raises(ValueError, match="rope table"):
        TA.attention_nk1_rope_core(q.to(BF), q.to(BF), q.to(BF), cos[:3], sin[:3])


def _pallas_flash(q, k, v, causal, scale, bq=32, bk=64):
    """The TPU online-softmax kernel in interpret mode on (1, h, t, d) inputs,
    keys padded to a multiple of bk and masked by kv_len."""
    h, tq, d = q.shape[1], q.shape[2], q.shape[3]
    tk = k.shape[2]
    tq_p, tk_p = -(-tq // bq) * bq, -(-tk // bk) * bk
    qp = jnp.pad(q, ((0, 0), (0, 0), (0, tq_p - tq), (0, 0)))
    kp = jnp.pad(k, ((0, 0), (0, 0), (0, tk_p - tk), (0, 0)))
    vp = jnp.pad(v, ((0, 0), (0, 0), (0, tk_p - tk), (0, 0)))
    out = pl.pallas_call(
        functools.partial(JA._flash_kernel, scale=scale, causal=causal, bq=bq, bk=bk,
                          kv_len=tk, causal_offset=tk - tq),
        out_shape=jax.ShapeDtypeStruct((1, h, tq_p, d), q.dtype),
        grid=(1, tq_p // bq, tk_p // bk),
        in_specs=[pl.BlockSpec((1, h, bq, d), lambda g, i, j: (g, 0, i, 0)),
                  pl.BlockSpec((1, h, bk, d), lambda g, i, j: (g, 0, j, 0)),
                  pl.BlockSpec((1, h, bk, d), lambda g, i, j: (g, 0, j, 0))],
        out_specs=pl.BlockSpec((1, h, bq, d), lambda g, i, j: (g, 0, i, 0)),
        scratch_shapes=[pltpu.VMEM((h, bq, 1), jnp.float32),
                        pltpu.VMEM((h, bq, 1), jnp.float32),
                        pltpu.VMEM((h, bq, d), jnp.float32)],
        interpret=True)(qp, kp, vp)
    return out[:, :, :tq]


@pytest.mark.parametrize("tq,tk,causal", [
    (96, 200, False),     # ragged last key block
    (64, 192, True),      # causal, tk - tq = 128
    (70, 200, True)])     # causal, tk - tq = 130: the diagonal inside a block
@pytest.mark.parametrize("d", [64, 128])
def test_k2_plain_matches_pallas_flash_bf16(tq, tk, causal, d):
    """K2's plain version vs the TPU online-softmax kernel (interpret mode) in
    bf16: 16-bit products with fp32 accumulation, scores scaled in fp32, the
    row sum from the fp32 p and the numerator from p rounded to bf16;
    tolerance 2 bf16 ulps of max|out|."""
    rng = np.random.default_rng(tq + d)
    q, k, v = (rng.standard_normal((1, 2, n, d)).astype(np.float32) for n in (tq, tk, tk))
    scale = float(d) ** -0.5
    ref = np.asarray(_pallas_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                   jnp.asarray(v, jnp.bfloat16), causal, scale)
                     .astype(jnp.float32))
    qt, kt, vt = (torch.from_numpy(x).to(BF) for x in (q, k, v))
    out = TA.flash_attention_fwd(qt, kt, vt, causal=causal, scale=scale)
    assert out.dtype == BF
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2.0 ** -6 * np.abs(ref).max(),
                               rtol=0)


@pytest.mark.parametrize("tq,tk", [(200, 130), (77, 1), (300, 64)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_causal_keyless_rows_match_jax(tq, tk, d, dtype):
    """A causal call with tq > tk: the port's ``flash_attention`` against the
    JAX one on the CPU (both the plain path), the first tq - tk rows the mean
    of v; and the CUDA routes' composition (the kernel on the last tk rows
    with diagonal offset 0, :func:`with_keyless_rows` for the rest) gives
    the plain version's result.  fp32 to 1e-5, bf16 to 2 ulps of max|out|."""
    rng = np.random.default_rng(tq + d)
    q, k, v = (rng.standard_normal((2, 3, t, d)).astype(np.float32) for t in (tq, tk, tk))
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    ref = np.asarray(JA.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                        jnp.asarray(v, jdt), causal=True), np.float32)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out = TA.flash_attention(tq_, tk_, tv_, causal=True)
    tol = 1e-5 if dtype == np.float32 else 2.0 ** -6 * np.abs(ref).max()
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=0)
    n = TA.keyless_rows(tq, tk, True)
    assert n == tq - tk and TA.keyless_rows(tq, tk, False) == 0
    mean = v.mean(axis=2, keepdims=True)
    np.testing.assert_allclose(ref[:, :, :n], np.broadcast_to(mean, (2, 3, n, d)), atol=tol)
    rest = TA.flash_attention_reference(tq_[:, :, n:], tk_, tv_, True, d ** -0.5)
    joined = TA.with_keyless_rows(tq_, tv_, rest, n)
    np.testing.assert_allclose(joined.float().numpy(), out.float().numpy(), atol=tol, rtol=0)
