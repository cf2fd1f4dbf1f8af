"""K6's and K7's choice between their two CUDA designs, checked on the CPU.

``k6_route`` is a pure function of (slices, tq, tk, d, dtype, alignment):
the Hopper band design takes d = 64 in 16-bit types when tq and tk both fit
one 64-row tile and TMA can address the rows (16-byte aligned bases), the
WMMA core everything else.  ``k7_route`` is a pure
function of (b, heads, t, d, row stride, dtype, alignment): the Hopper time
design takes d = 64 in 16-bit types with t <= 768 when TMA can address the
rows (16-byte aligned bases, a row stride whose bytes are a multiple of
16), the WMMA core everything else.  A CPU tensor takes the plain version
whatever the route and counts no launch.
"""

import numpy as np
import pytest
import torch

from audiolab_tpu_torch.kernels import attention as TA

BF, F16 = torch.bfloat16, torch.float16


@pytest.mark.parametrize("b,heads,t,d,ld,dtype,aligned,route", [
    (496, 8, 690, 64, 512, BF, True, "time"),      # RoFormer time axis, packed
    (496, 8, 690, 64, 1536, BF, True, "time"),     # the same as views of a fused qkv
    (496, 8, 690, 64, 512, F16, True, "time"),
    (496, 8, 690, 64, 1536, F16, True, "time"),
    (2, 8, 64, 64, 512, BF, True, "time"),         # one whole tile
    (2, 8, 1, 64, 512, BF, True, "time"),
    (2, 8, 768, 64, 512, BF, True, "time"),        # the most keys kept resident
    (2, 8, 769, 64, 512, BF, True, "core"),
    (2, 3, 100, 32, 96, BF, True, "core"),         # other head dims
    (2, 2, 130, 128, 256, BF, True, "core"),
    (2, 8, 690, 64, 512, torch.float32, True, "core"),
    (2, 2, 100, 64, 136, BF, True, "time"),        # padded rows, 272 bytes = 17 * 16
    (2, 2, 100, 64, 132, BF, True, "core"),        # 264 bytes: not a multiple of 16
    (2, 2, 100, 64, 516, F16, True, "core"),       # 1032 bytes
    (496, 8, 690, 64, 512, BF, False, "core"),     # a base off a 16-byte boundary
    (496, 8, 690, 64, 1536, F16, False, "core"),
])
def test_k7_route(b, heads, t, d, ld, dtype, aligned, route):
    assert TA.k7_route(b, heads, t, d, ld, dtype, aligned) == route


@pytest.mark.parametrize("bh,tq,tk,d,dtype,aligned,route", [
    (44160, 62, 62, 64, BF, True, "band"),      # RoFormer band axis
    (44160, 62, 62, 64, F16, True, "band"),
    (8, 64, 64, 64, BF, True, "band"),          # one whole tile and chunk
    (8, 1, 1, 64, BF, True, "band"),
    (8, 5, 33, 64, F16, True, "band"),
    (8, 65, 64, 64, BF, True, "core"),          # a second query tile
    (8, 64, 65, 64, BF, True, "core"),          # a second key chunk
    (3968, 690, 690, 64, BF, True, "core"),     # RoFormer time axis
    (8, 62, 62, 32, BF, True, "core"),          # other head dims
    (8, 62, 62, 128, F16, True, "core"),
    (8, 62, 62, 64, torch.float32, True, "core"),
    (44160, 62, 62, 64, BF, False, "core"),     # a base off a 16-byte boundary
    (8, 64, 64, 64, F16, False, "core"),
])
def test_k6_route(bh, tq, tk, d, dtype, aligned, route):
    assert TA.k6_route(bh, tq, tk, d, dtype, aligned) == route


def test_routes_ignore_the_slice_count():
    assert {TA.k6_route(bh, 62, 62, 64, BF, True) for bh in (1, 131, 132, 133, 44160)} == {"band"}
    assert {TA.k6_route(bh, 65, 62, 64, BF, True) for bh in (1, 132, 44160)} == {"core"}
    shapes = ((1, 1), (1, 132), (17, 8), (496, 8), (5000, 1))
    assert {TA.k7_route(b, h, 690, 64, 64 * h, BF, True) for b, h in shapes} == {"time"}
    assert {TA.k7_route(b, h, 769, 64, 64 * h, BF, True) for b, h in shapes} == {"core"}


def _rand(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _counts():
    return (TA.slim_attention.launches, TA.slim_attention.sm90_launches,
            TA.slim_attention_core.launches,
            TA.packed_attention.launches, TA.packed_attention.sm90_launches,
            TA.packed_attention_core.launches)


@pytest.mark.parametrize("tq,tk,d", [(62, 62, 64), (65, 62, 64), (62, 62, 32)])
@pytest.mark.parametrize("dtype", [BF, F16])
def test_k6_cpu_tensors_take_the_plain_version_on_every_route(tq, tk, d, dtype):
    rng = np.random.default_rng(tq + tk + d)
    q, k, v = (_rand(rng, (1, 2, n, d), dtype) for n in (tq, tk, tk))
    TA.reset_launch_counts()
    ref = TA.attention_nk1_reference(q, k, v, d ** -0.5)
    assert torch.equal(TA.slim_attention(q, k, v), ref)
    assert torch.equal(TA.slim_attention_core(q, k, v), ref)
    assert _counts() == (0,) * 6


@pytest.mark.parametrize("t,heads,d", [
    (100, 2, 64),     # the Hopper time route's shape
    (769, 1, 64),     # too many keys: the core's
    (40, 3, 32)])     # another head dim: the core's
@pytest.mark.parametrize("layout", ["packed", "qkv_views"])
def test_k7_cpu_tensors_take_the_plain_version_on_every_route(t, heads, d, layout):
    rng = np.random.default_rng(t + heads)
    inner = heads * d
    qkv = _rand(rng, (2, t, 3 * inner), BF)
    q, k, v = qkv.split(inner, dim=-1)
    if layout == "packed":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    assert q.stride(1) == (inner if layout == "packed" else 3 * inner)
    TA.reset_launch_counts()
    ref = TA.packed_attention_reference(q, k, v, heads, d, d ** -0.5)
    assert ref.shape == (2, t, inner)
    assert torch.equal(TA.packed_attention(q, k, v, heads, d), ref)
    assert torch.equal(TA.packed_attention_core(q, k, v, heads, d), ref)
    assert _counts() == (0,) * 6


def test_reset_clears_the_hopper_counters():
    TA.slim_attention.sm90_launches = 3
    TA.packed_attention.sm90_launches = 4
    TA.slim_attention_core.launches = 1
    TA.packed_attention_core.launches = 2
    TA.reset_launch_counts()
    assert _counts() == (0,) * 6


def test_packed_wrappers_check_shapes_before_the_device():
    q = torch.zeros(1, 8, 128, dtype=BF)
    for fn in (TA.packed_attention, TA.packed_attention_core):
        with pytest.raises(ValueError, match="is not"):
            fn(q, q, q, 3, 64)
        with pytest.raises(TypeError):
            fn(q.float(), q.float(), q.float(), 2, 64)
    for fn in (TA.slim_attention, TA.slim_attention_core):
        with pytest.raises(TypeError):
            fn(*(torch.zeros(1, 1, 4, 64),) * 3)
