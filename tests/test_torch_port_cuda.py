"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (decided inside the fixture, never at import).  The file imports no
JAX, so it runs where JAX is not installed; on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

``.sm90_launches`` shows which design a call of K1, K2, K3, K6 or K7 ran on.

Tolerances: K1, K3, K6, K7 and the 16-bit K2 to 2 bf16 ulps of max|out| (the
sums run in another order, which may flip an output's or a probability's
rounding); K2 (fp32) to 2e-5 (fp32 sums over a few hundred
keys in another order); K4 and K5 to 1 ulp of max|out| in 16-bit types
and 1e-5 of max|out| in fp32 (fp32 row sums in another order).
"""

import pytest
import torch

from audiolab_tpu_torch.kernels import attention as TA
from audiolab_tpu_torch.kernels import norms as TN

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _qkv(dev, dtype, b, h, tq, tk, d=64, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(t):
        return torch.randn(b, h, t, d, generator=g, device=dev).to(dtype)

    return rnd(tq), rnd(tk), rnd(tk)


def _k1_tol(ref):
    return 2.0 ** -6 * ref.float().abs().max().item()


@pytest.mark.parametrize("b,h,t,d", [
    (2, 4, 690, 64),      # RoFormer time axis (11 key chunks)
    (2, 4, 62, 64),       # RoFormer band axis, one slice per CTA
    (140, 8, 62, 64),     # >= 1056 slices of <= 64 rows: 8 slices per CTA
    (3, 2, 100, 32), (3, 2, 40, 16), (1, 2, 130, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k1_matches_plain(cuda_device, b, h, t, d, dtype):
    q, k, v = _qkv(cuda_device, getattr(torch, dtype), b, h, t, t, d)
    out = TA.attention_nk1(q, k, v)
    ref = TA.attention_nk1_reference(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("tq,tk,causal", [
    (399, 399, False), (100, 333, True), (300, 300, True), (64, 64, True), (1, 77, True),
    (200, 700, False)])
@pytest.mark.parametrize("d", [64, 80, 256])
def test_k2_matches_plain_fp32(cuda_device, tq, tk, causal, d):
    q, k, v = _qkv(cuda_device, torch.float32, 2, 3, tq, tk, d)
    out = TA.flash_attention_fwd(q, k, v, causal=causal)
    ref = TA.flash_attention_reference(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize("bh,tq,tk", [
    ((2, 4), 690, 690),   # RoFormer time axis: K/V resident, 11 query tiles
    ((2, 4), 100, 690),   # tq != tk, a ragged second tile
    ((2, 4), 690, 62),    # many query tiles over one short key chunk
    ((1, 3), 200, 768),   # the most keys the time route keeps resident
    ((1, 3), 130, 65),    # one key past a chunk
    ((1, 3), 90, 1),      # one key
    ((1, 3), 40, 300),    # one query tile: the second warpgroup has none
    ((3, 45), 62, 62),    # band axis, 135 slices: not a multiple of 132 CTAs
    ((2, 4), 64, 64),     # band axis, whole tile and chunk
    ((1, 2), 5, 33)])     # band axis, ragged both ways
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k1_hopper_route_matches_plain(cuda_device, bh, tq, tk, dtype):
    q, k, v = _qkv(cuda_device, getattr(torch, dtype), *bh, tq, tk, 64, seed=tq + tk)
    assert TA.k1_route(bh[0] * bh[1], tq, tk, 64, q.dtype) in ("band", "time")
    before = TA.attention_nk1.sm90_launches
    out = TA.attention_nk1(q, k, v)
    ref = TA.attention_nk1_reference(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert TA.attention_nk1.sm90_launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("tq", [62, 100])   # band route, and time route over one chunk
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k1_hopper_masks_padded_keys(cuda_device, tq, dtype):
    """Every real score is 3.5 * -3.5 * 64 / 8 = -98: the output is the mean
    of v's rows.  A zero-filled key left unmasked would score 0, take the
    whole softmax and pull the output toward 0."""
    dt = getattr(torch, dtype)
    tk = 62
    q = torch.full((1, 2, tq, 64), 3.5, device=cuda_device, dtype=dt)
    k = torch.full((1, 2, tk, 64), -3.5, device=cuda_device, dtype=dt)
    v = _qkv(cuda_device, dt, 1, 2, tk, tk, 64, seed=7)[2]
    out = TA.attention_nk1(q, k, v)
    ref = TA.attention_nk1_reference(q, k, v, 0.125)
    mean = v.float().mean(dim=2, keepdim=True).expand(1, 2, tq, 64)
    torch.cuda.synchronize()
    assert TA.k1_route(2, tq, tk, 64, dt) == ("band" if tq <= 64 else "time")
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    assert (out.float() - mean).abs().max().item() <= _k1_tol(mean)


def test_k1_routes_by_shape(cuda_device):
    """The main path's two shapes take the Hopper design (second counter);
    d = 32 and tk = 1000 take the WMMA core; both count in ``.launches``."""
    TA.reset_launch_counts()
    for tq, tk, d in ((690, 690, 64), (62, 62, 64)):
        TA.attention_nk1(*_qkv(cuda_device, torch.bfloat16, 1, 2, tq, tk, d))
    assert (TA.attention_nk1.launches, TA.attention_nk1.sm90_launches) == (2, 2)
    for tq, tk, d in ((100, 100, 32), (70, 1000, 64)):
        q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, tq, tk, d)
        out = TA.attention_nk1(q, k, v)
        ref = TA.attention_nk1_reference(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    assert (TA.attention_nk1.launches, TA.attention_nk1.sm90_launches) == (4, 2)
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, 62, 62)
    assert torch.equal(TA.attention_nk1_core(q, k, v), TA.attention_nk1_core(q, k, v))
    assert (TA.attention_nk1.launches, TA.attention_nk1_core.launches) == (4, 2)
    TA.reset_launch_counts()


@pytest.mark.parametrize("b,h,tq,tk,d,causal", [
    (8, 12, 399, 399, 64, False),   # HuBERT: 96 slices x 7 query tiles
    (2, 3, 100, 333, 64, True),     # causal, diagonal at tk - tq
    (2, 3, 150, 399, 80, True),     # d = 80: padded to 128
    (1, 2, 70, 130, 256, False),    # d = 256: 32-key tiles
    (1, 2, 90, 90, 30, True)])      # d % 4 != 0: 4-byte copies
def test_k2_fp32_register_tiled(cuda_device, b, h, tq, tk, d, causal):
    q, k, v = _qkv(cuda_device, torch.float32, b, h, tq, tk, d, seed=d)
    out = TA.flash_attention_fwd(q, k, v, causal=causal)
    ref = TA.flash_attention_reference(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 2e-5


def test_k2_matches_plain_bf16(cuda_device):
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 3, 150, 260)
    out = TA.flash_attention_fwd(q, k, v, causal=True)
    ref = TA.flash_attention_reference(q, k, v, True, 0.125)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


def test_flash_attention_routes_and_counts(cuda_device):
    """bf16 single-block non-causal -> K1; fp32 or causal -> K2; each wrapper
    counts one launch per call; d > 256 takes the plain reference."""
    TA.reset_launch_counts()
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, 62, 62)
    TA.flash_attention(q, k, v, block_k=62)
    assert (TA.attention_nk1.launches, TA.flash_attention_fwd.launches) == (1, 0)
    TA.flash_attention(q, k, v, causal=True)
    q32, k32, v32 = _qkv(cuda_device, torch.float32, 1, 2, 62, 62)
    TA.flash_attention(q32, k32, v32)
    assert (TA.attention_nk1.launches, TA.flash_attention_fwd.launches) == (1, 2)
    big = _qkv(cuda_device, torch.float32, 1, 1, 8, 8, d=320)
    TA.flash_attention(*big)
    assert (TA.attention_nk1.launches, TA.flash_attention_fwd.launches) == (1, 2)
    TA.reset_launch_counts()


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="contiguous"):
        TA.attention_nk1(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError, match="head dim"):
        TA.attention_nk1(*_qkv(cuda_device, torch.bfloat16, 1, 1, 8, 8, d=48))
    with pytest.raises(ValueError, match="devices"):
        TA.flash_attention_fwd(q.float(), k.float().cpu(), v.float())


@pytest.mark.parametrize("b,h,t,d", [
    (2, 4, 690, 64),      # RoFormer time axis, keys padded to 11 chunks
    (2, 4, 64, 64),       # one whole chunk, no padding
    (140, 8, 62, 64),     # 8 slices per CTA
    (3, 2, 100, 32), (1, 2, 130, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k3_matches_plain(cuda_device, b, h, t, d, dtype):
    """Tables longer than t: the kernel reads only the first t rows."""
    q, k, v = _qkv(cuda_device, getattr(torch, dtype), b, h, t, t, d)
    cos, sin = (x.to(cuda_device) for x in TA.rope_tables(t + 37, d))
    out = TA.attention_nk1_rope(q, k, v, cos, sin)
    ref = TA.attention_nk1_rope_reference(q, k, v, cos, sin, d ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("b,h,tq,tk,d", [
    (2, 4, 62, 62, 64),       # band axis, keys padded: Hopper band route
    (280, 8, 62, 62, 64),     # 2240 slices: every stage of every CTA wraps
    (43, 83, 62, 62, 64),     # 3569 slices, not a multiple of CTAs or stages
    (4, 8, 64, 64, 64),       # one whole tile and chunk
    (3, 5, 1, 1, 64),         # one row, one key
    (2, 3, 33, 5, 64),        # ragged both ways, tq != tk
    (2, 3, 65, 62, 64),       # a second query tile: WMMA core
    (2, 3, 62, 65, 64),       # a second key chunk: WMMA core
    (3, 2, 200, 200, 32), (2, 2, 70, 70, 128)])   # other head dims: WMMA core
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k6_matches_plain(cuda_device, b, h, tq, tk, d, dtype):
    """Each route is hit and shown by ``.sm90_launches``."""
    q, k, v = _qkv(cuda_device, getattr(torch, dtype), b, h, tq, tk, d)
    route = TA.k6_route(b * h, tq, tk, d, q.dtype, True)
    assert route == ("band" if d == 64 and tq <= 64 and tk <= 64 else "core")
    before = (TA.slim_attention.launches, TA.slim_attention.sm90_launches)
    out = TA.slim_attention(q, k, v)
    ref = TA.attention_nk1_reference(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (TA.slim_attention.launches, TA.slim_attention.sm90_launches) == (
        before[0] + 1, before[1] + (route == "band"))
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


def test_k6_takes_the_core_for_bases_tma_cannot_address(cuda_device):
    """q, k and v 2 bytes off a 16-byte boundary go to the WMMA core and
    agree with the plain version; the yardstick entry runs the core at a
    band-route shape (3569 slices) and agrees too."""
    b, h, t = 3, 5, 62
    flat = torch.randn(3, b * h * t * 64 + 1, device=cuda_device).bfloat16()
    q, k, v = (f[1:].view(b, h, t, 64) for f in flat)
    aligned = not any(x.data_ptr() % 16 for x in (q, k, v))
    assert not aligned and q.is_contiguous()
    assert TA.k6_route(b * h, t, t, 64, q.dtype, True) == "band"
    assert TA.k6_route(b * h, t, t, 64, q.dtype, aligned) == "core"
    before = (TA.slim_attention.launches, TA.slim_attention.sm90_launches)
    out = TA.slim_attention(q, k, v)
    ref = TA.attention_nk1_reference(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert (TA.slim_attention.launches, TA.slim_attention.sm90_launches) == (
        before[0] + 1, before[1])
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    q, k, v = _qkv(cuda_device, torch.bfloat16, 43, 83, 62, 62, 64, seed=3)
    before = TA.slim_attention_core.launches
    core = TA.slim_attention_core(q, k, v)
    ref = TA.attention_nk1_reference(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert TA.slim_attention_core.launches == before + 1
    assert (core.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k6_hopper_masks_padded_keys(cuda_device, dtype):
    """Every real score is -98 (see test_k1_hopper_masks_padded_keys): the
    output is the mean of v's rows; an unmasked zero-filled key would take
    the softmax and pull the output toward 0."""
    dt = getattr(torch, dtype)
    t = 62
    q = torch.full((1, 2, t, 64), 3.5, device=cuda_device, dtype=dt)
    k = torch.full((1, 2, t, 64), -3.5, device=cuda_device, dtype=dt)
    v = _qkv(cuda_device, dt, 1, 2, t, t, 64, seed=7)[2]
    before = TA.slim_attention.sm90_launches
    out = TA.slim_attention(q, k, v)
    ref = TA.attention_nk1_reference(q, k, v, 0.125)
    mean = v.float().mean(dim=2, keepdim=True).expand(1, 2, t, 64)
    torch.cuda.synchronize()
    assert TA.slim_attention.sm90_launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    assert (out.float() - mean).abs().max().item() <= _k1_tol(mean)


def _packed_qkv(dev, dtype, b, t, heads, d, layout, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    inner = heads * d
    qkv = torch.randn(b, t, 3 * inner, generator=g, device=dev).to(dtype)
    q, k, v = qkv.split(inner, dim=-1)
    if layout == "packed":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


@pytest.mark.parametrize("b,t,heads,d", [
    (3, 690, 8, 64),      # RoFormer time axis, ragged last query tile; 24 slices
    (20, 690, 8, 64),     # 160 slices: more than one a CTA
    (2, 64, 8, 64),       # one whole tile
    (2, 65, 8, 64),       # one row and one key past a tile
    (2, 768, 3, 64),      # the most keys the time route keeps resident
    (2, 769, 3, 64),      # one more: WMMA core
    (2, 100, 3, 32), (1, 130, 2, 128)])   # other head dims: WMMA core
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("layout", ["packed", "qkv_views"])
def test_k7_matches_plain(cuda_device, b, t, heads, d, dtype, layout):
    """Packed (b, t, heads*d) inputs, contiguous or as views of one fused
    (b, t, 3*heads*d) activation (rows at stride 3*heads*d); each route is
    hit and shown by ``.sm90_launches``."""
    q, k, v = _packed_qkv(cuda_device, getattr(torch, dtype), b, t, heads, d, layout)
    inner = heads * d
    route = TA.k7_route(b, heads, t, d, q.stride(1), q.dtype, True)
    assert route == ("time" if d == 64 and t <= 768 else "core")
    before = (TA.packed_attention.launches, TA.packed_attention.sm90_launches)
    out = TA.packed_attention(q, k, v, heads, d)
    ref = TA.packed_attention_reference(q, k, v, heads, d, d ** -0.5)
    torch.cuda.synchronize()
    assert (TA.packed_attention.launches, TA.packed_attention.sm90_launches) == (
        before[0] + 1, before[1] + (route == "time"))
    assert out.dtype == q.dtype and out.shape == (b, t, inner) and out.is_contiguous()
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


def test_k7_takes_the_core_for_rows_tma_cannot_address(cuda_device):
    """A row stride of 516 elements (1032 bytes) and a base 2 bytes off a
    16-byte boundary both go to the WMMA core and agree with the plain
    version; the yardstick entry runs the core at a Hopper shape."""
    heads, d, b, t = 2, 64, 2, 100
    wide = torch.randn(b, t, 516, device=cuda_device).bfloat16()
    odd = [wide[:, :, :128], wide[:, :, 128:256], wide[:, :, 256:384]]
    flat = torch.randn(3, b * t * 128 + 1, device=cuda_device).bfloat16()
    off = [f[1:].view(b, t, 128) for f in flat]
    for q, k, v in (odd, off):
        aligned = not any(x.data_ptr() % 16 for x in (q, k, v))
        assert TA.k7_route(b, heads, t, d, q.stride(1), q.dtype, aligned) == "core"
        before = (TA.packed_attention.launches, TA.packed_attention.sm90_launches)
        out = TA.packed_attention(q, k, v, heads, d)
        ref = TA.packed_attention_reference(q, k, v, heads, d, 0.125)
        torch.cuda.synchronize()
        assert (TA.packed_attention.launches, TA.packed_attention.sm90_launches) == (
            before[0] + 1, before[1])
        assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    q, k, v = _packed_qkv(cuda_device, torch.bfloat16, 2, 690, 8, 64, "qkv_views")
    assert TA.k7_route(2, 8, 690, 64, q.stride(1), q.dtype, True) == "time"
    core = TA.packed_attention_core(q, k, v, 8, 64)
    ref = TA.packed_attention_reference(q, k, v, 8, 64, 0.125)
    torch.cuda.synchronize()
    assert TA.packed_attention_core.launches >= 1
    assert (core.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("t", [62, 100])    # one ragged chunk, and a whole one before it
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("layout", ["packed", "qkv_views"])
def test_k7_hopper_masks_padded_keys(cuda_device, t, dtype, layout):
    """Every real score is -98: the output is each head's mean of v's rows.
    A zero-filled key left unmasked would score 0 and take the softmax."""
    dt = getattr(torch, dtype)
    b, heads = 2, 3
    q, k, v = _packed_qkv(cuda_device, dt, b, t, heads, 64, layout, seed=7)
    q.fill_(3.5)          # in place: the views keep their strides
    k.fill_(-3.5)
    before = TA.packed_attention.sm90_launches
    out = TA.packed_attention(q, k, v, heads, 64)
    ref = TA.packed_attention_reference(q, k, v, heads, 64, 0.125)
    mean = v.float().mean(dim=1, keepdim=True).expand(b, t, heads * 64)
    torch.cuda.synchronize()
    assert TA.packed_attention.sm90_launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    assert (out.float() - mean).abs().max().item() <= _k1_tol(mean)


@pytest.mark.parametrize("t", [690, 65, 1])
@pytest.mark.parametrize("layout", ["packed", "qkv_views"])
def test_k7_ragged_last_tile_stays_inside_its_batch(cuda_device, t, layout):
    """The last query tile of a batch holds rows at or past t (690 = 10 * 64
    + 50); in the packed layout those would be the next batch's first rows.
    The output buffer holds one batch more than the call and is pre-filled:
    that batch must come back untouched, and every batch of the call must
    agree with the plain version."""
    b, heads = 3, 8
    inner = heads * 64
    q, k, v = _packed_qkv(cuda_device, torch.bfloat16, b, t, heads, 64, layout, seed=t)
    buf = torch.full((b + 1, t, inner), 7.0, device=cuda_device, dtype=torch.bfloat16)
    err = TA._launch_k7_time(q, k, v, buf[:b], heads, q.stride(1), 0.125)
    torch.cuda.synchronize()
    assert err == 0
    assert bool((buf[b] == 7.0).all())
    ref = TA.packed_attention_reference(q, k, v, heads, 64, 0.125)
    assert (buf[:b].float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("d", [96, 512, 2048, 77, 4096])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_plain(cuda_device, d, dtype, kind):
    """d = 77 takes the one-element-a-lane path; the others 16-byte loads."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    dt = getattr(torch, dtype)
    x = (3.0 + torch.randn(1000, d, generator=g, device=cuda_device)).to(dt)
    w = 1.0 + 0.1 * torch.randn(d, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(d, generator=g, device=cuda_device)
    if kind == "rms":
        out, ref = TN.rms_norm(x, w), TN.rms_norm_reference(x, w)
    else:
        out, ref = TN.layer_norm(x, w, b), TN.layer_norm_reference(x, w, b)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == x.shape
    top = ref.float().abs().max().item()
    tol = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}[dtype] * top
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_norms_take_any_leading_shape_and_count(cuda_device):
    TN.reset_launch_counts()
    x = torch.randn(2, 3, 5, 128, device=cuda_device).bfloat16()
    w = torch.ones(128, device=cuda_device)
    out = TN.rms_norm(x[:, 1], w)            # a strided view: made contiguous first
    assert torch.equal(out, TN.rms_norm(x[:, 1].contiguous(), w))
    TN.layer_norm(x, w, torch.zeros(128, device=cuda_device))
    assert (TN.rms_norm.launches, TN.layer_norm.launches) == (2, 1)
    TN.reset_launch_counts()


def test_rope_routes_and_counts(cuda_device):
    """rope + bf16 single block -> K3; rope + causal -> K2 with K3 at 0;
    fp32 + rope -> K2; every route agrees with rope applied up front."""
    TA.reset_launch_counts()
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, 62, 62)
    cos, sin = TA.rope_tables(100, 64)
    out = TA.flash_attention(q, k, v, block_k=64, rope_cos=cos, rope_sin=sin)
    assert (TA.attention_nk1_rope.launches, TA.attention_nk1.launches,
            TA.flash_attention_fwd.launches) == (1, 0, 0)
    ref = TA.attention_nk1_rope_reference(q, k, v, cos, sin, 0.125)
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    TA.flash_attention(q, k, v, causal=True, rope_cos=cos, rope_sin=sin)
    assert (TA.attention_nk1_rope.launches, TA.flash_attention_fwd.launches) == (1, 1)
    q32, k32, v32 = _qkv(cuda_device, torch.float32, 1, 2, 62, 62)
    out = TA.flash_attention(q32, k32, v32, rope_cos=cos, rope_sin=sin)
    assert (TA.attention_nk1_rope.launches, TA.flash_attention_fwd.launches) == (1, 2)
    ref = TA.flash_attention_reference(TA.apply_rope_tables(q32, cos[:62], sin[:62]),
                                       TA.apply_rope_tables(k32, cos[:62], sin[:62]),
                                       v32, False, 0.125)
    assert (out - ref).abs().max().item() <= 2e-5
    assert (TA.slim_attention.launches, TA.packed_attention.launches) == (0, 0)
    TA.slim_attention(q, k, v)
    packed = q.transpose(1, 2).reshape(1, 62, 128)
    TA.packed_attention(packed, packed, packed, 2, 64)
    assert (TA.slim_attention.sm90_launches, TA.packed_attention.sm90_launches) == (1, 1)
    TA.reset_launch_counts()
    assert (TA.slim_attention.sm90_launches, TA.packed_attention.sm90_launches) == (0, 0)


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, 64, 64)
    cos, sin = TA.rope_tables(63, 64)
    with pytest.raises(ValueError, match="rope table"):
        TA.attention_nk1_rope(q, k, v, cos, sin)             # 63 rows for t = 64
    with pytest.raises(ValueError, match="rope table"):
        TA.flash_attention(q, k, v, causal=True, rope_cos=cos, rope_sin=sin)
    with pytest.raises(TypeError):
        TA.attention_nk1_rope(q.float(), k.float(), v.float(), *TA.rope_tables(64, 64))
    with pytest.raises(TypeError):
        TA.slim_attention(q.float(), k.float(), v.float())
    packed = torch.zeros(1, 64, 128, device=cuda_device)
    with pytest.raises(TypeError):
        TA.packed_attention(packed, packed, packed, 2, 64)
    p16 = packed.bfloat16()
    wide = torch.zeros(1, 64, 256, device=cuda_device, dtype=torch.bfloat16)[:, :, :128]
    with pytest.raises(ValueError, match="strides"):
        TA.packed_attention(p16, p16, wide, 2, 64)              # v's rows at another stride
    w = torch.ones(4097, device=cuda_device)
    with pytest.raises(ValueError, match="limit"):
        TN.rms_norm(torch.zeros(2, 4097, device=cuda_device), w)
    with pytest.raises(ValueError, match="limit"):
        TN.layer_norm(torch.zeros(2, 4097, device=cuda_device), w, w)
    with pytest.raises(TypeError):
        TN.rms_norm(torch.zeros(2, 64, device=cuda_device, dtype=torch.float64),
                    torch.ones(64, device=cuda_device))


@pytest.mark.parametrize("tq,tk,causal", [
    (399, 399, False),    # HuBERT: 4 query tiles of 128, the last ragged; 7 key tiles
    (200, 700, False),    # tq != tk, more key tiles than ring stages
    (129, 65, False),     # one row past a CTA's 128, one key past a tile
    (60, 1, False),       # one key; the second warpgroup has no row
    (100, 333, True),     # tq < tk, tk - tq = 233 not a multiple of 64
    (300, 300, True),     # tq = tk: the diagonal crosses every tile
    (130, 200, True),     # tk - tq = 70: the warpgroups stop a tile apart
    (64, 64, True), (1, 77, True),
    (1000, 1000, True)])  # 8 CTAs a slice, up to 16 key tiles: the ring wraps 4 times
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k2_hopper_matches_plain(cuda_device, tq, tk, causal, d, dtype):
    """The 16-bit K2 on the Hopper design, shown by ``.sm90_launches``."""
    q, k, v = _qkv(cuda_device, getattr(torch, dtype), 2, 3, tq, tk, d, seed=tq + tk + d)
    assert TA.k2_route(6, tq, tk, d, q.dtype, causal, True) == "sm90"
    before = (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches)
    out = TA.flash_attention_fwd(q, k, v, causal=causal)
    ref = TA.flash_attention_reference(q, k, v, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("d", [64, 128])
def test_k2_hopper_many_slices_and_core_yardstick(cuda_device, d):
    """More CTAs than the card holds at once (300 slices x 3 query tiles), and
    the row-per-thread-group kernel through its own entry at the same shape."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 20, 15, 333, 333, d, seed=d)
    out = TA.flash_attention_fwd(q, k, v, causal=True)
    before = TA.flash_attention_fwd_core.launches
    core = TA.flash_attention_fwd_core(q, k, v, causal=True)
    ref = TA.flash_attention_reference(q, k, v, True, d ** -0.5)
    torch.cuda.synchronize()
    assert TA.flash_attention_fwd_core.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    assert (core.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("tq,tk", [(100, 62), (100, 130)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k2_hopper_masks_padded_keys(cuda_device, tq, tk, d, dtype):
    """Every real score is -98 (q = 3.5, k = -3.5 over d = 64 at scale 1/8, or
    q = 3.5, k = -1.75 over d = 128): the output is the mean of v's rows.  A
    zero-filled key of the ragged last tile left unmasked would score 0 and
    take the whole softmax."""
    dt = getattr(torch, dtype)
    q = torch.full((1, 2, tq, d), 3.5, device=cuda_device, dtype=dt)
    k = torch.full((1, 2, tk, d), -3.5 * 64 / d, device=cuda_device, dtype=dt)
    v = _qkv(cuda_device, dt, 1, 2, tk, tk, d, seed=7)[2]
    before = TA.flash_attention_fwd.sm90_launches
    out = TA.flash_attention_fwd(q, k, v, scale=0.125)
    ref = TA.flash_attention_reference(q, k, v, False, 0.125)
    mean = v.float().mean(dim=2, keepdim=True).expand(1, 2, tq, d)
    torch.cuda.synchronize()
    assert TA.flash_attention_fwd.sm90_launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    assert (out.float() - mean).abs().max().item() <= _k1_tol(mean)


def test_k2_hopper_causal_more_queries_than_keys(cuda_device):
    """tq > tk under causal: the first tq - tk rows see no key and get the
    mean of v, as the plain version gives them; every row agrees with it."""
    tq, tk = 200, 130
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, tq, tk, 64, seed=5)
    before = TA.flash_attention_fwd.sm90_launches
    out = TA.flash_attention_fwd(q, k, v, causal=True)
    ref = TA.flash_attention_reference(q, k, v, True, 0.125)
    torch.cuda.synchronize()
    assert TA.flash_attention_fwd.sm90_launches == before + 1
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("route", ["k2f_kernel", "k2h_kernel", "k2_kernel"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("entry", ["flash_attention_fwd", "flash_attention"])
@pytest.mark.parametrize("tq,tk", [(200, 130), (77, 1), (300, 64)])
def test_k2_causal_keyless_rows_take_the_mean_of_v(cuda_device, route, d, entry, tq, tk):
    """Each CUDA route of K2 with tq > tk under causal: the first tq - tk
    rows are the mean of v (fp32 on ``k2f_kernel``, bf16 on the others:
    ``k2_kernel`` through the bf16 call with a negative scale, which the
    wrapper keeps off the Hopper design), the rest the plain version's."""
    dt = torch.float32 if route == "k2f_kernel" else torch.bfloat16
    scale = -(d ** -0.5) if route == "k2_kernel" else d ** -0.5
    q, k, v = _qkv(cuda_device, dt, 2, 3, tq, tk, d, seed=tq + d)
    before = (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches)
    fn = TA.flash_attention_fwd if entry == "flash_attention_fwd" else TA.flash_attention
    out = fn(q, k, v, causal=True, scale=scale)
    ref = TA.flash_attention_reference(q, k, v, True, scale)
    mean = v.float().mean(dim=2, keepdim=True).expand(2, 3, tq - tk, d)
    torch.cuda.synchronize()
    hopper = 1 if route == "k2h_kernel" else 0
    assert (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches) == (
        before[0] + 1, before[1] + hopper)
    assert out.dtype == dt and out.shape == q.shape and bool(torch.isfinite(out).all())
    tol = 2e-5 if dt == torch.float32 else _k1_tol(ref)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    head = out[:, :, : tq - tk].float()
    assert (head - mean).abs().max().item() <= (2e-5 if dt == torch.float32 else _k1_tol(mean))


@pytest.mark.parametrize("d", [80, 256, 32])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k2_takes_the_core_for_other_head_dims(cuda_device, d, dtype):
    q, k, v = _qkv(cuda_device, getattr(torch, dtype), 2, 3, 150, 260, d, seed=d)
    assert TA.k2_route(6, 150, 260, d, q.dtype, True, True) == "core"
    before = (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches)
    out = TA.flash_attention_fwd(q, k, v, causal=True)
    ref = TA.flash_attention_reference(q, k, v, True, d ** -0.5)
    torch.cuda.synchronize()
    assert (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches) == (
        before[0] + 1, before[1])
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


def test_k2_takes_the_core_for_bases_tma_cannot_address(cuda_device):
    """q, k and v 2 bytes off a 16-byte boundary, and fp32 inputs, stay off
    the Hopper design and agree with the plain version."""
    b, h, t, d = 2, 3, 150, 64
    flat = torch.randn(3, b * h * t * d + 1, device=cuda_device).bfloat16()
    q, k, v = (f[1:].view(b, h, t, d) for f in flat)
    aligned = not any(x.data_ptr() % 16 for x in (q, k, v))
    assert not aligned and q.is_contiguous()
    assert TA.k2_route(b * h, t, t, d, q.dtype, False, aligned) == "core"
    before = (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches)
    out = TA.flash_attention_fwd(q, k, v)
    ref = TA.flash_attention_reference(q, k, v, False, 0.125)
    TA.flash_attention_fwd(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches) == (
        before[0] + 2, before[1])
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


def test_k2_takes_the_core_for_a_negative_scale(cuda_device):
    """The Hopper kernel takes the row max over the raw scores, which holds
    only for a scale that is not negative: a negative one stays off it."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 3, 150, 260, 64, seed=11)
    before = (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches)
    out = TA.flash_attention_fwd(q, k, v, causal=True, scale=-0.125)
    zero = TA.flash_attention_fwd(q, k, v, causal=True, scale=0.0)
    ref = TA.flash_attention_reference(q, k, v, True, -0.125)
    ref0 = TA.flash_attention_reference(q, k, v, True, 0.0)
    torch.cuda.synchronize()
    assert (TA.flash_attention_fwd.launches, TA.flash_attention_fwd.sm90_launches) == (
        before[0] + 2, before[1] + 1)
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    assert (zero.float() - ref0.float()).abs().max().item() <= _k1_tol(ref0)


@pytest.mark.parametrize("bh,tq,tk", [
    ((2, 4), 690, 690),    # RoFormer time axis: 11 chunks roped once, 11 query tiles
    ((40, 8), 690, 690),   # 320 slices: more than one a CTA, barrier phases wrap
    ((2, 3), 100, 100),    # a ragged second chunk and tile
    ((2, 3), 65, 65),      # one row and one key past a tile
    ((2, 3), 40, 300),     # tq != tk; one query tile: the second warpgroup only ropes
    ((2, 3), 300, 40),     # one chunk: the second warpgroup ropes nothing
    ((1, 3), 200, 768),    # the most keys kept resident
    ((3, 50), 62, 62)])    # band-shaped: the time design over one chunk
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("tables", ["rope", "random"])
def test_k3_hopper_route_matches_plain(cuda_device, bh, tq, tk, dtype, tables):
    """K3 on the rope variant of the Hopper time design, shown by
    ``.sm90_launches``.  The tables hold more rows than max(tq, tk); the
    random ones have halves that differ, which rope's own tables never do."""
    q, k, v = _qkv(cuda_device, getattr(torch, dtype), *bh, tq, tk, 64, seed=tq + tk)
    rows = max(tq, tk) + 37
    if tables == "rope":
        cos, sin = (x.to(cuda_device) for x in TA.rope_tables(rows, 64))
    else:
        g = torch.Generator(device=cuda_device).manual_seed(rows)
        cos, sin = (torch.randn(rows, 64, generator=g, device=cuda_device) for _ in range(2))
    assert TA.k3_route(bh[0] * bh[1], tq, tk, 64, q.dtype, True) == "time"
    before = (TA.attention_nk1_rope.launches, TA.attention_nk1_rope.sm90_launches)
    out = TA.attention_nk1_rope(q, k, v, cos, sin)
    ref = TA.attention_nk1_rope_reference(q, k, v, cos, sin, 0.125)
    torch.cuda.synchronize()
    assert (TA.attention_nk1_rope.launches, TA.attention_nk1_rope.sm90_launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


def test_k3_takes_the_core_off_the_hopper_shapes(cuda_device):
    """d = 32, tk = 800, and tables 4 bytes off a 16-byte boundary go to the
    WMMA core and agree with the plain version; the yardstick entry runs the
    core at a Hopper shape."""
    cases = []
    for tq, tk, d in ((100, 100, 32), (70, 800, 64)):
        q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, tq, tk, d, seed=tk)
        cos, sin = (x.to(cuda_device) for x in TA.rope_tables(max(tq, tk), d))
        assert TA.k3_route(2, tq, tk, d, q.dtype, True) == "core"
        cases.append((q, k, v, cos, sin, d))
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 2, 100, 100, 64, seed=9)
    flat = torch.randn(2, 100 * 64 + 1, device=cuda_device)
    cos, sin = (f[1:].view(100, 64) for f in flat)
    assert cos.is_contiguous() and cos.data_ptr() % 16 != 0
    cases.append((q, k, v, cos, sin, 64))
    for q, k, v, cos, sin, d in cases:
        before = (TA.attention_nk1_rope.launches, TA.attention_nk1_rope.sm90_launches)
        out = TA.attention_nk1_rope(q, k, v, cos, sin)
        ref = TA.attention_nk1_rope_reference(q, k, v, cos, sin, d ** -0.5)
        torch.cuda.synchronize()
        assert (TA.attention_nk1_rope.launches, TA.attention_nk1_rope.sm90_launches) == (
            before[0] + 1, before[1])
        assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 4, 690, 690, 64, seed=3)
    cos, sin = (x.to(cuda_device) for x in TA.rope_tables(690, 64))
    before = TA.attention_nk1_rope_core.launches
    core = TA.attention_nk1_rope_core(q, k, v, cos, sin)
    ref = TA.attention_nk1_rope_reference(q, k, v, cos, sin, 0.125)
    torch.cuda.synchronize()
    assert TA.attention_nk1_rope_core.launches == before + 1
    assert (core.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("tq", [62, 100])
def test_k3_hopper_masks_padded_keys(cuda_device, tq):
    """Unit tables (cos 1, sin 0) make rope the identity; every real score is
    -98 and the output the mean of v's rows: the zero-filled keys of the
    ragged chunk stay masked after the in-place rope."""
    tk = 62
    q = torch.full((1, 2, tq, 64), 3.5, device=cuda_device, dtype=torch.bfloat16)
    k = torch.full((1, 2, tk, 64), -3.5, device=cuda_device, dtype=torch.bfloat16)
    v = _qkv(cuda_device, torch.bfloat16, 1, 2, tk, tk, 64, seed=7)[2]
    cos = torch.ones(128, 64, device=cuda_device)
    sin = torch.zeros(128, 64, device=cuda_device)
    before = TA.attention_nk1_rope.sm90_launches
    out = TA.attention_nk1_rope(q, k, v, cos, sin)
    mean = v.float().mean(dim=2, keepdim=True).expand(1, 2, tq, 64)
    torch.cuda.synchronize()
    assert TA.attention_nk1_rope.sm90_launches == before + 1
    assert (out.float() - mean).abs().max().item() <= _k1_tol(mean)


@pytest.mark.parametrize("op", ["linear", "einsum_rel", "einsum_scores", "conv1d_grouped",
                                "conv1d_decoder", "conv_transpose1d"])
def test_bf16_policy_on_the_card(cuda_device, op):
    """``matmul_precision("bfloat16")`` on the card: linear layers and einsums
    through the bf16 GEMM with an fp32 result, convolutions as TF32 ones on
    the rounded operands (TF32 holds a bf16 value exactly); each equals the
    fp32 op of the bf16-rounded operands with TF32 off to 1e-5 of max|out|
    (fp32 sums in another order), is not rounded to bf16, and leaves TF32
    off."""
    from audiolab_tpu_torch.core import precision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(3)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=cuda_device)

    x, w, call = {
        "linear": (t(3, 40, 768), t(256, 768), lambda a, b: precision.linear(a, b)),
        "einsum_rel": (t(2, 3, 20, 16), t(1, 39, 16),
                       lambda a, b: precision.einsum("bhqd,xmd->bhqm", a, b)),
        "einsum_scores": (t(2, 3, 20, 16), t(2, 3, 25, 16),
                          lambda a, b: precision.einsum("bhqd,bhkd->bhqk", a, b)),
        "conv1d_grouped": (t(2, 32, 49), 0.1 * t(32, 2, 128),
                           lambda a, b: precision.conv1d(a, b, padding=64, groups=16)),
        "conv1d_decoder": (t(2, 512, 2000), 0.05 * t(256, 512, 7),
                           lambda a, b: precision.conv1d(a, b, padding=3)),
        "conv_transpose1d": (t(2, 16, 30), t(16, 8, 8),
                             lambda a, b: precision.conv_transpose1d(a, b, stride=4,
                                                                     padding=2)),
    }[op]
    with precision.matmul_precision("bfloat16"):
        low = call(x, w)
    expect = call(x.bfloat16().float(), w.bfloat16().float())
    torch.cuda.synchronize()
    big = expect.abs().max().item()
    assert low.dtype == torch.float32 and low.shape == expect.shape
    assert (low - expect).abs().max().item() <= 1e-5 * big
    assert (low - expect.bfloat16().float()).abs().max().item() > 1e-4 * big
    assert not torch.backends.cudnn.allow_tf32
