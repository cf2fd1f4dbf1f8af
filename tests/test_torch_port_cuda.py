"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (decided inside the fixture, never at import).  The file imports no
JAX, so it runs where JAX is not installed; on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

``.sm90_launches`` shows which design a call of K1, K2, K3, K6 or K7 ran on.

Tolerances: K1, K3, K6, K7 and the 16-bit K2 to 2 bf16 ulps of max|out| (the
sums run in another order, which may flip an output's or a probability's
rounding); K2 (fp32) to 2e-5 (fp32 sums over a few hundred
keys in another order), and at Dia's scale 1.0 to 4e-5 of max|out| (the
unscaled scores reach ~50); K4 and K5 to 1 ulp of max|out| in 16-bit types
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
    ((2, 16), 108, 108),  # ACE-Step's DiT at 10 s: CFG 2 x 16 heads, every key in one block
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
                                "conv1d_decoder", "conv_transpose1d", "conv2d",
                                "conv_transpose2d"])
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
        # MDX23C's 3x3 convolution at its top scale and its (2, 2) upscale
        "conv2d": (t(2, 128, 64, 128), 0.05 * t(128, 128, 3, 3),
                   lambda a, b: precision.conv2d(a, b, padding=1)),
        "conv_transpose2d": (t(2, 256, 32, 64), 0.05 * t(256, 128, 2, 2),
                             lambda a, b: precision.conv_transpose2d(a, b, stride=2)),
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


def test_processor_chain_on_the_card_matches_the_cpu(cuda_device, tmp_path, monkeypatch):
    """Separate (a tiny fp32 BS-RoFormer) -> Clone (a tiny v2 converter,
    rmvpe+, no index) -> Export -> Merge through ``run_chain`` on the card and
    on the CPU, same seeded weights and WAV, fp32 products, the synthesizer's
    noise zeroed.  The merged tracks agree to mel-L1 < 1e-2 (BASELINE.md's
    gate): fp32 sums in another order may flip RMVPE's argmax on a near-tie
    frame of random weights, so no per-sample bound is held."""
    import copy

    import numpy as np

    from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
    from audiolab_tpu_torch.kernels.mel import log_mel, mel_spectrogram
    from audiolab_tpu_torch.models.hubert import HubertConfig, HubertFeatureExtractor
    from audiolab_tpu_torch.models.rmvpe import RMVPE
    from audiolab_tpu_torch.models.rvc import synthesizer as TSy
    from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig
    from audiolab_tpu_torch.pipelines.chain import run_chain
    from audiolab_tpu_torch.pipelines.processors.clone import Clone
    from audiolab_tpu_torch.pipelines.processors.separate import Separate
    from audiolab_tpu_torch.pipelines.rvc import RVCPipelineConfig, VoiceConverter
    from audiolab_tpu_torch.pipelines.separate import EnsembleMember, StemSeparator

    monkeypatch.setattr(TSy, "_randn", lambda shape, gen, device: torch.zeros(shape,
                                                                              device=device))
    torch.manual_seed(0)
    roformer = BSRoformer(RoformerConfig(
        dim=32, depth=2, heads=2, dim_head=16, freqs_per_bands=(16, 16, 32, 65), n_fft=256,
        hop=64, dtype="float32", stems=("vocals",), residual_stem="other")).eval()
    synth = TSy.SynthesizerTrn(TSy.SynthesizerConfig(
        spec_channels=129, segment_size=3840, inter_channels=16, hidden_channels=16,
        filter_channels=32, n_heads=2, n_layers=1, upsample_initial_channel=32,
        spk_embed_dim=4, gin_channels=16, sr=48000, feat_channels=32)).eval()
    hubert = HubertFeatureExtractor("v2", HubertConfig(dim=32, ffn_dim=64, heads=4, layers=2,
                                                       final_dim=16)).eval()
    rmvpe = RMVPE(dtype=None, en_de_layers=2, inter_layers=1, n_blocks=1, en_out_channels=4,
                  gru_hidden=8).eval()
    sr = 44100
    t = np.arange(sr) / sr
    tone = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    x = np.stack([tone, 0.8 * tone]) + 0.05 * np.random.default_rng(0).standard_normal((2, sr))
    song = str(tmp_path / "song.wav")
    write_wav(song, x.astype(np.float32), sr)

    merged = {}
    try:
        for dev in ("cpu", "cuda"):
            Separate.configure(StemSeparator(
                [EnsembleMember("m", copy.deepcopy(roformer))], sr=sr, chunk_seconds=0.3,
                overlap_seconds=0.05, device_batch=2, matmul_precision="highest", device=dev))
            Clone.configure(VoiceConverter(
                copy.deepcopy(synth), copy.deepcopy(hubert), copy.deepcopy(rmvpe), device=dev,
                cfg=RVCPipelineConfig(sr=48000, chunk_seconds=0.5, overlap_seconds=0.1,
                                      device_batch=2, matmul_precision="highest")))
            projs = run_chain(["Separate", "Clone", "Export", "Merge"], [song],
                              output_root=str(tmp_path / dev), device=dev)
            assert [p.rsplit("/", 1)[-1] for p in projs[0].last_outputs] == ["song_merged.wav"]
            merged[dev] = read_audio(projs[0].last_outputs[0]).samples
    finally:
        Separate.configure(None)
        Clone.configure(None)

    a, b = merged["cuda"], merged["cpu"]
    assert a.shape == b.shape == (2, sr) and np.isfinite(a).all() and np.abs(b).max() > 1e-3

    def logmel(y):
        return log_mel(mel_spectrogram(torch.from_numpy(np.ascontiguousarray(y))[None],
                                       sr=sr, n_fft=1024, hop=256, n_mels=80, power=1.0))

    assert max(float((logmel(a[c]) - logmel(b[c])).abs().mean()) for c in range(2)) < 1e-2


def _seeded(module, seed: int, scale: float = 0.1):
    """``module`` with every float parameter moved off its initial value by
    N(0, scale) from a generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g))
    return module.eval()


def _family_case(name):
    """(callable (b, 2, n) -> tensor on the input's device, fp32 input): the
    tiny HTDemucs and MDX23C of the CPU parity tests, and a miniature
    TFC-TDF U-Net graph through the ONNX runner."""
    import numpy as np

    from audiolab_tpu_torch.models.separation import htdemucs as THt
    from audiolab_tpu_torch.models.separation import mdx23c as TMc
    from audiolab_tpu_torch.utils import onnx as TOnnx

    rng = np.random.default_rng(4)

    def r(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    if name == "htdemucs":
        model = _seeded(THt.HTDemucs(THt.HTDemucsConfig(
            sources=("vocals", "other"), channels=4, nfft=128, depth=2, norm_starts=0,
            norm_groups=2, dconv_comp=2, bottom_channels=8, t_layers=3, t_heads=2,
            t_hidden_scale=2.0, segment_seconds=1.0, samplerate=800)), 1)
        return model, torch.from_numpy(r(2, 2, 1000))
    if name == "mdx23c":
        model = _seeded(TMc.TFCTDFNetV3(TMc.MDX23CConfig(
            sample_rate=8000, n_fft=256, hop_length=64, dim_f=128, num_subbands=2,
            num_scales=2, num_blocks_per_scale=1, channels=8, growth=8,
            bottleneck_factor=2)), 2)
        return model, torch.from_numpy(r(2, 2, model.good_length(0.25)))
    nodes = [("Conv", ["x", "w0", "b0"], ["s"], {}), ("Relu", ["s"], ["h"], {}),
             ("Conv", ["h", "w1", "b1"], ["t0"], {"pads": [1, 1, 1, 1]}),
             ("MatMul", ["t0", "w2"], ["d0"], {}), ("Relu", ["d0"], ["d1"], {}),
             ("MatMul", ["d1", "w3"], ["d2"], {}), ("Add", ["h", "d2"], ["hs"], {}),
             ("Conv", ["hs", "w4", "b4"], ["dn"], {"strides": [2, 2]}),
             ("ConvTranspose", ["dn", "w5", "b5"], ["u"], {"strides": [2, 2]}),
             ("Concat", ["hs", "u"], ["cat"], {"axis": 1}),
             ("Conv", ["cat", "w6", "b6"], ["y"], {})]
    inits = {"w0": r(8, 4, 1, 1), "b0": r(8), "w1": r(8, 8, 3, 3), "b1": r(8),
             "w2": r(16, 4), "w3": r(4, 16), "w4": r(16, 8, 2, 2), "b4": r(16),
             "w5": r(16, 8, 2, 2), "b5": r(8), "w6": r(4, 16, 1, 1), "b6": r(4)}
    runner = TOnnx.OnnxRunner(TOnnx.parse_model(TOnnx.build_model(
        [TOnnx.OnnxNode(*n) for n in nodes], inits, ["x"], ["y"])))
    return (lambda x: runner(x=x)[0]), torch.from_numpy(r(2, 4, 32, 16))


@pytest.mark.parametrize("policy", ["highest", "bfloat16"])
@pytest.mark.parametrize("name", ["htdemucs", "mdx23c", "onnx"])
def test_separator_family_on_the_card_matches_the_cpu(cuda_device, name, policy):
    """The tiny HTDemucs, MDX23C and ONNX U-Net on the card against the CPU on
    the same weights and input: fp32 products to 1e-4 of max|y| (sums in
    another order); under the bf16 policy to 1e-2 of max|y| (the operands are
    the same bf16 values, but a sum in another order may move a later
    layer's input across a bf16 rounding boundary)."""
    import copy

    from audiolab_tpu_torch.core import precision
    from audiolab_tpu_torch.core.device import resolve_device

    resolve_device(cuda_device)           # the policy's TF32 flags
    fn, x = _family_case(name)
    card_fn = copy.deepcopy(fn).to(cuda_device) if isinstance(fn, torch.nn.Module) else fn
    with torch.no_grad(), precision.matmul_precision(policy):
        ref = fn(x)
        out = card_fn(x.to(cuda_device))
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and out.shape == ref.shape
    assert torch.isfinite(out).all()
    tol = 1e-4 if policy == "highest" else 1e-2
    assert (out.cpu() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("n_fft,hop", [(8192, 1024), (4096, 1024), (400, 160)])
def test_istft_of_a_written_spectrum_matches_the_cpu(cuda_device, n_fft, hop):
    """A spectrum a network wrote has imaginary parts on its DC and Nyquist
    bins; cuFFT's real inverse would use them where the CPU's ignores them,
    so ``istft`` drops them first: the card agrees with the CPU to 1e-5 of
    max|y|."""
    from audiolab_tpu_torch.kernels.stft import istft

    g = torch.Generator().manual_seed(5)
    r, i = (torch.randn(2, 30, n_fft // 2 + 1, generator=g) for _ in range(2))
    ref = istft(r, i, n_fft=n_fft, hop=hop)
    out = istft(r.to(cuda_device), i.to(cuda_device), n_fft=n_fft, hop=hop)
    torch.cuda.synchronize()
    assert (out.cpu() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


TRAIN_SYNTH = dict(spec_channels=129, segment_size=3840, inter_channels=16, hidden_channels=16,
                   filter_channels=32, n_heads=2, n_layers=1, upsample_initial_channel=32,
                   spk_embed_dim=4, gin_channels=16, sr=48000, feat_channels=32)


def _train_batch(cfg, b=2, t=16, seed=0):
    """tests/test_train.py's make_batch in torch (numpy-seeded)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))   # noqa: E731
    return dict(phone=f(rng.standard_normal((b, t, cfg.feat_channels))),
                phone_lengths=torch.full((b,), t), pitch=torch.from_numpy(rng.integers(1, 255, (b, t))),
                pitchf=f(rng.uniform(80, 400, (b, t))),
                spec=f(rng.standard_normal((b, t, cfg.spec_channels)) ** 2),
                spec_lengths=torch.full((b,), t),
                wave=f(rng.standard_normal((b, t * cfg.upp)) * 0.1),
                sid=torch.zeros(b, dtype=torch.long))


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One train step of the tiny configuration (periods 2, 3) in fp32 on the
    card and on the CPU against the same step in fp64 on the CPU, same
    weights, batch and draws, the reference's leaky ReLU sides and
    excitation phase replayed: on each device the six metrics to 1e-4
    relative and every gradient tensor to 1e-4 of its own max|g|, a bias to
    1e-4 of the larger of its own and its layer weight's, on the card or to
    twice the CPU's distance where that is larger, the phases within twice
    an fp32 cumsum's bound (the rules and their reasons in
    audiolab_tpu_torch/train/check.py).  No kernel is launched."""
    from audiolab_tpu_torch.models.rvc import synthesizer as TSy
    from audiolab_tpu_torch.train.check import GATE, step_against

    assert GATE == 1e-4
    cfg = TSy.SynthesizerConfig(**TRAIN_SYNTH)
    draws = TSy.TrainDraws.sample(cfg, 2, 16, torch.Generator().manual_seed(3))
    TA.reset_launch_counts()
    TN.reset_launch_counts()
    recs = step_against(cfg, _train_batch(cfg), draws, (cuda_device, "cpu"), periods=(2, 3))
    assert all(f.launches == 0 for f in (TA.attention_nk1, TA.flash_attention_fwd,
                                         TA.attention_nk1_rope, TA.slim_attention,
                                         TA.packed_attention, TN.rms_norm, TN.layer_norm))
    assert recs["cpu"]["grad_err"] <= 1e-4, recs
    for rec in recs.values():
        assert rec["metric_err"] <= 1e-4, recs
        assert rec["grad_allowed_err"] <= 1.0, recs
        assert rec["phase_err"] <= rec["phase_bound"], recs


def test_extract_features_launches_fp32_k2(cuda_device, tmp_path):
    """The dataset pipeline's HuBERT on the card: one fp32 K2 launch per
    layer and group of 8 slices, features and f0 as on the CPU (1e-4 of
    max|feature|, f0 to 1e-2 Hz)."""
    import numpy as np

    from audiolab_tpu_torch.core.audio_io import write_wav
    from audiolab_tpu_torch.train.data import extract_features
    from audiolab_tpu_torch.train.rvc_train import _hubert_apply_for

    rng = np.random.default_rng(0)
    (tmp_path / "16k_wavs").mkdir()
    t = np.arange(12800) / 16000
    for i in range(11):       # groups of 8 and 3
        x = 0.3 * np.sin(2 * np.pi * (120 + 20 * i) * t) + 0.01 * rng.standard_normal(len(t))
        write_wav(str(tmp_path / "16k_wavs" / f"0_0_{i}.wav"), x.astype(np.float32), 16000)
    settings = {"feat_channels": 128}          # 2 layers, 2 heads of 64
    out = {}
    for dev in ("cpu", cuda_device):
        exp = tmp_path / str(dev)
        exp.mkdir()
        (exp / "16k_wavs").symlink_to(tmp_path / "16k_wavs")
        TA.reset_launch_counts()
        assert extract_features(str(exp), _hubert_apply_for(settings, dev), device=dev) == 11
        out[str(dev)] = (exp, TA.flash_attention_fwd.launches)
    assert out["cpu"][1] == 0 and out["cuda"][1] == 2 * 2
    for p in sorted((out["cpu"][0] / "feats").glob("*.npy")):
        ref, got = np.load(p), np.load(out["cuda"][0] / "feats" / p.name)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
        ref, got = np.load(out["cpu"][0] / "f0" / p.name), np.load(out["cuda"][0] / "f0" / p.name)
        assert np.abs(got - ref).max() <= 1e-2


def _zonos_model(mixer, dev, seed=0):
    """A Zonos model at test width (tests/torch_port_tiny.py's ZONOS) with
    torch's default weights from ``seed`` moved by 0.3 N(0, 1) noise, fp32."""
    from audiolab_tpu_torch.models.zonos import ZonosConfig, ZonosModel

    cfg = ZonosConfig(dim=32, n_layers=3, attn_every=3, n_heads=4, d_state=4, n_codebooks=3,
                      codebook_size=34, spk_dim=16, headdim=16, mixer=mixer)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = ZonosModel(cfg)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.3 * torch.randn(p.shape))
    return model.to(dev).eval()


def _zonos_inputs(cfg, b=2, t_text=6, seed=1):
    import numpy as np

    r = np.random.default_rng(seed)
    return dict(text_ids=r.integers(1, cfg.vocab_text, (b, t_text)).astype(np.int32),
                spk_emb=r.standard_normal((b, cfg.spk_dim)).astype(np.float32),
                emotion=r.random((b, 8)).astype(np.float32))


@pytest.mark.parametrize("mixer", ["mamba1", "mamba2"])
def test_zonos_graph_decode_equals_eager(cuda_device, mixer):
    """The captured decode step replayed for every frame gives the eager
    loop's codes under the same draws, on two calls with other draws (each
    captures its own step); the prefill launches K2 once per attention
    layer, on the fp32 kernel."""
    from audiolab_tpu_torch.models.zonos import generate, gumbel_draws

    model = _zonos_model(mixer, cuda_device)
    x = _zonos_inputs(model.cfg)
    total, rows, vocab = 20 + 3, 2 * 3, 34
    for seed in (4, 5):
        draws = gumbel_draws(total, rows, vocab, seed, cuda_device)
        TA.reset_launch_counts()
        g = generate(model, max_frames=20, draws=draws, graph=True, **x)
        assert TA.flash_attention_fwd.launches == 1
        assert TA.flash_attention_fwd.sm90_launches == 0
        e = generate(model, max_frames=20, draws=draws, graph=False, **x)
        assert torch.equal(g, e)


@pytest.mark.parametrize("mixer", ["mamba1", "mamba2"])
def test_zonos_logits_on_the_card_match_the_cpu(cuda_device, mixer):
    """Prefill and 8 teacher-forced decode steps in fp32 (TF32 off): the
    card's logits within 1e-4 of max|logit| of the CPU's."""
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy

    apply_policy()
    x = _zonos_inputs(_zonos_model(mixer, "cpu").cfg)
    codes = np.random.default_rng(2).integers(0, 32, (8, 4, 3))
    out = {}
    for dev in ("cpu", cuda_device):
        model = _zonos_model(mixer, dev)
        c = model.cfg
        ids = torch.as_tensor(np.concatenate([x["text_ids"], 0 * x["text_ids"]]),
                              dtype=torch.long, device=dev)
        spk = torch.as_tensor(np.concatenate([x["spk_emb"]] * 2), device=dev)
        em = torch.as_tensor(np.concatenate([x["emotion"]] * 2), device=dev)
        rate, pitch = torch.full((4, 1), 15.0, device=dev), torch.full((4, 1), 20.0, device=dev)
        bos = torch.full((4, c.n_codebooks, 1), c.masked_id, dtype=torch.long, device=dev)
        with torch.no_grad():
            logits, states, plen = model.prefill(ids, spk, em, rate, pitch, bos, 6 + 5 + 8 + 2)
            seq = [logits]
            for i, ct in enumerate(codes):
                seq.append(model.decode_step(torch.as_tensor(ct, device=dev),
                                             torch.tensor([plen + i], device=dev), states))
        out[str(dev)] = torch.stack(seq).cpu()
    ref = out["cpu"]
    assert (out["cuda"] - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("frames", [20, 51])
def test_zonos_dac_on_the_card_matches_the_cpu(cuda_device, frames):
    """The DAC decoder at the published rates (8, 8, 4, 2) and test width
    on cuDNN (the flax-crop transposed convolutions, Snake, the tanh):
    codes -> audio on the card within 1e-5 of max|y| of the CPU's, fp32
    with TF32 off."""
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy
    from audiolab_tpu_torch.models.codecs import DACConfig, DACDecoder

    apply_policy()
    cfg = DACConfig(dim=16, rates=(8, 8, 4, 2), n_q=3, codebook_size=34, codebook_dim=8,
                    decoder_dim=32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        dac = DACDecoder(cfg)      # torch's initialisers: peak |y| about 0.3, no clipping
    codes = torch.as_tensor(np.random.default_rng(4).integers(0, 34, (2, 3, frames)))
    with torch.no_grad():
        ref = dac.eval()(codes)
        out = dac.to(cuda_device)(codes.to(cuda_device)).cpu()
    assert out.shape == ref.shape == (2, frames * 512) and torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_zonos_capture_survives_card_work_in_another_thread(cuda_device):
    """While generate captures and replays its decode step (five calls,
    each its own capture), a second thread does what a training job's
    loader does outside the inference lock: pageable host-to-device copies
    of new sizes, a reduction and reads back to the host, in a loop.  Both
    threads finish without error and every call's codes equal the eager
    loop's with no second thread.  (With the capture's default
    ``capture_error_mode="global"`` the loader's host reads are prohibited
    while a capture lasts, and one of the two threads fails.)"""
    import threading

    import numpy as np

    from audiolab_tpu_torch.models.zonos import generate, gumbel_draws

    model = _zonos_model("mamba1", cuda_device)
    x = _zonos_inputs(model.cfg)
    draws = gumbel_draws(40 + 3, 2 * 3, 34, 6, cuda_device)
    ref = generate(model, max_frames=40, draws=draws, graph=False, **x)
    stop, errors, loops = threading.Event(), [], [0]

    def loader():
        rng = np.random.default_rng(0)
        try:
            while not stop.is_set():
                n = 4096 * (1 + loops[0] % 13)
                batch = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                dev = batch.to(cuda_device)
                float((dev * dev).sum().item())
                dev[:16].cpu()
                loops[0] += 1
        except Exception as e:      # noqa: BLE001 - the test reports it
            errors.append(e)

    th = threading.Thread(target=loader, daemon=True)
    th.start()
    try:
        while loops[0] < 20:        # the loader is running before the first capture
            th.join(0.01)
        outs = [generate(model, max_frames=40, draws=draws, graph=True, **x) for _ in range(5)]
    finally:
        stop.set()
        th.join(60)
    assert not th.is_alive() and not errors, errors
    assert loops[0] > 100
    for g in outs:
        assert torch.equal(g, ref)


def test_openvoice_on_the_card_matches_the_cpu(cuda_device):
    """The tone-color converter at test width (torch's initialisers moved by
    seeded noise), fp32 with TF32 off: extract_se within 1e-5 and the
    chunked conversion within 1e-4 of max|y| of the CPU's."""
    import copy

    import numpy as np

    from audiolab_tpu_torch.models.openvoice import ToneColorConfig, ToneColorConverter
    from audiolab_tpu_torch.pipelines.cloning import OpenVoiceCloneConfig, OpenVoiceCloner

    cfg = ToneColorConfig(sr=8000, n_fft=128, hop=32, spec_channels=65, inter_channels=8,
                          hidden_channels=8, gin_channels=16, upsample_rates=(4, 4, 2),
                          upsample_kernel_sizes=(8, 8, 4), upsample_initial_channel=32)
    torch.manual_seed(5)
    model = _seeded(ToneColorConverter(cfg), 5, 0.05)
    rng = np.random.default_rng(3)
    src = (0.3 * np.sin(2 * np.pi * 220 * np.arange(10400) / 8000)
           + 0.02 * rng.standard_normal(10400)).astype(np.float32)
    ref = (0.1 * rng.standard_normal(9600)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda_device):
        cl = OpenVoiceCloner(copy.deepcopy(model), OpenVoiceCloneConfig(0.5, 0.1), device=dev)
        out[str(dev)] = (cl.extract_se(ref, 16000), cl.convert(src, 8000, ref, 16000)[0])
    (g0, y0), (g1, y1) = out["cpu"], out["cuda"]
    assert np.abs(g1 - g0).max() <= 1e-5 * np.abs(g0).max()
    assert y1.shape == y0.shape == src.shape and np.abs(y0).max() > 1e-3
    assert np.abs(y1 - y0).max() <= 1e-4 * np.abs(y0).max()


def test_crepe_on_the_card_matches_the_cpu(cuda_device):
    """CREPE 'tiny' (seeded weights, batch-norm statistics in [0.5, 1.5))
    on 1 s of a glide, fp32 with TF32 off: salience within 1e-5 of the
    CPU's, and the decoded f0 within 1e-4 Hz wherever the two paths agree
    bin for bin (all frames, on this input)."""
    import copy

    import numpy as np

    from audiolab_tpu_torch.models.crepe import Crepe, CrepePredictor

    torch.manual_seed(6)
    net = _seeded(Crepe("tiny"), 6, 0.3)
    with torch.no_grad():
        g = torch.Generator().manual_seed(7)
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    t = np.arange(16000) / 16000
    x = (0.4 * np.sin(2 * np.pi * (180 * t + 120 * t * t))).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda_device):
        cp = CrepePredictor(copy.deepcopy(net), device=dev)
        frames = torch.from_numpy(np.lib.stride_tricks.sliding_window_view(
            np.pad(x, 512), 1024)[::160][:101].copy()).to(dev)
        with torch.no_grad():
            sal = cp.net((frames - frames.mean(-1, keepdim=True))
                         / frames.std(-1, keepdim=True)).cpu()
        f0, pd = cp.predict(x)
        res[str(dev)] = (sal, f0.cpu(), pd.cpu())
    (s0, f0, p0), (s1, f1, p1) = res["cpu"], res["cuda"]
    assert (s1 - s0).abs().max() <= 1e-5
    assert (p1 - p0).abs().max() <= 1e-5
    assert (f1 - f0).abs().max() <= 1e-4


def test_match_spectrum_on_the_card_matches_the_cpu(cuda_device):
    """Remaster's matching EQ on 3 s at 44.1 kHz (2**18-point cuFFT with the
    spectrum's DC and Nyquist imaginary parts zeroed): within 1e-4 of the
    CPU output's peak."""
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy
    from audiolab_tpu_torch.pipelines.processors.remaster import match_spectrum

    apply_policy()
    rng = np.random.default_rng(8)
    t = torch.from_numpy((0.2 * rng.standard_normal((1, 132300))).astype(np.float32))
    r = torch.from_numpy((0.3 * rng.standard_normal((1, 88200))).astype(np.float32))
    ref = match_spectrum(t, r)
    out = match_spectrum(t.to(cuda_device), r.to(cuda_device)).cpu()
    assert out.shape == ref.shape == t.shape
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_served_chain_runs_every_processor_on_the_card(cuda_device, tmp_path):
    """POST /api/v1/process/chain with all eight processors on a server on
    the card (Separate's DSP split, Clone by OpenVoice through a facade of a
    test-width converter on the card, Export, Merge, Remaster, Super
    Resolution, Convert, Compare): HTTP 200, every stage's folder in the
    project, Compare's JSON and PNG last, finite metrics."""
    import base64
    import json
    import urllib.request

    import numpy as np

    from audiolab_tpu_torch.core.audio_io import write_wav
    from audiolab_tpu_torch.models.openvoice import ToneColorConfig, ToneColorConverter
    from audiolab_tpu_torch.pipelines.cloning import (
        CloningFacade,
        OpenVoiceCloneConfig,
        OpenVoiceCloner,
    )
    from audiolab_tpu_torch.pipelines.processors.clone import Clone
    from audiolab_tpu_torch.serve.api import create_app
    from audiolab_tpu_torch.serve.http import serve_background

    cfg = ToneColorConfig(sr=22050, n_fft=256, hop=64, spec_channels=129, inter_channels=8,
                          hidden_channels=8, gin_channels=16, upsample_rates=(4, 4, 4),
                          upsample_kernel_sizes=(8, 8, 8), upsample_initial_channel=32)
    torch.manual_seed(9)
    cloner = OpenVoiceCloner(_seeded(ToneColorConverter(cfg), 9, 0.05),
                             OpenVoiceCloneConfig(1.0, 0.2), device=cuda_device)
    sr = 44100
    t = np.arange(2 * sr) / sr
    tone = 0.3 * np.sin(2 * np.pi * 220 * t)
    x = np.stack([tone, 0.8 * tone]) + 0.05 * np.random.default_rng(0).standard_normal((2, 2 * sr))
    song, ref = tmp_path / "song.wav", tmp_path / "ref.wav"
    write_wav(song, x.astype(np.float32), sr)
    write_wav(ref, (0.1 * np.random.default_rng(1).standard_normal(sr)).astype(np.float32), sr)
    saved = (Clone.converter, Clone.facade)
    Clone.configure(None, CloningFacade(openvoice=cloner))
    root = tmp_path / "process"
    server, port = serve_background(create_app(str(root), device=cuda_device))
    try:
        payload = {"files": [{"filename": "song.wav",
                              "content": base64.b64encode(song.read_bytes()).decode()}],
                   "processors": ["Separate", "Clone", "Export", "Merge", "Remaster",
                                  "Super Resolution", "Convert", "Compare"],
                   "settings": {"Separate": {"noise_removal": "Nothing"},
                                "Clone": {"clone_method": "OpenVoice",
                                          "source_speaker": str(ref)},
                                "Super Resolution": {"chunk_size": 5.0}}}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v1/process/chain",
                                     data=json.dumps(payload).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        Clone.converter, Clone.facade = saved
    assert status == 200
    assert [f["filename"] for f in body["files"]] == ["comparison.json", "comparison.png"]
    metrics = json.loads(base64.b64decode(body["files"][0]["content"]))
    assert all(np.isfinite(metrics[k]) for k in ("rms_diff", "spec_l1", "spec_max"))
    project = next(p for p in root.iterdir() if p.is_dir())
    stages = {d.name for d in project.iterdir() if d.is_dir()}
    assert {"stems", "cloned", "merged", "remastered", "super_res", "converted",
            "compare"} <= stages, stages


# ------------------------------------------------- the LM core, Dia and XTTS

@pytest.mark.parametrize("tq", [441, 1])
@pytest.mark.parametrize("d,sd", [(64, 0.64), (128, 0.905)])
def test_k2_fp32_causal_scale_one_matches_plain(cuda_device, tq, d, sd):
    """Dia's prefill call of K2: fp32, causal, scale 1.0, CFG batch 2 x 16
    heads, over a 5 s prompt (441 positions) and BOS only (t = 1); q, k, v
    with the spread fast_init's weights give at DiaConfig() (d = 64) and
    Dia-1.6B's geometry (d = 128).  Unscaled scores reach ~50: held to 4e-5
    of max|out| (a 1e-6 difference on a score in another summation order
    moves the output by up to that)."""
    q, k, v = (sd * x for x in _qkv(cuda_device, torch.float32, 2, 16, tq, tq, d, seed=tq))
    before = TA.flash_attention_fwd.launches
    out = TA.flash_attention_fwd(q, k, v, causal=True, scale=1.0)
    ref = TA.flash_attention_reference(q, k, v, True, 1.0)
    torch.cuda.synchronize()
    assert TA.flash_attention_fwd.launches == before + 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 4e-5 * ref.abs().max().item()


def _dia_model(dev, seed=0, **kw):
    """Dia at test width (GQA, head dims not dim / heads) with torch's default
    weights from ``seed`` moved by 0.3 N(0, 1) noise, fp32."""
    from audiolab_tpu_torch.models.dia import DiaConfig, DiaModel

    cfg = DiaConfig(**{**dict(dim_enc=32, dim_dec=64, n_layers_enc=1, n_layers_dec=2,
                              n_heads=4, kv_heads=2, head_dim_dec=24, cross_head_dim=20,
                              n_heads_enc=2, n_codebooks=3, codebook_size=40,
                              max_audio_len=64), **kw})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DiaModel(cfg)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.3 * torch.randn(p.shape))
    return model.to(dev).eval()


def test_dia_graph_decode_equals_eager(cuda_device):
    """Dia's captured decode step replayed for every frame gives the eager
    loop's codes under the same draws, with and without an audio prompt; the
    prefill launches the fp32 K2 once a decoder layer, off the Hopper route."""
    import numpy as np

    from audiolab_tpu_torch.models.dia import generate
    from audiolab_tpu_torch.models.lm import gumbel_draws

    model = _dia_model(cuda_device)
    c = model.cfg
    ids = np.frombuffer(b"[S1] hi [S2] yo", np.uint8).astype(np.int32)[None]
    prompt = np.random.default_rng(1).integers(0, 36, (1, c.n_codebooks, 5))
    for ap in (None, prompt):
        draws = gumbel_draws(20 + c.n_codebooks, c.n_codebooks, c.codebook_size, 3,
                             cuda_device)
        TA.reset_launch_counts()
        g = generate(model, ids, max_frames=20, audio_prompt=ap, draws=draws, graph=True)
        assert TA.flash_attention_fwd.launches == c.n_layers_dec
        assert TA.flash_attention_fwd.sm90_launches == 0
        e = generate(model, ids, max_frames=20, audio_prompt=ap, draws=draws, graph=False)
        assert torch.equal(g, e)


def test_lm_graph_decode_equals_eager(cuda_device):
    """The LM core's ``decode`` (top-k, a stop token) over a prefill through
    the cache: the captured step gives the eager loop's tokens."""
    from audiolab_tpu_torch.models.lm import LMConfig, TransformerLM, decode, init_cache

    cfg = LMConfig(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=64,
                   max_seq_len=48, dtype="float32")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        lm = TransformerLM(cfg).to(cuda_device).eval()
    toks = torch.randint(0, 64, (2, 6), device=cuda_device)
    out = {}
    for graph in (True, False):
        caches = init_cache(cfg, 2, 48, cuda_device)
        with torch.no_grad():
            logits, _ = lm(toks, torch.arange(6, device=cuda_device), caches)
        out[graph] = decode(lambda t, pos, c: lm(t, pos, c), caches, logits[:, -1].argmax(-1),
                            6, 30, temperature=0.9, top_k=8, stop_token=5, vocab=64, seed=4,
                            graph=graph)
    assert torch.equal(out[True], out[False])


def test_lm_uncached_forward_takes_the_hopper_k2(cuda_device):
    """A bf16 TransformerLM at head dim 128: the uncached forward launches the
    16-bit K2 once a layer, on the Hopper route, and its logits are finite."""
    from audiolab_tpu_torch.models import lm as TL

    cfg = TL.LMConfig(vocab_size=500, dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
                      ffn_dim=512)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        lm = TL.TransformerLM(cfg).to(cuda_device).eval()
    toks = torch.randint(0, 500, (2, 300), device=cuda_device)
    TA.reset_launch_counts()
    with torch.no_grad():
        out, _ = lm(toks)
    assert TA.flash_attention_fwd.launches == TA.flash_attention_fwd.sm90_launches == 2
    assert torch.isfinite(out).all()


def test_dia_on_the_card_matches_the_cpu(cuda_device):
    """fp32 with TF32 off: Dia's prefill over 6 frames and 4 steps, the
    card's logits within 1e-4 of max|logit| of the CPU's (as the Zonos
    logits are held: the unscaled scores of these noisy test weights, up to
    ~20, amplify fp32 summation-order differences to about 1e-5 of the
    scale)."""
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy

    apply_policy()
    r = np.random.default_rng(5)
    ids = torch.as_tensor(r.integers(1, 256, (2, 9)))
    codes = torch.as_tensor(r.integers(0, 40, (2, 3, 6)))
    steps = torch.as_tensor(r.integers(0, 40, (4, 2, 3)))
    out = {}
    for dev in ("cpu", cuda_device):
        model = _dia_model(dev)
        with torch.no_grad():
            mask = ids.to(dev) != 0
            enc = model.encode_text(ids.to(dev), mask)
            logits, caches, cross = model.prefill(codes.to(dev), enc, mask)
            seq = [logits]
            for i, ct in enumerate(steps):
                seq.append(model.step(ct.to(dev), torch.tensor([6 + i], device=dev), caches,
                                      cross, mask))
        out[str(dev)] = torch.stack(seq).cpu()
    assert (out["cuda"] - out["cpu"]).abs().max() <= 1e-4 * out["cpu"].abs().max()


def test_xtts_v2_on_the_card_matches_the_cpu(cuda_device):
    """fp32 with TF32 off: XTTS-v2's GPT-2 latents and the HiFi decoder's
    waveform at the tiny engine's widths, the card within 1e-5 of the scale
    of the CPU's."""
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy
    from audiolab_tpu_torch.pipelines.tts import random_xtts_checkpoint

    apply_policy()
    r = np.random.default_rng(6)
    eng = random_xtts_checkpoint(seed=3, device="cpu")
    text = torch.as_tensor(r.integers(0, 40, (1, 7)))
    mel = torch.as_tensor(r.integers(0, 30, (1, 12)))
    cond = torch.as_tensor(r.standard_normal((1, 6, 32)).astype(np.float32))
    dvec = torch.as_tensor(r.standard_normal((1, 24)).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda_device):
        gpt, dec = eng.gpt.to(dev), eng.decoder.to(dev)
        with torch.no_grad():
            lat = gpt(text.to(dev), mel.to(dev), cond.to(dev), return_latents=True)[2]
            res[str(dev)] = (lat.cpu(), dec(lat, dvec.to(dev)).cpu())
    for a, b in zip(res["cuda"], res["cpu"]):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_dia_code_range_repair_never_indexes_past_the_dac(cuda_device):
    """Dia's 1028-way codebooks over a 1024-row DAC on the card: ids past the
    table (the generated ones and a frame of EOS, BOS and MASK) become 0
    before the lookup; the audio is finite and the context stays usable (a
    device-side assert would fail the synchronise)."""
    from audiolab_tpu_torch.models.codecs import DACConfig, DACDecoder
    from audiolab_tpu_torch.pipelines.tts import DiaTTSEngine

    model = _dia_model(cuda_device, codebook_size=1028)
    with torch.no_grad():
        model.decoder.logits_dense.weight[:, :, 1024:] *= 8.0
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        dac = DACDecoder(DACConfig(dim=16, rates=(4, 2), n_q=3, codebook_size=1024,
                                   codebook_dim=4))
    eng = DiaTTSEngine(model, dac, sr=8000, frames_per_word=3, device=cuda_device)
    y, sr = eng.generate("[S1] hi there [S2] yo", seed=2)
    special = torch.tensor([[[1025], [1026], [1027]]], device=cuda_device).expand(1, 3, 4)
    z = eng.codes_to_audio(special)
    torch.cuda.synchronize()
    import numpy as np

    assert sr == 8000 and np.isfinite(y).all() and torch.isfinite(z).all()


# ------------------------------------------------------------- Chatterbox

def _seeded_built(make, seed: int, scale: float = 0.05):
    """``make()`` built under a forked seeded generator, every float parameter
    and buffer moved off its initial value (batch-norm variances in [0.5,
    1.5))."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = make()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(module.named_parameters()) + list(module.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif not name.endswith("rand_noise"):
                t.add_(scale * torch.randn(t.shape, generator=g))
    return module.eval()


# T3 at T3CkptConfig()'s head geometry (16 x 64) and perceiver, 2 layers
T3_CARD = dict(text_vocab=80, speech_vocab=100, dim=1024, n_layers=2, n_heads=16, ffn_dim=512,
               max_text_tokens=64, max_speech_tokens=256, speaker_embed_size=16,
               perceiver_tokens=32, perceiver_heads=4, start_text_token=78,
               stop_text_token=0, start_speech_token=90, stop_speech_token=91)


def _t3(dev, seed=0, **kw):
    from audiolab_tpu_torch.models.chatterbox_t3 import T3, T3CkptConfig

    return _seeded_built(lambda: T3(T3CkptConfig(**dict(T3_CARD, **kw))), seed, 0.02).to(dev)


@pytest.mark.parametrize("b,tq", [(1, 412), (2, 612), (1, 37)])
def test_k2_fp32_at_t3_shapes_matches_plain(cuda_device, b, tq):
    """fp32, causal, d = 64 at T3's teacher-forced shapes (16 heads): the
    register-tiled fp32 kernel (``k2_route`` "core", no Hopper launch), to
    2e-5 of max|out| of the plain version, one launch a call."""
    q, k, v = _qkv(cuda_device, torch.float32, b, 16, tq, tq, d=64, seed=tq)
    assert TA.k2_route(b * 16, tq, tq, 64, torch.float32, True, True) == "core"
    TA.reset_launch_counts()
    out = TA.flash_attention(q, k, v, causal=True)
    ref = TA.flash_attention_reference(q, k, v, True, 0.125)
    assert TA.flash_attention_fwd.launches == 1 and TA.flash_attention_fwd.sm90_launches == 0
    assert (out - ref).abs().max() <= 2e-5 * ref.abs().max()


def test_t3_forward_launches_one_fp32_k2_a_layer(cuda_device):
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy

    apply_policy()
    t3 = _t3(cuda_device)
    r = np.random.default_rng(1)
    text = torch.as_tensor(r.integers(1, 78, (1, 12)), device=cuda_device)
    speech = torch.as_tensor(r.integers(0, 90, (1, 20)), device=cuda_device)
    spk = torch.as_tensor(r.standard_normal((1, 16)).astype(np.float32), device=cuda_device)
    prompt = torch.as_tensor(r.integers(0, 90, (1, 40)), device=cuda_device)
    TA.reset_launch_counts()
    with torch.no_grad():
        _lt, ls = t3(text, speech, spk, prompt)
    torch.cuda.synchronize()
    assert TA.flash_attention_fwd.launches == 2 and torch.isfinite(ls).all()


def test_t3_graph_decode_equals_eager(cuda_device):
    """t3_generate with its step captured and replayed against the same
    decode run eagerly, under the same draws: identical codes."""
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy
    from audiolab_tpu_torch.models.chatterbox_t3 import t3_generate
    from audiolab_tpu_torch.models.lm import gumbel_draws

    apply_policy()
    t3 = _t3(cuda_device, seed=2, stop_speech_token=99)
    r = np.random.default_rng(2)
    ids = r.integers(1, 78, (1, 14))
    spk = r.standard_normal(16).astype(np.float32)
    prompt = r.integers(0, 90, (1, 57))
    draws = gumbel_draws(49, 1, 100, 3, cuda_device)
    codes = [t3_generate(t3, ids, spk, prompt_tokens=prompt, max_new_tokens=48, draws=draws,
                         graph=g, device=cuda_device) for g in (True, False)]
    assert codes[0].shape[1] > 10
    np.testing.assert_array_equal(codes[0], codes[1])


def test_t3_cached_decode_matches_forward_with_a_150_token_prompt(cuda_device):
    """The decode's positions on the card: with a 150-token prompt (the
    perceiver's 32 rows), the cached steps' logits within 1e-5 of
    max|logit| of the teacher-forced forward over the same stream."""
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy
    from audiolab_tpu_torch.models.chatterbox_t3 import t3_cached_logits

    apply_policy()
    t3 = _t3(cuda_device, seed=3)
    r = np.random.default_rng(3)
    dev = cuda_device
    text = torch.as_tensor(r.integers(1, 78, (1, 20)), device=dev)
    speech = torch.as_tensor(r.integers(0, 90, (1, 24)), device=dev)
    speech[:, 0] = 90
    spk = torch.as_tensor(r.standard_normal((1, 16)).astype(np.float32), device=dev)
    prompt = torch.as_tensor(r.integers(0, 90, (1, 150)), device=dev)
    emo = torch.full((1,), 0.5, device=dev)
    with torch.no_grad():
        _lt, ls = t3(text, speech, spk, prompt, emo)
        cached = t3_cached_logits(t3, text, speech[:, 1:], spk, prompt, emo)
    assert (cached - ls).abs().max() <= 1e-5 * ls.abs().max()


def test_chatterbox_and_wespeaker_on_the_card_match_the_cpu(cuda_device):
    """fp32 with TF32 off, the card against the CPU on the same weights and
    inputs: T3's logits (1e-5 of max|logit|), the flow's mel under the fixed
    noise and HiFT's waveform under the same source draws (1e-5 of the
    peak), the CAMPPlus x-vector, the WeSpeaker embedding and the kaldi
    fbank (1e-5 of the scale), and the S3 tokenizer's ids (equal)."""
    import numpy as np

    from audiolab_tpu_torch.core.precision import apply_policy
    from audiolab_tpu_torch.kernels.kaldi import kaldi_fbank
    from audiolab_tpu_torch.models.campplus import CAMPPlus, CAMPPlusConfig
    from audiolab_tpu_torch.models.chatterbox_s3gen import (
        FlowConfig,
        HiFTConfig,
        S3Token2Wav,
    )
    from audiolab_tpu_torch.models.s3tokenizer import (
        S3TokenizerConfig,
        S3TokenizerV2,
        s3_log_mel,
    )
    from audiolab_tpu_torch.models.wespeaker import WeSpeakerConfig, WeSpeakerResNet

    apply_policy()
    r = np.random.default_rng(4)
    t3 = _t3("cpu", seed=4)
    s3gen = _seeded_built(lambda: S3Token2Wav(
        FlowConfig(dim=64, ffn_dim=128, n_layers=2, n_up_layers=1, est_channels=64,
                   est_mid_blocks=2, est_n_blocks=1, est_heads=2, est_head_dim=32),
        HiFTConfig(base_channels=64, f0_cond_channels=32)), 5)
    cp = _seeded_built(lambda: CAMPPlus(CAMPPlusConfig(block_layers=(2, 2, 2))), 6)
    ws = _seeded_built(lambda: WeSpeakerResNet(WeSpeakerConfig(num_blocks=(1, 1, 1, 1))), 7)
    st = _seeded_built(lambda: S3TokenizerV2(S3TokenizerConfig(n_state=128, n_head=4, n_layer=2)),
                 8, 0.02)
    text = torch.as_tensor(r.integers(1, 78, (1, 12)))
    speech = torch.as_tensor(r.integers(0, 90, (1, 30)))
    spk = torch.as_tensor(r.standard_normal((1, 16)).astype(np.float32))
    prompt = torch.as_tensor(r.integers(0, 90, (1, 50)))
    tokens = torch.as_tensor(r.integers(0, 6561, (1, 40)))
    xvec = torch.as_tensor(r.standard_normal((1, 192)).astype(np.float32))
    pmel = torch.as_tensor(r.standard_normal((1, 20, 80)).astype(np.float32))
    wav = torch.as_tensor((0.1 * r.standard_normal((1, 48000))).astype(np.float32))
    fb = torch.as_tensor(r.standard_normal((1, 150, 80)).astype(np.float32))
    draws = [torch.as_tensor(r.random((1, 1, 9)).astype(np.float32)),
             torch.as_tensor(r.standard_normal((1, 60 * 480, 9)).astype(np.float32))]
    out = {}
    for dev in ("cpu", cuda_device):
        with torch.no_grad():
            t3, s3gen, cp, ws, st = (m.to(dev) for m in (t3, s3gen, cp, ws, st))
            noise = s3gen.rand_noise[:, :80]
            mel = s3gen.flow(tokens.to(dev), xvec.to(dev), pmel.to(dev), noise)
            out[str(dev)] = dict(
                t3=t3(text.to(dev), speech.to(dev), spk.to(dev), prompt.to(dev))[1],
                mel=mel,
                wav=s3gen.mel2wav(mel[:, 20:], source_draws=[d.to(dev) for d in draws]),
                xvec=cp(fb.to(dev)), ws=ws(fb.to(dev)), fbank=kaldi_fbank(wav.to(dev)),
                ids=st(s3_log_mel(wav.to(dev))))
            out[str(dev)] = {k: v.cpu() for k, v in out[str(dev)].items()}
    for key, ref in out["cpu"].items():
        got = out["cuda"][key]
        if key == "ids":
            assert torch.equal(got, ref), f"{(got != ref).sum()} ids differ"
        else:
            assert (got - ref).abs().max() <= 1e-5 * ref.abs().max(), key


# ------------------------------------------------------------ transcription

def _whisper(dev, seed=0, **kw):
    from audiolab_tpu_torch.models.whisper import WhisperConfig, WhisperModel

    cfg = dict(n_mels=80, dim=256, n_heads=4, n_audio_layers=2, n_text_layers=3,
               vocab_size=1000, n_text_ctx=64, sot=900, eot=899, no_timestamps=910,
               timestamp_base=911)
    cfg.update(kw)
    model = _seeded_built(lambda: WhisperModel(WhisperConfig(**cfg)), seed, 0.02)
    with torch.no_grad():    # else a random decoder repeats the token it is fed
        model.decoder.ln.weight.neg_()
    return model.to(dev).eval()


def test_whisper_graph_decode_equals_eager(cuda_device):
    """transcribe_window with one captured step replayed gives the eager
    loop's tokens, greedy and under the same draws at temperature 0.8; the
    uncached forward over them launches one fp32 K2 a decoder layer and the
    cached decode's logits agree with it to 1e-5 of max|logit|."""
    import numpy as np

    from audiolab_tpu_torch.models.whisper import cached_logits, log_mel_30s, transcribe_window

    model = _whisper(cuda_device)
    x = (0.1 * np.random.default_rng(0).standard_normal(16000 * 40)).astype(np.float32)
    mel = log_mel_30s(x, model.cfg, cuda_device)
    for temperature in (0.0, 0.8):
        g = transcribe_window(model, mel, 40, temperature=temperature, device=cuda_device)
        e = transcribe_window(model, mel, 40, temperature=temperature, device=cuda_device,
                              graph=False)
        assert torch.equal(g, e) and len(torch.unique(g)) > 1
    toks = torch.cat([torch.full((2, 1), model.cfg.sot, device=cuda_device), g[:, :-1]], dim=1)
    TA.reset_launch_counts()
    with torch.inference_mode():
        logits = model(mel, toks)
    assert TA.flash_attention_fwd.launches == model.cfg.n_text_layers
    assert TA.flash_attention_fwd.sm90_launches == 0
    cached = cached_logits(model, mel, toks)
    assert (cached - logits).abs().max() <= 1e-5 * logits.abs().max()


def test_wav2vec2_aligner_on_the_card_matches_the_cpu(cuda_device):
    """The CTC aligner's 2 layers launch 2 fp32 K2 a segment; its log-probs
    agree with the CPU's to 1e-5 and the aligned words are the same."""
    import numpy as np

    from audiolab_tpu_torch.models.hubert import HubertConfig
    from audiolab_tpu_torch.models.wav2vec2 import CTCWordAligner, Wav2Vec2Config, Wav2Vec2CTC

    cfg = Wav2Vec2Config(encoder=HubertConfig(dim=128, ffn_dim=256, heads=2, layers=2))
    model = _seeded_built(lambda: Wav2Vec2CTC(cfg), 3, 0.02)
    x = (0.1 * np.random.default_rng(1).standard_normal(16000 * 4)).astype(np.float32)
    words = "the quick brown fox jumps".split()
    out = {}
    for dev in ("cpu", cuda_device):
        aligner = CTCWordAligner(model, device=dev)
        TA.reset_launch_counts()
        out[str(dev)] = (aligner.log_probs(x[8000:56000]),
                         aligner.align_words(x, 16000, 0.5, 3.5, words))
        assert TA.flash_attention_fwd.launches == (4 if str(dev) == "cuda" else 0)
    (lp_c, w_c), (lp_h, w_h) = out["cuda"], out["cpu"]
    assert np.abs(lp_c - lp_h).max() <= 1e-5 * np.abs(lp_h).max()
    assert w_c == w_h and len(w_c) == 5


def test_pyannet_on_the_card_matches_the_cpu(cuda_device):
    """PyanNet at PyanNetConfig()'s widths: log-probs on the card within
    1e-5 of the CPU's, the VAD's regions the same."""
    import numpy as np

    from audiolab_tpu_torch.models.pyannet import PyanNet, PyanNetConfig
    from audiolab_tpu_torch.pipelines.transcribe import pyannet_vad

    model = _seeded_built(lambda: PyanNet(PyanNetConfig()), 4, 0.05)
    x = (0.2 * np.random.default_rng(2).standard_normal(16000 * 15)).astype(np.float32)
    wav = torch.from_numpy(np.pad(x, (0, 5 * 16000)).reshape(2, 160000))
    out = {}
    for dev in ("cpu", cuda_device):
        model = model.to(dev)
        with torch.inference_mode():
            out[str(dev)] = (model(wav.to(dev)).cpu(), pyannet_vad(model, device=dev)(x, 16000))
    (lp_c, r_c), (lp_h, r_h) = out["cuda"], out["cpu"]
    assert (lp_c - lp_h).abs().max() <= 1e-5 * lp_h.abs().max()
    assert r_c == r_h


def test_wavegrad_sample_and_gradients_on_the_card_match_the_cpu(cuda_device):
    """WaveGrad at WaveGradConfig()'s widths on two chunks of 8 frames:
    FAST_6's sample under the same draws within 1e-3 of max|out| (its noise
    levels are near 1, where the level's Fourier features sin(5000 s f) move
    by up to 6e-4 with a 1-ulp difference of fp32 exp in f); at noise levels
    up to 0.01, where those features are well conditioned, the L1 loss
    within 1e-5 and each gradient within 1e-4 of its tensor's max|g|; no
    kernel launched."""
    from audiolab_tpu_torch.core.device import resolve_device
    from audiolab_tpu_torch.models import wavegrad as WG

    model = _seeded_built(lambda: WG.WaveGrad(WG.WaveGradConfig()), 5, 0.02)
    g = torch.Generator().manual_seed(6)
    mel = torch.randn(2, 8, 128, generator=g)
    audio = 0.3 * torch.randn(2, 2400, generator=g)
    scale, eps = 0.01 * torch.rand(2, generator=g), torch.randn(2, 2400, generator=g)
    draws = WG.sample_draws(6, 2, 2400, 7, torch.device("cpu"))
    out, grads = {}, {}
    for dev in ("cpu", cuda_device):
        dev = resolve_device(dev)            # the precision policy, as train_model applies it
        model = model.to(dev)
        TA.reset_launch_counts()
        out[str(dev)] = WG.sample(model, mel.to(dev), WG.FAST_6, draws=draws.to(dev)).cpu()
        model.zero_grad()
        loss = WG.diffusion_loss(model, audio.to(dev), mel.to(dev), scale.to(dev), eps.to(dev))
        loss.backward()
        grads[str(dev)] = (loss.item(), {k: p.grad.detach().cpu().clone()
                                         for k, p in model.named_parameters()})
        assert TA.flash_attention_fwd.launches == 0
    assert (out["cuda"] - out["cpu"]).abs().max() <= 1e-3 * out["cpu"].abs().max()
    (l_c, g_c), (l_h, g_h) = grads["cuda"], grads["cpu"]
    assert abs(l_c - l_h) <= 1e-5 * abs(l_h)
    errs = {k: float((g_c[k] - ref).abs().max() / ref.abs().max()) for k, ref in g_h.items()}
    assert max(errs.values()) <= 1e-4, sorted(errs.items(), key=lambda kv: -kv[1])[:5]


def test_audiosr_pipeline_on_the_card_matches_the_cpu(cuda_device):
    """The AudioSR stack at narrow widths (UNet model 64 x (1, 2) with
    attention at rate 2, VAE ch 32 x (1, 2), vocoder 64 channels, 16 mels):
    enhance_chunks with 3 guided DDIM steps from the same starting latent on
    (1, 2, 9000) chunks within 1e-4 of max|out|; no kernel launched."""
    from audiolab_tpu_torch.models.audiosr_unet import AudioSRUNet, AudioSRUNetConfig
    from audiolab_tpu_torch.models.audiosr_vae import AudioSRVAE
    from audiolab_tpu_torch.models.audiosr_vocoder import AudioSRVocoder
    from audiolab_tpu_torch.pipelines.super_res import AudioSRCheckpointPipeline

    unet = _seeded_built(lambda: AudioSRUNet(AudioSRUNetConfig(
        model_channels=64, num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2))),
        8, 0.02)
    vae = _seeded_built(lambda: AudioSRVAE(ch=32, ch_mult=(1, 2), num_res_blocks=1), 9, 0.02)
    voc = _seeded_built(lambda: AudioSRVocoder(num_mels=16, initial_channel=64), 10, 0.02)
    g = torch.Generator().manual_seed(11)
    x = 0.2 * torch.randn(1, 2, 9000, generator=g)
    z = torch.randn(2, 16, 32, 8, generator=g)           # 19 fbank frames padded to 64
    out = {}
    for dev in ("cpu", cuda_device):
        pipe = AudioSRCheckpointPipeline(vae.to(dev), unet.to(dev), voc.to(dev),
                                         scale_factor=0.7, n_mels=16)
        TA.reset_launch_counts()
        out[str(dev)] = pipe.enhance_chunks(x.to(dev), steps=3, z=z.to(dev)).cpu()
        assert TA.flash_attention_fwd.launches == 0
    assert out["cuda"].shape == x.shape
    assert (out["cuda"] - out["cpu"]).abs().max() <= 1e-4 * out["cpu"].abs().max()


# ------------------------------------------------------------------ music (the DiT family)

@pytest.mark.parametrize("b,h,t,dtype", [
    (2, 24, 1013, "float32"),     # stable-audio-open: CFG 2 x 24 heads, 47 s + the global token
    (2, 16, 1012, "bfloat16"),    # the in-repo Stable Audio DiT at 47 s
    (2, 16, 323, "bfloat16")])    # ACE-Step at 30 s
def test_k2_at_the_music_shapes_matches_plain(cuda_device, b, h, t, dtype):
    """K2 at the DiT family's self-attention shapes (not causal, d = 64):
    the fp32 call on the register-tiled kernel, the bf16 calls on the Hopper
    design (``.sm90_launches``), each against its plain version."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda_device, dt, b, h, t, t, 64)
    TA.reset_launch_counts()
    out = TA.flash_attention(q, k, v)
    ref = TA.flash_attention_reference(q, k, v, False, 0.125)
    torch.cuda.synchronize()
    assert TA.flash_attention_fwd.launches == 1
    assert TA.flash_attention_fwd.sm90_launches == (0 if dt == torch.float32 else 1)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= (2e-5 if dt == torch.float32 else _k1_tol(ref))


def test_sao_dit_on_the_card_matches_the_cpu(cuda_device):
    """stable-audio-open's DiT at its widths, 2 of 24 layers, over 200
    latents with a 130-token context: the card within 1e-5 of max|v| of the
    CPU (fp32, TF32 off), one fp32 K2 a layer."""
    from audiolab_tpu_torch.core.device import resolve_device
    from audiolab_tpu_torch.models.stable_audio_dit import SAODiTConfig, StableAudioDiT

    model = _seeded_built(lambda: StableAudioDiT(SAODiTConfig(depth=2)), 12, 0.02)
    g = torch.Generator().manual_seed(13)
    args = (torch.randn(2, 200, 64, generator=g), torch.tensor([0.3, 0.3]),
            torch.randn(2, 130, 768, generator=g), torch.randn(2, 1536, generator=g))
    out = {}
    for dev in ("cpu", cuda_device):
        dev = resolve_device(dev)
        TA.reset_launch_counts()
        with torch.no_grad():
            out[str(dev)] = model.to(dev)(*(a.to(dev) for a in args)).cpu()
        assert TA.flash_attention_fwd.launches == (2 if dev.type == "cuda" else 0)
        assert TA.flash_attention_fwd.sm90_launches == 0
    assert (out["cuda"] - out["cpu"]).abs().max() <= 1e-5 * out["cpu"].abs().max()


@pytest.mark.parametrize("frames,kernel", [(200, "K2"), (108, "K1")])
def test_acestep_step_on_the_card_matches_the_cpu(cuda_device, frames, kernel):
    """One guided Euler step of ACE-Step's solve with a bf16 DiT (256 wide, 2
    layers, 4 heads of 64): over 200 latent frames one 16-bit K2 a layer,
    over 108 (a 10 s clip, every key in one block) one K1 a layer, each on
    its Hopper route; the card within 2e-2 of max|z| of the CPU (bf16
    products in another order, as the DiT's CPU parity holds them)."""
    from audiolab_tpu_torch.core.device import resolve_device
    from audiolab_tpu_torch.models import acestep as A
    from audiolab_tpu_torch.models.dit import DiTConfig

    cfg = A.ACEStepConfig(dit=DiTConfig(dim=256, n_layers=2, n_heads=4, cond_dim=128, in_dim=8,
                                        out_dim=8), text_dim=128, text_layers=1)
    model = _seeded_built(lambda: A.ACEStepModel(cfg), 14, 0.02)
    g = torch.Generator().manual_seed(15)
    ctx2, z = torch.randn(2, 192, 128, generator=g), torch.randn(1, frames, 8, generator=g)
    wrapper = TA.flash_attention_fwd if kernel == "K2" else TA.attention_nk1
    other = TA.attention_nk1 if kernel == "K2" else TA.flash_attention_fwd
    out = {}
    for dev in ("cpu", cuda_device):
        dev = resolve_device(dev)
        TA.reset_launch_counts()
        out[str(dev)] = A.fm_sample(model.to(dev), ctx2.to(dev), frames, steps=1,
                                    z_init=z.to(dev)).cpu()
        if dev.type == "cuda":
            assert wrapper.launches == wrapper.sm90_launches == 2
            assert other.launches == 0
    assert (out["cuda"] - out["cpu"]).abs().max() <= 2e-2 * out["cpu"].abs().max()


# ------------------------------------------------------------------ LoRA: gradients through K1 and K2

@pytest.mark.parametrize("t,kernel", [(32, "K1"), (200, "K2")])
def test_attention_gradient_on_the_card_is_the_plain_versions(cuda_device, t, kernel):
    """K1 (32 frames) and the 16-bit K2 (200 frames) with q, k, v requiring
    grad: one launch on the Hopper design through the autograd Function,
    the output within 2 bf16 ulps of the plain version's and the gradients
    equal to autograd of the plain version on the same inputs (the backward
    is that gradient)."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 16, t, t, 64)
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    go = torch.randn_like(q)
    wrapper = TA.attention_nk1 if kernel == "K1" else TA.flash_attention_fwd
    plain = (TA.attention_nk1_reference if kernel == "K1"
             else lambda q, k, v, s: TA.flash_attention_reference(q, k, v, False, s))
    TA.reset_launch_counts()
    out = TA.flash_attention(q, k, v)
    assert wrapper.launches == wrapper.sm90_launches == 1
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ref = plain(*leaves, 0.125)
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)
    got = torch.autograd.grad(out, (q, k, v), go)
    want = torch.autograd.grad(ref, leaves, go)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.abs().max() > 0
        assert (a.float() - b.float()).abs().max() <= 2.0 ** -8 * b.float().abs().max()
    assert wrapper.launches == 1


def test_lora_factor_gradients_reach_q_k_v_on_the_card(cuda_device):
    """One LoRA loss of a bf16 DiT (256 wide, 2 layers, 4 heads of 64) on
    the card: the b factors of wq, wk and wv get gradients (through K1's
    Function; a cut graph would leave them at zero) within 2e-2 of max|g| of
    the CPU's."""
    from audiolab_tpu_torch.models import acestep as A
    from audiolab_tpu_torch.models.dit import DiTConfig
    from audiolab_tpu_torch.train.acestep_lora import flow_match_loss

    cfg = A.ACEStepConfig(dit=DiTConfig(dim=256, n_layers=2, n_heads=4, cond_dim=128, in_dim=8,
                                        out_dim=8), text_dim=128, text_layers=1)
    model = _seeded_built(lambda: A.ACEStepModel(cfg), 16, 0.02)
    g = torch.Generator().manual_seed(17)
    z0, eps = torch.randn(2, 32, 8, generator=g), torch.randn(2, 32, 8, generator=g)
    ctx, t = torch.randn(2, 64, 128, generator=g), torch.tensor([0.3, 0.8])
    grads = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        lora = {p: {n: x.to(dev).requires_grad_(True) for n, x in ab.items()}
                for p, ab in A.lora_init(m.dit, 4, seed=1).items()}
        TA.reset_launch_counts()
        loss = flow_match_loss(A.LoRAModel(m, lora), z0.to(dev), ctx.to(dev), t.to(dev),
                               eps.to(dev))
        paths = sorted(lora)
        grads[dev] = dict(zip(paths, (x.cpu() for x in torch.autograd.grad(
            loss, [lora[p]["b"] for p in paths]))))
        if dev == "cuda":
            assert TA.attention_nk1.launches == TA.attention_nk1.sm90_launches == 2
    for target in ("wq", "wk", "wv", "wo"):
        ps = [p for p in grads["cpu"] if p[-1] == target]
        gc = torch.stack([grads["cuda"][p] for p in ps]).float()
        gp = torch.stack([grads["cpu"][p] for p in ps]).float()
        assert gc.abs().max() > 0
        assert (gc - gp).abs().max() <= 2e-2 * gp.abs().max()


# ------------------------------------------------------------------ YuE

def _yue_draws(seed, shape):
    from audiolab_tpu_torch.models.lm import gumbel_draws

    return gumbel_draws(*shape, seed, torch.device("cpu"))


def test_yue_on_the_card_matches_the_cpu(cuda_device):
    """random_yue (fp32, 2 + 2 layers) on the card with its decode steps
    captured, against eager steps on the card and against a CPU copy, all
    under the same draws: identical codes, the audio within 1e-5 of
    max|y|; no kernel launched."""
    import copy

    import numpy as np

    from audiolab_tpu_torch.kernels import norms as TN
    from audiolab_tpu_torch.models.yue import random_yue

    card = random_yue(seed=4, device=cuda_device)
    card.draws = _yue_draws
    cpu = copy.copy(card)
    for name in ("s1", "s2", "codec"):
        setattr(cpu, name, copy.deepcopy(getattr(card, name)).cpu())
    cpu.device = torch.device("cpu")
    outs = {}
    TA.reset_launch_counts()
    TN.reset_launch_counts()
    for label, pipe, graph in (("graph", card, True), ("eager", card, False),
                               ("cpu", cpu, False)):
        pipe.graph, stats = graph, {}
        out = pipe.generate_music("pop", "la la\n\nna na", n_segments=2, seed=3, stats=stats)
        outs[label] = (stats["codes"], out)
    assert TA.flash_attention_fwd.launches == TA.attention_nk1.launches == 0
    for label in ("eager", "cpu"):
        assert torch.equal(outs[label][0], outs["graph"][0]), label
        for k in ("vocal", "inst", "mix"):
            want = outs[label][1][k]
            assert np.abs(outs["graph"][1][k] - want).max() <= 1e-5 * np.abs(want).max()


def test_yue_checkpoint_loader_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """load_yue_pipeline of a 2-layer stack in the upstream layout (bf16
    safetensors stages written by chip_smoke.py's writer, stage 2 in two
    shards with an index, an xcodec .pth with weight-norm pairs) onto the
    card and onto the CPU: the same weights, and in fp32 identical codes
    under the same draws."""
    import dataclasses
    import json

    from chip_smoke import write_safetensors
    from audiolab_tpu_torch.models.codecs import XCodecConfig, XCodecDecoder
    from audiolab_tpu_torch.models.lm import LMConfig, TransformerLM
    from audiolab_tpu_torch.models.yue import YuEVocab
    from audiolab_tpu_torch.utils.convert import load_yue_pipeline
    from audiolab_tpu_torch.utils.fast_init import fast_init

    vocab = YuEVocab(codebook_size=32, text_size=64, pre_xcodec_codebooks=2, n_q_total=8,
                     post_xcodec_ids=16)
    for stage, shards in (("stage1", 1), ("stage2", 2)):
        d = tmp_path / stage
        d.mkdir()
        (d / "config.json").write_text(json.dumps(dict(
            vocab_size=vocab.size, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5)))
        lm = fast_init(TransformerLM(LMConfig(vocab_size=vocab.size, dim=64, n_layers=2,
                                              n_heads=4, n_kv_heads=2, ffn_dim=128)),
                       seed=len(stage) + shards)
        sd = {k: v.bfloat16() for k, v in lm.state_dict().items()}
        keys = sorted(sd)
        names = [f"model-{i + 1:05d}-of-{shards:05d}.safetensors" for i in range(shards)]
        if shards == 1:
            write_safetensors(d / "model.safetensors", sd)
        else:
            half = len(keys) // 2
            for name, part in zip(names, (keys[:half], keys[half:])):
                write_safetensors(d / name, {k: sd[k] for k in part})
            (d / "model.safetensors.index.json").write_text(json.dumps(
                {"weight_map": {k: names[int(i >= half)] for i, k in enumerate(keys)}}))
    xc = XCodecConfig(n_q=2, codebook_size=16, dim=12, acoustic_dim=4, decoder_dim=16,
                      rates=(2, 5))
    dec = fast_init(XCodecDecoder(xc), seed=5)
    xsd = {}
    for k, v in dec.state_dict().items():
        if k.endswith(".weight") and v.dim() == 3:
            norm = v.flatten(1).norm(dim=1).reshape(-1, 1, 1)
            xsd[k[:-6] + "weight_g"], xsd[k[:-6] + "weight_v"] = norm, 3.0 * v
        else:
            xsd[k] = v
    torch.save({"codec_model": xsd}, tmp_path / "final.pth")
    pipes = [load_yue_pipeline(str(tmp_path / "stage1"), str(tmp_path / "stage2"),
                               str(tmp_path / "final.pth"), xcodec_cfg=xc, vocab=vocab,
                               device=d) for d in (cuda_device, "cpu")]
    for a, b in zip(pipes[0].s2.state_dict().values(), pipes[1].s2.state_dict().values()):
        assert torch.equal(a.cpu(), b)
    codes = []
    for pipe in pipes:
        for name in ("s1", "s2"):
            lm = getattr(pipe, name)
            f32 = TransformerLM(dataclasses.replace(lm.cfg, dtype="float32"))
            f32.load_state_dict({k: v.float() for k, v in lm.state_dict().items()})
            setattr(pipe, name, f32.to(pipe.device).eval())
        pipe.cfg.stage2_block, pipe.draws, stats = 16, _yue_draws, {}
        out = pipe.generate_music("pop", "la la", seconds_per_segment=0.3, stats=stats)
        assert out["sr"] == 500 and out["mix"].shape == (150,)
        codes.append(stats["codes"])
    assert torch.equal(codes[0], codes[1])


def _loader_files(tmp_path, monkeypatch):
    """One small file a format of the chain's loaders, written in the
    upstream container from a seeded port module: {label: (path, load with
    the default device, the module, the keys the load folds: "all" or a
    set)}.
    HuBERT loads through the trainer's path from ``AUDIOLAB_WEIGHTS_DIR``."""
    import dataclasses
    import functools

    from chip_smoke import HUBERT_WN, cpu_state, mdx23c_upstream_names, weight_norm_pairs
    from audiolab_tpu_torch.models.crepe import Crepe
    from audiolab_tpu_torch.models.hubert import HubertConfig, HubertFeatureExtractor
    from audiolab_tpu_torch.models.rmvpe import RMVPE
    from audiolab_tpu_torch.models.separation.htdemucs import HTDemucs, HTDemucsConfig
    from audiolab_tpu_torch.models.separation.mdx23c import MDX23CConfig, TFCTDFNetV3
    from audiolab_tpu_torch.models.separation.roformer import BSRoformer, RoformerConfig
    from audiolab_tpu_torch.models.separation.vr import VRConfig, make_vr_net
    from audiolab_tpu_torch.train.rvc_train import _hubert_apply_for
    from audiolab_tpu_torch.utils import convert as C
    from audiolab_tpu_torch.utils.fast_init import fast_init

    rof = RoformerConfig(dim=64, depth=1, heads=2, dim_head=64, freqs_per_bands=(64, 65),
                         n_fft=256, hop=64, stems=("vocals",), residual_stem="other")
    hub = HubertConfig(dim=128, ffn_dim=512, heads=2, layers=2, final_dim=256)  # the trainer's
    htd = HTDemucsConfig(sources=("vocals", "other"), channels=4, nfft=128, depth=2,
                         norm_groups=2, dconv_comp=2, bottom_channels=8, t_layers=1, t_heads=2,
                         segment_seconds=1.0, samplerate=800)
    mdx = MDX23CConfig(sample_rate=8000, n_fft=256, hop_length=64, dim_f=128, num_subbands=2,
                       num_scales=2, num_blocks_per_scale=1, channels=8, growth=8)
    models = {
        "roformer": fast_init(BSRoformer(rof), 1),
        "hubert": fast_init(HubertFeatureExtractor("v2", hub), 2),
        "rmvpe": fast_init(RMVPE(en_de_layers=2, inter_layers=1, n_blocks=1, en_out_channels=4,
                                 gru_hidden=8), 3),
        "crepe": fast_init(Crepe("tiny"), 4),
        "htdemucs": fast_init(HTDemucs(htd), 5),
        "mdx23c": fast_init(TFCTDFNetV3(mdx), 6),
        "vr": fast_init(make_vr_net(VRConfig(n_fft=128, nout=8, nout_lstm=8)), 7),
    }
    monkeypatch.setenv("AUDIOLAB_WEIGHTS_DIR", str(tmp_path))
    out = {}
    for label, module in models.items():
        path = str(tmp_path / ("hubert_base.pt" if label == "hubert" else f"{label}.pt"))
        sd = cpu_state(module)
        if label == "roformer":
            sd = {"state_dict": {f"model.{k}": v for k, v in sd.items()}}
        elif label == "hubert":
            sd = {"model": weight_norm_pairs(sd, HUBERT_WN, dim=2)}
        elif label == "mdx23c":
            sd = mdx23c_upstream_names(sd)
        torch.save(sd, path)
        load = {
            "roformer": functools.partial(C.load_roformer_checkpoint, cfg=rof),
            "hubert": lambda p: _hubert_apply_for({"feat_channels": 128, "version": "v2"}),
            "rmvpe": RMVPE.from_checkpoint,
            "crepe": functools.partial(C.load_crepe_checkpoint, model="tiny"),
            "htdemucs": functools.partial(C.load_htdemucs_checkpoint, cfg=htd),
            "mdx23c": functools.partial(C.load_mdx23c_checkpoint, cfg=dataclasses.asdict(mdx)),
            "vr": C.load_vr_checkpoint,
        }[label]
        folded = {"hubert": {"encoder.pos_conv.0.weight"}, "vr": "all"}.get(label, set())
        out[label] = (path, load, module, folded)
    return out


def test_loaders_default_to_the_card(cuda_device, tmp_path, monkeypatch):
    """Every loader of the chain's formats, called without a device, builds
    its module on the card: every tensor there, equal to the module written
    (a weight-norm or batch-norm fold aside).  RVC and RMVPE, whose loaders
    build the full-size module, run at small widths here."""
    import dataclasses

    from chip_smoke import cpu_state, rvc_process_ckpt
    from audiolab_tpu_torch.models import rmvpe as R
    from audiolab_tpu_torch.models.rvc import synthesizer as S
    from audiolab_tpu_torch.utils import convert as C
    from audiolab_tpu_torch.utils.fast_init import fast_init

    small = dict(inter_channels=16, hidden_channels=16, filter_channels=32, n_heads=2,
                 n_layers=1, upsample_initial_channel=32, spk_embed_dim=4, gin_channels=16)
    real = S.config_for
    monkeypatch.setattr(S, "config_for",
                        lambda sr, v="v2": dataclasses.replace(real(sr, v), **small))
    files = _loader_files(tmp_path, monkeypatch)
    full = R.RMVPE

    class Small(full):
        def __init__(self, dtype="bfloat16"):
            super().__init__(dtype, en_de_layers=2, inter_layers=1, n_blocks=1,
                             en_out_channels=4, gru_hidden=8)

    monkeypatch.setattr(R, "RMVPE", Small)      # the loader's full-size module, narrowed
    synth = fast_init(S.SynthesizerTrn(S.config_for(48000, "v2")), 8)
    torch.save(rvc_process_ckpt(cpu_state(synth), synth.cfg), tmp_path / "voice.pth")
    files["rvc"] = (str(tmp_path / "voice.pth"), lambda p: C.load_rvc_checkpoint(p)[0], synth,
                    "all")
    for label, (path, load, module, folded) in files.items():
        got = load(path)
        sd = got.state_dict()
        assert all(t.device.type == "cuda" for t in sd.values()), label
        assert set(sd) == set(module.state_dict()), label
        if folded != "all":
            for k, v in module.state_dict().items():
                assert k in folded or torch.equal(sd[k].cpu(), v), (label, k)


def test_loaded_roformer_and_hubert_launch_k1_and_k2(cuda_device, tmp_path, monkeypatch):
    """The RoFormer from its .ckpt in bf16 runs K1 on the card (one launch an
    axial transformer: time and band, on the Hopper routes), HuBERT from its
    fairseq file runs the fp32 K2 once a layer, counted by the wrappers."""
    from audiolab_tpu_torch.models.separation.roformer import RoformerConfig

    files = _loader_files(tmp_path, monkeypatch)
    path, load, _, _ = files["roformer"]
    cfg = RoformerConfig(dim=64, depth=1, heads=2, dim_head=64, freqs_per_bands=(64, 65),
                         n_fft=256, hop=64, stems=("vocals",), residual_stem="other",
                         dtype="bfloat16")
    rof = load(path, cfg=cfg)
    TA.reset_launch_counts()
    with torch.no_grad():
        stems = rof(torch.randn(1, 2, 4096, device=cuda_device))
    torch.cuda.synchronize()
    assert set(stems) == {"vocals", "other"}
    assert (TA.attention_nk1.launches, TA.flash_attention_fwd.launches) == (2, 0)
    assert TA.attention_nk1.sm90_launches == 2
    path, load, _, _ = files["hubert"]
    hubert = load(path).eval()
    TA.reset_launch_counts()
    with torch.no_grad():
        feats = hubert(torch.randn(1, 16000, device=cuda_device))
    torch.cuda.synchronize()
    assert feats.shape == (1, 49, 128) and bool(torch.isfinite(feats).all())
    assert (TA.flash_attention_fwd.launches, TA.attention_nk1.launches) == (2, 0)
