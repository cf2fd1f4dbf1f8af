"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (decided inside the fixture, never at import).  The file imports no
JAX, so it runs where JAX is not installed; on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances: K1, K3, K6 and K7 (16-bit) to 2 bf16 ulps of max|out| (the
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


@pytest.mark.parametrize("b,h,t,d", [
    (2, 4, 62, 64),       # band axis, one slice per CTA, keys padded
    (280, 8, 62, 64),     # >= 2112 slices of <= 64 rows: 16 slices per CTA
    (4, 8, 64, 64),       # one whole chunk
    (3, 2, 200, 32), (2, 2, 70, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_k6_matches_plain(cuda_device, b, h, t, d, dtype):
    q, k, v = _qkv(cuda_device, getattr(torch, dtype), b, h, t, t, d)
    out = TA.slim_attention(q, k, v)
    ref = TA.attention_nk1_reference(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


@pytest.mark.parametrize("b,t,heads,d", [
    (3, 690, 8, 64),      # RoFormer time axis, ragged last query tile
    (2, 64, 8, 64),       # one whole tile
    (2, 100, 3, 32), (1, 130, 2, 128)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("layout", ["packed", "qkv_views"])
def test_k7_matches_plain(cuda_device, b, t, heads, d, dtype, layout):
    """Packed (b, t, heads*d) inputs, contiguous or as views of one fused
    (b, t, 3*heads*d) activation (rows at stride 3*heads*d)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    inner = heads * d
    qkv = torch.randn(b, t, 3 * inner, generator=g, device=cuda_device).to(getattr(torch, dtype))
    q, k, v = qkv.split(inner, dim=-1)
    if layout == "packed":
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = TA.packed_attention(q, k, v, heads, d)
    ref = TA.packed_attention_reference(q, k, v, heads, d, d ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == (b, t, inner) and out.is_contiguous()
    assert (out.float() - ref.float()).abs().max().item() <= _k1_tol(ref)


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
    TA.reset_launch_counts()


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
