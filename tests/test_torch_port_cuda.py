"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (decided inside the fixture, never at import).  The file imports no
JAX, so it runs where JAX is not installed; on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Tolerances: K1 (bf16) to 2 bf16 ulps of max|out| (the sums run in another
order, which may flip an output's or a probability's rounding); K2 (fp32)
to 2e-5 (fp32 sums over a few hundred keys in another order).
"""

import pytest
import torch

from audiolab_tpu_torch.kernels import attention as TA

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
