"""The port's SEANet codec, residual VQ and YuE's xcodec decoder against the
JAX package's (audiolab_tpu/models/codecs.py) on the CPU.

Weights: flax trees of ``jax.eval_shape`` templates filled with seeded
numbers (``tests/torch_port_tiny.py::filled``), carried into the port by
``utils/weights.py``.  The xcodec decoder has a second witness:
``tests/torch_ref_models.py::XCodecDecoderTorch`` (the vendored decoder's
layout with weight-normed convolutions), whose folded state_dict the port
module loads as it is.

Tolerances: fp32 audio and latents to 1e-5 of the output's max|y| (sums in
another order); RVQ codes exactly (the nearest code is the same fp32
expression in both packages).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from audiolab_tpu.models import codecs as JC
from audiolab_tpu_torch.models import codecs as TC
from audiolab_tpu_torch.utils import weights as W
from tests.torch_port_tiny import filled
from tests.torch_port_tiny import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
STRIDES = (2, 4, 5, 8)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _tree(module, *args, seed: int, method=None):
    tpl = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                             method=method))["params"]
    return filled(tpl, seed)


def _port(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _seanet(r: int) -> JC.SEANetConfig:
    return JC.SEANetConfig(dim=8, n_filters=4, ratios=(r, 2), n_res=2)


@functools.lru_cache(maxsize=None)
def codec(r: int, seed: int = 70):
    """(JAX SoundStreamCodec, flax params, port codec) with SEANet ratios
    (r, 2), two residual units a stage."""
    cfg = JC.CodecConfig(sr=8000, seanet=_seanet(r), n_q=3, codebook_size=16)
    jm = JC.SoundStreamCodec(cfg)
    p = _tree(jm, jnp.zeros((1, cfg.seanet.hop * 4)), seed=seed)
    tcfg = TC.CodecConfig(sr=8000, seanet=TC.SEANetConfig(**vars(cfg.seanet)), n_q=3,
                          codebook_size=16)
    return jm, p, _port(TC.SoundStreamCodec(tcfg), W.soundstream_from_jax(p))


@pytest.mark.parametrize("r", STRIDES)
def test_conv_transpose_same_matches_flax(r):
    """flax ConvTranspose(2r, stride r, SAME) on flax's unflipped kernel: the
    port's ``_ConvTransposeSame`` on the mapped (flipped) weight."""
    jm = nn.ConvTranspose(3, (2 * r,), strides=(r,), padding="SAME")
    p = _tree(jm, jnp.zeros((1, 5, 4)), seed=r)
    x = np.random.default_rng(r).standard_normal((2, 7, 4)).astype(np.float32)
    want = jm.apply({"params": p}, x)
    sd: dict = {}
    W._conv_t1d(sd, "m", p)
    tm = TC._ConvTransposeSame(4, 3, r)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert got.shape == (2, 7 * r, 3)
    _close(got, want)


@pytest.mark.parametrize("r", STRIDES)
def test_xcodec_upsampler_is_torch_padding(r):
    """The xcodec upsampler (kernel 2r, padding ceil(r/2), output padding
    r % 2) against the JAX ``TorchConvTranspose`` at each stride, and against
    ``_ConvTransposeSame``: equal at even rates, one sample later at 5."""
    jm = JC.TorchConvTranspose(3, 2 * r, r, torch_padding=int(np.ceil(r / 2)),
                               output_padding=r % 2)
    p = _tree(jm, jnp.zeros((1, 5, 4)), seed=10 + r)
    x = np.random.default_rng(r).standard_normal((2, 7, 4)).astype(np.float32)
    want = jm.apply({"params": p}, x)
    sd: dict = {}
    W._conv_t1d(sd, "m", p["conv"])
    tm = TC._conv_transpose_torch(4, 3, r)
    tm.load_state_dict({k[2:]: v for k, v in sd.items()})
    same = TC._ConvTransposeSame(4, 3, r)
    same.load_state_dict(tm.state_dict())
    xt = torch.from_numpy(x).transpose(1, 2)
    with torch.no_grad():
        got, alt = tm(xt), same(xt)
    assert got.shape == alt.shape == (2, 3, 7 * r)
    _close(got.transpose(1, 2), want)
    if r % 2 == 0:
        torch.testing.assert_close(alt, got, rtol=0, atol=1e-6)
    else:
        assert (alt - got).abs().max() > 1e-3
        torch.testing.assert_close(alt[..., 1:], got[..., :-1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("r", STRIDES)
def test_seanet_encoder_matches_jax(r):
    """The encoder (left pad (k-1)d - (s-1), stride r then 2) on 2 x 5 hops."""
    jm, p, tm = codec(r)
    cfg = jm.cfg.seanet
    x = 0.3 * np.random.default_rng(1).standard_normal((2, 5 * cfg.hop, 1)).astype(np.float32)
    want = JC.SEANetEncoder(cfg).apply({"params": p["encoder"]}, x)
    with torch.no_grad():
        got = tm.encoder(torch.from_numpy(x))
    assert got.shape == (2, 5, cfg.dim)
    _close(got, want)


@pytest.mark.parametrize("r", STRIDES)
def test_seanet_decoder_matches_jax(r):
    jm, p, tm = codec(r)
    cfg = jm.cfg.seanet
    z = np.random.default_rng(2).standard_normal((2, 6, cfg.dim)).astype(np.float32)
    want = JC.SEANetDecoder(cfg).apply({"params": p["decoder"]}, z)
    with torch.no_grad():
        got = tm.decoder(torch.from_numpy(z))
    assert got.shape == (2, 6 * cfg.hop, 1)
    _close(got, want)


def test_rvq_encode_decode_and_straight_through_match_jax():
    jm, p, tm = codec(2)
    rvq = JC.ResidualVQ(3, 16, 8)
    z = 0.3 * np.random.default_rng(3).standard_normal((2, 9, 8)).astype(np.float32)
    codes = rvq.apply({"params": p["rvq"]}, z, method=JC.ResidualVQ.encode)
    got = tm.rvq.encode(torch.from_numpy(z))
    assert got.shape == (2, 3, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(codes))
    assert len(np.unique(np.asarray(codes))) > 3
    np.testing.assert_array_equal(tm.rvq.encode(torch.from_numpy(z), n_q=2).numpy(),
                                  np.asarray(codes)[:, :2])
    with torch.no_grad():
        _close(tm.rvq.decode(got), rvq.apply({"params": p["rvq"]}, codes,
                                             method=JC.ResidualVQ.decode))
    zt = torch.from_numpy(z).requires_grad_(True)
    zq, c2 = tm.rvq(zt)
    zq.sum().backward()
    assert torch.equal(c2, got) and torch.equal(zt.grad, torch.ones_like(zt))
    want_q, want_c = rvq.apply({"params": p["rvq"]}, z)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(want_c))
    _close(zq.detach(), want_q)


@pytest.mark.parametrize("r", (4, 5))
def test_soundstream_codec_matches_jax(r):
    """encode (codes equal), decode and the straight-through forward."""
    jm, p, tm = codec(r)
    hop = jm.cfg.seanet.hop
    x = 0.3 * np.random.default_rng(4).standard_normal((2, 6 * hop)).astype(np.float32)
    codes = jm.apply({"params": p}, x, method=JC.SoundStreamCodec.encode)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(codes))
        _close(tm.decode(got), jm.apply({"params": p}, codes,
                                         method=JC.SoundStreamCodec.decode))
        y, c = tm(torch.from_numpy(x))
    want_y, want_c = jm.apply({"params": p}, x)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_c))
    _close(y, want_y)
    assert tm.cfg.frame_rate == jm.cfg.frame_rate == 8000 / hop


XC = dict(n_q=3, codebook_size=16, dim=12, acoustic_dim=4, decoder_dim=32, rates=(2, 5, 4))


@functools.lru_cache(maxsize=None)
def xcodec(seed: int = 71):
    cfg = JC.XCodecConfig(**XC)
    jm = JC.XCodecDecoder(cfg)
    p = _tree(jm, jnp.zeros((1, cfg.n_q, 4), jnp.int32), seed=seed)
    return jm, p, _port(TC.XCodecDecoder(TC.XCodecConfig(**XC)), W.xcodec_from_jax(p))


def test_xcodec_decoder_matches_jax():
    """codes -> audio at rates (2, 5, 4): the odd rate's torch padding, no
    final tanh (the output passes 1 at these weights)."""
    jm, p, tm = xcodec()
    codes = np.random.default_rng(5).integers(0, 16, (2, 3, 7))
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(codes)))
    with torch.no_grad():
        got = tm(torch.from_numpy(codes))
    assert got.shape == (2, 7 * 40)
    _close(got, want)
    assert np.abs(want).max() > 1.0


def test_xcodec_decoder_matches_the_torch_witness():
    """``XCodecDecoderTorch`` (weight-normed, the checkpoint's names): its
    folded state_dict loads into the port module strictly, and the two
    agree to 1e-6 of max|y|."""
    from tests.torch_ref_models import XCodecDecoderTorch

    from audiolab_tpu_torch.utils.convert import fold_state_dict

    torch.manual_seed(6)
    ref = XCodecDecoderTorch(n_q=2, bins=16, dim=12, acoustic=4, dec_dim=16,
                             rates=(2, 5)).eval()
    sd = fold_state_dict(ref.state_dict())
    tm = _port(TC.XCodecDecoder(TC.XCodecConfig(n_q=2, codebook_size=16, dim=12,
                                                acoustic_dim=4, decoder_dim=16,
                                                rates=(2, 5))), sd)
    codes = torch.from_numpy(np.random.default_rng(7).integers(0, 16, (2, 2, 9)))
    with torch.no_grad():
        want, got = ref(codes)[:, 0], tm(codes)
    assert got.shape == want.shape == (2, 90)
    _close(got, want, 1e-6)
