"""The port's speaker-embedding front ends against the JAX package's, on the
CPU: the kaldi fbank (kernels/kaldi.py), CAMPPlus (models/campplus.py), the
WeSpeaker ResNet (models/wespeaker.py) and NeuralDiarizer's wespeaker back
end, at the JAX parity tests' narrow widths with seeded weights carried by
``campplus_from_jax`` / ``wespeaker_from_jax``.

Tolerances: the fbank within 1e-4 of its peak (a log of a power spectrum:
low-energy bins lose digits in the fp32 DFT products on both sides; the
JAX fbank is 1.1e-4 off an fp64 one at a peak of 10.8, the port 3.4e-5),
embeddings within 1e-5, the diarizer's turns identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.kernels import kaldi as JK
from audiolab_tpu.models import campplus as JCp
from audiolab_tpu.models import diarize as JD
from audiolab_tpu.models import wespeaker as JWs
from audiolab_tpu.utils.convert import convert_campplus, convert_wespeaker
from audiolab_tpu_torch.kernels import kaldi as TK
from audiolab_tpu_torch.models import campplus as TCp
from audiolab_tpu_torch.models import diarize as TD
from audiolab_tpu_torch.models import wespeaker as TWs
from tests import torch_port_tiny as tiny


def _wav(seconds: float, seed: int, b: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    tone = 0.3 * np.sin(2 * np.pi * (150 + 40 * rng.random((b, 1))) * t)
    return (tone + 0.05 * rng.standard_normal((b, n))).astype(np.float32)


def test_kaldi_tables_and_fbank_match_jax():
    np.testing.assert_array_equal(TK.povey_window(400), JK.povey_window(400))
    np.testing.assert_array_equal(TK.kaldi_mel_banks(80, 512, 16000),
                                  JK.kaldi_mel_banks(80, 512, 16000))
    x = _wav(1.3, 0, b=2)
    for n_mels in (80, 16):
        ref = np.asarray(JK.kaldi_fbank(jnp.asarray(x), n_mels=n_mels))
        out = TK.kaldi_fbank(torch.from_numpy(x), n_mels=n_mels).numpy()
        assert out.shape == ref.shape == (2, 128, n_mels)
        np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_campplus_matches_jax():
    cfg, _tpl, p, tm = tiny.campplus()
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((2, 23, cfg.feat_dim)).astype(np.float32)
    apply = jax.jit(JCp.CAMPPlus(cfg).apply)
    ref = np.asarray(apply({"params": p}, jnp.asarray(feat)))
    with torch.no_grad():
        out = tm(torch.from_numpy(feat)).numpy()
    assert out.shape == ref.shape == (2, 12)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    # campplus_xvector's front end (kaldi fbank, mean removal) as the JAX
    # function has it, with the model jitted
    wav = _wav(0.7, 2)[0]
    fb = JK.kaldi_fbank(jnp.asarray(wav)[None], n_mels=cfg.feat_dim)
    ref = np.asarray(apply({"params": p}, fb - jnp.mean(fb, axis=1, keepdims=True))[0])
    out = TCp.campplus_xvector(tm, wav)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("two_emb_layer", [False, True])
def test_wespeaker_matches_jax(two_emb_layer):
    cfg, _tpl, p, tm = tiny.wespeaker(two_emb_layer=two_emb_layer)
    jm = tiny.Jitted(JWs.WeSpeakerResNet(cfg))
    rng = np.random.default_rng(3)
    fb = rng.standard_normal((2, 41, cfg.feat_dim)).astype(np.float32)
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(fb)))
    with torch.no_grad():
        out = tm(torch.from_numpy(fb)).numpy()
    assert out.shape == ref.shape == (2, cfg.embed_dim)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    wav = _wav(0.8, 4, b=2)
    ref = np.asarray(JWs.wespeaker_embed(jm, p, wav))
    out = TWs.wespeaker_embed(tm, wav).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-6)


def test_neural_diarizer_wespeaker_back_end_matches_jax():
    """Two alternating synthetic voices, 6 s at 16 kHz: the JAX diarizer with
    ``wespeaker=(model, params)`` and the port's with the WeSpeakerResNet
    holding the same weights (the segmentation nets of
    tests/test_torch_port_diarize.py) give the same turns, and their region
    embeddings agree within 1e-5."""
    from tests.test_torch_port_diarize import CFG, _pair, _speech

    jd0, td0 = _pair()
    cfg, _tpl, p, tm = tiny.wespeaker()
    jd = JD.NeuralDiarizer(JD.DiarizeConfig(**CFG), jd0.seg_params, jd0.emb_params,
                           wespeaker=(tiny.Jitted(JWs.WeSpeakerResNet(cfg)), p))
    td = TD.NeuralDiarizer(TD.DiarizeConfig(**CFG), td0.seg, td0.emb, wespeaker=tm,
                           device="cpu")
    x = _speech(6.0, 5)
    ref = jd.diarize(x, 16000)
    assert td.diarize(x, 16000) == ref and len(ref) >= 2
    regions = [(0.2, 0.9), (1.5, 4.8), (5.0, 5.01)]
    np.testing.assert_allclose(td._wespeaker_embs(x, regions).numpy(),
                               jd._wespeaker_embs(x, regions), atol=1e-5, rtol=0)


def test_convert_round_trips():
    """The port's state_dicts map back through the JAX converters onto the
    trees they came from."""
    _cfg, tpl, p, tm = tiny.campplus()
    tiny.assert_tree_equal(convert_campplus(tiny.numpy_state(tm), tpl), p)
    for two in (False, True):
        _cfg, tpl, p, tm = tiny.wespeaker(two_emb_layer=two)
        tiny.assert_tree_equal(convert_wespeaker(tiny.numpy_state(tm), tpl), p)
