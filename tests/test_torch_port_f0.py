"""Parity of the port's f0 methods with the JAX package's, on the CPU, fp32,
tiny configurations: YIN (``f0_autocorr``), the hybrid merge, the WORLD
family's host estimators (bit for bit: the port keeps a copy of the same
numpy code), rmvpe+, and the converter's dispatch, ``_extract_f0``, for every
method the JAX converter runs without a crepe model, with and without the
12-TET snap, and the fused YIN path of a converter with no RMVPE model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.dsp import f0 as JF
from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models.rvc import synthesizer as JSy
from audiolab_tpu.pipelines import rvc as JP
from audiolab_tpu_torch.dsp import f0 as TF
from audiolab_tpu_torch.pipelines import rvc as TP
from tests import torch_port_tiny as tiny
from tests.test_torch_port_rvc import _mel_l1, _Noise

SR = 16000


def _voice(n=16000, seed=0, f=180.0):
    """A gliding tone with a silent gap and a little noise: voiced and
    unvoiced frames, far from YIN's decision thresholds."""
    t = np.arange(n)
    x = 0.4 * np.sin(2 * np.pi * (f + 40 * np.sin(t / 8000)) * t / SR)
    x = x + 0.02 * np.random.default_rng(seed).standard_normal(n)
    x[n // 3: n // 3 + n // 8] = 0.0
    return x.astype(np.float32)


def test_f0_autocorr_matches_jax():
    """f0 to 1e-2 Hz and the voiced probability to 1e-5 on a (2, n) batch
    (the port takes leading axes, the JAX function one row at a time)."""
    x = np.stack([_voice(seed=1), (0.3 * np.random.default_rng(2).standard_normal(16000))
                  .astype(np.float32)])
    f0, prob = TF.f0_autocorr(torch.from_numpy(x))
    for row in range(2):
        rf, rp = JF.f0_autocorr(jnp.asarray(x[row]))
        np.testing.assert_allclose(f0[row].numpy(), np.asarray(rf), atol=1e-2, rtol=0)
        np.testing.assert_allclose(prob[row].numpy(), np.asarray(rp), atol=1e-5, rtol=0)
    assert (f0[0] > 0).float().mean() > 0.5 and (f0[0] == 0).any()


@pytest.mark.parametrize("merge_type", ["median", "mean"])
@pytest.mark.parametrize("m", [2, 3])
def test_merge_f0_matches_jax(merge_type, m):
    rng = np.random.default_rng(m)
    stack = rng.uniform(80, 400, (m, 3, 50)).astype(np.float32)
    stack[rng.uniform(size=stack.shape) < 0.3] = 0.0
    ref = np.asarray(JF.merge_f0(jnp.asarray(stack), merge_type))
    out = TF.merge_f0(torch.from_numpy(stack), merge_type).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["f0_pm", "f0_dio", "f0_harvest"])
def test_world_estimators_are_bit_identical(name):
    x = _voice(n=12000, seed=3, f=140.0)
    ref = getattr(JF, name)(x, sr=SR, hop=160, fmin=50.0, fmax=1100.0)
    out = getattr(TF, name)(x, sr=SR, hop=160, fmin=50.0, fmax=1100.0)
    assert out.dtype == ref.dtype and (ref > 0).any()
    np.testing.assert_array_equal(out, ref)


def test_stonemask_is_bit_identical():
    x = _voice(n=12000, seed=4, f=200.0).astype(np.float64)
    f0 = np.full(12000 // 160 + 1, 200.0)
    f0[::7] = 0.0
    ref = JF.stonemask(x, f0, sr=SR, hop=160)
    assert (ref > 0).any()
    np.testing.assert_array_equal(TF.stonemask(x, f0, sr=SR, hop=160), ref)


def _pair(f0_method, rmvpe=True, **cfg_kw):
    """The JAX and the port's converter on the same tiny weights."""
    sp, tsy = tiny.synth()
    hp, thub = tiny.hubert()
    jrm, trm = tiny.rmvpe() if rmvpe else (None, None)
    kw = dict(sr=48000, f0_method=f0_method, chunk_seconds=1.0, overlap_seconds=0.2,
              device_batch=2, **cfg_kw)
    jvc = JP.VoiceConverter(JSy.SynthesizerConfig(**tiny.SYNTH), sp, hp, rmvpe=jrm,
                            hubert_cfg=JH.HubertConfig(**tiny.HCFG),
                            cfg=JP.RVCPipelineConfig(matmul_precision="highest", **kw))
    tvc = TP.VoiceConverter(tsy, thub, trm, device="cpu",
                            cfg=TP.RVCPipelineConfig(matmul_precision="highest", **kw))
    return jvc, tvc


@pytest.mark.parametrize("method,rmvpe,extra", [
    ("rmvpe", True, {}),
    ("rmvpe+", True, {"f0_min": 100.0, "f0_max": 400.0}),
    ("harvest", True, {}),
    ("harvest", True, {"filter_radius": 2}),
    ("pm", False, {}),
    ("dio", False, {"f0_autotune": True}),
    (["harvest", "rmvpe+"], True, {}),
    (["harvest", "rmvpe+"], True, {"merge_type": "mean", "f0_autotune": True}),
    (["pm", "yin"], False, {}),
    (["pm", "yin"], False, {"merge_type": "mean"}),
    (["crepe", "dio", "rmvpe"], False, {}),     # no crepe, no RMVPE: both take YIN
    ("hybrid", True, {"f0_autotune": True}),    # harvest + rmvpe+
    ("hybrid", False, {}),                      # harvest + yin
])
def test_extract_f0_matches_jax(method, rmvpe, extra):
    """The f0 a converter hands one chunk group, transposed by +3: host
    estimators bit for bit up to the merge, RMVPE to 1e-3 Hz, YIN to 1e-2 Hz
    (the 12-TET snap maps both to the same note)."""
    jvc, tvc = _pair(method, rmvpe, **extra)
    assert jvc._f0_on_host() and tvc._f0_on_host()
    wav = np.stack([_voice(seed=5), _voice(seed=6, f=260.0)])
    ref = np.asarray(jvc._extract_f0(jnp.asarray(wav), 3))
    with torch.no_grad():
        out = tvc._extract_f0(torch.from_numpy(wav), 3).numpy()
    assert out.shape == ref.shape and (ref > 0).any()
    np.testing.assert_allclose(out, ref, atol=1e-2, rtol=0)


@pytest.mark.parametrize("method,rmvpe", [
    ("rmvpe", True), ("rmvpe+", True), ("rmvpe_onnx", True), ("rmvpe", False),
    ("rmvpe+", False), ("yin", True), ("crepe", True), ("mangio-crepe-tiny", False),
    ("pm", False), ("dio", True), ("harvest", False), ("hybrid", False),
    (["yin"], False), ("unknown", True)])
def test_f0_on_host_matches_jax(method, rmvpe):
    jrm = object() if rmvpe else None
    jvc = JP.VoiceConverter.__new__(JP.VoiceConverter)
    jvc.cfg, jvc.rmvpe, jvc.crepe = JP.RVCPipelineConfig(f0_method=method), jrm, None
    tvc = TP.VoiceConverter.__new__(TP.VoiceConverter)
    tvc.cfg, tvc.rmvpe = TP.RVCPipelineConfig(f0_method=method), jrm
    assert tvc._f0_on_host() == jvc._f0_on_host()


def test_to_t100_matches_jax():
    f0 = np.random.default_rng(7).uniform(80, 300, 37).astype(np.float32)
    for n in (16000, 5920):
        ref = np.asarray(JP.VoiceConverter._to_t100(f0, n))
        np.testing.assert_array_equal(TP.VoiceConverter._to_t100(f0, n), ref)


def test_convert_without_rmvpe_fuses_yin_and_ignores_autotune(monkeypatch):
    """With no RMVPE model "rmvpe" runs YIN inside each group's conversion
    step, times the transpose factor, and ``f0_autotune`` does not apply
    (the JAX converter never calls ``_extract_f0`` there): convert end to end
    with zero noise against the JAX converter, mel-L1 < 1e-2 and max|diff|
    < 1e-3, and the port's output with the snap on equals the one with it
    off."""
    _Noise(zero=True).patch(monkeypatch)
    jvc, tvc = _pair("rmvpe", rmvpe=False, f0_autotune=True)
    assert not jvc._f0_on_host() and not tvc._f0_on_host()
    x = np.concatenate([_voice(n=16000, seed=8), _voice(n=8000, seed=9, f=300.0)])
    ref = jvc.convert(x, sid=1, transpose=2, seed=0)
    out = tvc.convert(x, sid=1, transpose=2, seed=0)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _mel_l1(out, ref, 48000) < 1e-2
    assert np.abs(out - ref).max() < 1e-3
    tvc.cfg.f0_autotune = False
    np.testing.assert_array_equal(tvc.convert(x, sid=1, transpose=2, seed=0), out)
