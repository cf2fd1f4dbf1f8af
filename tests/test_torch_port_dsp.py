"""The port's DSP for the processors (dsp/stereo, loudness, silence, reverb,
pitch, autotune) against the JAX package's on the same seeded numpy input,
fp32, on the CPU.  Each test states its tolerance and why."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.dsp import autotune as JA
from audiolab_tpu.dsp import loudness as JL
from audiolab_tpu.dsp import pitch as JP
from audiolab_tpu.dsp import reverb as JR
from audiolab_tpu.dsp import silence as JS
from audiolab_tpu.dsp import stereo as JST
from audiolab_tpu.dsp.f0 import f0_autocorr as j_f0
from audiolab_tpu.kernels.resample import resample as j_resample
from audiolab_tpu_torch.dsp import autotune as TA
from audiolab_tpu_torch.dsp import loudness as TL
from audiolab_tpu_torch.dsp import pitch as TP
from audiolab_tpu_torch.dsp import reverb as TR
from audiolab_tpu_torch.dsp import silence as TS
from audiolab_tpu_torch.dsp import stereo as TST

CPU = "cpu"


def _tone(n, sr, f=220.0, noise=0.05, seed=0, amp=0.4):
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    return (amp * np.sin(2 * np.pi * f * t) + noise * rng.standard_normal(n)).astype(np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_stereo_mid_side_round_trip_matches_jax():
    """Elementwise: 1e-6 of max|y| (one or two fp32 roundings)."""
    x = np.stack([_tone(4000, 16000), _tone(4000, 16000, f=330.0, seed=1)])
    jm, js = JST.stereo_to_ms(jnp.asarray(x))
    tm, ts = TST.stereo_to_ms(_t(x))
    assert _rel(tm.numpy(), jm) < 1e-6 and _rel(ts.numpy(), js) < 1e-6
    back = TST.ms_to_stereo(tm, ts).numpy()
    assert _rel(back, JST.ms_to_stereo(jm, js)) < 1e-6
    np.testing.assert_allclose(back, x, atol=1e-6)


@pytest.mark.parametrize("n,new_len", [(8000, 8710), (8710, 8000), (5000, 5000), (3, 7)])
def test_resample_side_matches_jax(n, new_len):
    """Read positions are fp64 here and XLA's fp32 linspace there, which is
    off by up to one ulp of the largest position: the tolerance is that ulp
    times the largest step between neighbouring samples, plus 1e-6."""
    side = _tone(n, 44100, noise=0.02)
    ref = np.asarray(JST.resample_side(jnp.asarray(side), new_len))
    out = TST.resample_side(_t(side), new_len).numpy()
    assert out.shape == ref.shape == (new_len,)
    tol = np.spacing(np.float32(n)) * np.abs(np.diff(side)).max() + 1e-6 * np.abs(ref).max()
    assert np.abs(out - ref).max() <= tol


def test_integrated_loudness_is_the_jax_functions():
    """Host numpy/scipy copied: equal results."""
    x = np.stack([_tone(48000, 48000), 0.5 * _tone(48000, 48000, seed=3)])
    for a in (x, x[0], x[:, :1000], np.zeros((2, 48000), np.float32)):
        assert TL.integrated_loudness(a, 48000) == JL.integrated_loudness(a, 48000)
    np.testing.assert_array_equal(TL.normalize_loudness(x, 48000, -16.0),
                                  JL.normalize_loudness(x, 48000, -16.0))


@pytest.mark.parametrize("n,channels,sr_clone", [(22050, 1, 48000), (22050, 2, 48000),
                                                 (5000, 2, 22050), (700, 1, 22050)])
def test_restore_silence_matches_jax(n, channels, sr_clone):
    """Overlap-add of the framewise gains (fold here, scatter-add there) and
    the device resample of the clone: 1e-5 of max|y|.  n = 5000 leaves a
    tail no frame reaches, n = 700 is shorter than one window."""
    sr = 22050
    orig = _tone(n, sr) * (np.arange(n) > n // 5)       # a silent lead-in
    if channels == 2:
        orig = np.stack([orig, 0.5 * orig])
    clone = (0.2 * np.random.default_rng(1).standard_normal(int(n * sr_clone / sr))
             ).astype(np.float32)
    ref = JS.restore_silence(orig, clone, sr, sr_clone)
    out = TS.restore_silence(orig, clone, sr, sr_clone, device=CPU)
    assert out.shape == ref.shape == orig.shape
    assert np.abs(out - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-3)


def _exp_ir(sr, pre=0.01, rt=0.3, length=0.4):
    """Pre-delay, then white noise under an exponential decay of ``rt`` s."""
    n = int(sr * length)
    t = np.arange(n - int(pre * sr)) / sr
    tail = np.exp(-6.9 * t / rt) * np.random.default_rng(4).standard_normal(len(t))
    return np.concatenate([np.zeros(int(pre * sr)), tail]).astype(np.float32)


def test_extract_reverb_params_matches_jax():
    """A dry noise burst through a synthetic exponential IR: FFT
    cross-correlation and Wiener deconvolution in torch, the RT60 fit on the
    host; scalars to 1e-5 relative, the IR to 1e-5 of its peak, and the
    recovered IR close to the true one."""
    sr = 16000
    ir = _exp_ir(sr)
    dry = np.zeros(sr, np.float32)
    dry[: sr // 2] = np.random.default_rng(5).standard_normal(sr // 2) * 0.2
    wet = np.convolve(dry, ir)[:sr].astype(np.float32)
    ref = JR.extract_reverb_params(dry, wet, sr)
    got = TR.extract_reverb_params(dry, wet, sr, device=CPU)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k == "impulse_response":
            assert _rel(got[k], v) < 1e-5
        else:
            assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-9), k
    # Wiener deconvolution recovers the IR over its length
    rec = np.asarray(got["impulse_response"])[: len(ir)]
    assert _rel(rec, ir) < 1e-2


def test_apply_reverb_matches_jax(tmp_path):
    """FFT convolution, pre-delay pad and clip: 1e-5 of max|y|; the params
    survive save/load."""
    sr = 16000
    params = {"sample_rate": sr, "pre_delay": 0.012,
              "impulse_response": (0.3 * _exp_ir(sr, pre=0.0)).tolist()}
    path = TR.save_params(params, str(tmp_path / "p.json"))
    assert TR.load_params(path) == json.load(open(path)) == params
    x = np.stack([_tone(sr, sr), _tone(sr, sr, seed=2)])
    for dry in (x, x[0]):
        ref = JR.apply_reverb(dry, params)
        out = TR.apply_reverb(dry, params, device=CPU)
        assert out.shape == ref.shape and _rel(out, ref) < 1e-5


def test_generate_ir_and_note_helpers_are_the_jax_functions():
    kw = dict(sr=16000, pre_delay=0.02, decay_time=0.4, early_reflection_ratio=0.3,
              diffusion=0.01, spectral_centroid=6000.0, length=0.5, seed=3)
    np.testing.assert_array_equal(TR.generate_ir(**kw), JR.generate_ir(**kw))
    for note in ("A4", "C0", "F#3", "B7"):
        assert TP.note_to_hz(note) == JP.note_to_hz(note)
    for hz in (27.5, 261.6, 440.0, 3951.0):
        assert TP.hz_to_note(hz) == JP.hz_to_note(hz)
    np.testing.assert_array_equal(TA.chroma_filterbank(22050, 4096),
                                  JA.chroma_filterbank(22050, 4096))
    f = np.array([0.98, 1.0, 1.01, 1.2, 1.21, 0.9], np.float32)
    t = np.arange(len(f)) * 0.01
    assert TA.group_pitch_shift_factors(t, f) == JA.group_pitch_shift_factors(t, f)


def test_autotune_f0_matches_jax():
    """Exact: the same fp32 ops on each value."""
    f0 = np.array([0.0, 0.5, 100.0, 219.3, 445.0, 880.1, 1046.5], np.float32)
    np.testing.assert_array_equal(TP.autotune_f0(_t(f0)).numpy(),
                                  np.asarray(JP.autotune_f0(jnp.asarray(f0))))


@pytest.mark.parametrize("periods", [False, True])
def test_pitch_shift_granular_matches_jax(periods):
    """Grains read at fp64 positions rounded once (XLA's FMA), overlap-added
    by fold: 1e-5 of max|y|."""
    sr, hop = 22050, 512
    x = _tone(sr, sr)
    t_frames = sr // hop + 1
    rng = np.random.default_rng(1)
    f = rng.uniform(0.8, 1.2, t_frames).astype(np.float32)
    p = (np.where(rng.uniform(size=t_frames) > 0.3, 100.3, 0.0).astype(np.float32)
         if periods else None)
    ref = np.asarray(JP.pitch_shift_granular(jnp.asarray(x), jnp.asarray(f),
                                             None if p is None else jnp.asarray(p)))
    out = TP.pitch_shift_granular(_t(x), _t(f), None if p is None else _t(p)).numpy()
    assert out.shape == ref.shape == x.shape and _rel(out, ref) < 1e-5


@pytest.mark.parametrize("n_steps", [2.0, -3.0])
def test_pitch_shift_matches_jax(n_steps):
    """Through YIN's periods: the two YINs agree to about 1e-6 of f0, and a
    grain's read offset is the drift modulo the period, which multiplies a
    period's error by the drift's period count (tens here), so the
    tolerance is 2e-3 of max|y| (measured about 5e-4)."""
    sr = 22050
    x = _tone(sr, sr)
    ref = np.asarray(JP.pitch_shift(jnp.asarray(x), sr, n_steps))
    out = TP.pitch_shift(_t(x), sr, n_steps).numpy()
    assert out.shape == ref.shape == x.shape and _rel(out, ref) < 2e-3


@pytest.mark.parametrize("rate", [0.8, 1.25])
def test_time_stretch_matches_jax(rate):
    """Phases accumulate frame by frame in the scan's order, in fp32; the
    two STFTs' phase differences (about 1e-5 rad a frame) are summed over
    the output frames, where the phases reach 1e4-1e5 rad: 2e-3 of max|y|
    (measured 4e-4 to 7e-4)."""
    sr = 22050
    x = _tone(sr, sr)
    ref = np.asarray(JP.time_stretch(jnp.asarray(x), rate))
    out = TP.time_stretch(_t(x), rate).numpy()
    assert out.shape == ref.shape and _rel(out, ref) < 2e-3


@pytest.mark.parametrize("root", [0, 5])
def test_detect_key_matches_jax(root):
    """Chroma by an fp32 matmul, then the same host search: equal keys."""
    sr = 22050
    t = np.arange(sr * 2) / sr
    chord = sum(np.sin(2 * np.pi * 440.0 * 2 ** ((root + s) / 12) * t) for s in (0, 4, 7))
    x = (0.2 * chord).astype(np.float32)
    assert TA.detect_key(x, sr, device=CPU) == JA.detect_key(x, sr)


def test_auto_tune_track_matches_jax():
    """With the same f0 curve (f0_fn) both packages run the same grains:
    1e-5 of max|y|.  With each package's YIN, one fp32 ulp of f0 moves the
    period-locked drift as in test_pitch_shift_matches_jax: 3e-3 (measured
    1e-3).  The key agrees either way."""
    sr = 24000
    x = _tone(sr * 2, sr, f=433.0, noise=0.0)
    x2 = np.stack([x, 0.5 * x + _tone(sr * 2, sr, noise=0.01, amp=0.0)])
    x16 = np.asarray(j_resample(jnp.asarray(x), sr, 16000))
    f0 = np.asarray(j_f0(jnp.asarray(x16), sr=16000, hop=160)[0])

    def f0_fn(_audio16k):
        return f0

    for audio, strength in ((x, 1.0), (x2, 0.6)):
        ref = JA.auto_tune_track(audio, sr, strength=strength, f0_fn=f0_fn)
        out = TA.auto_tune_track(audio, sr, strength=strength, f0_fn=f0_fn, device=CPU)
        assert out[0].shape == ref[0].shape == audio.shape and out[1:] == ref[1:]
        assert _rel(out[0], ref[0]) < 1e-5
    ref = JA.auto_tune_track(x, sr, strength=1.0)
    out = TA.auto_tune_track(x, sr, strength=1.0, device=CPU)
    assert out[1:] == ref[1:] == ("A", "major") and _rel(out[0], ref[0]) < 3e-3
    # the tuned tone sits on A4
    spec = np.abs(np.fft.rfft(out[0]))
    assert abs(np.fft.rfftfreq(len(out[0]), 1 / sr)[spec.argmax()] - 440.0) < 1.0


def test_recreate_harmonies_matches_jax():
    """The background's windowed chord notes (the same note names) and the
    granular shift of the main vocal toward them, 2 s at 22.05 kHz, through
    the main vocal's YIN periods: as in test_pitch_shift_matches_jax a
    grain's read offset is the drift modulo the period, which multiplies
    the two YINs' period difference by the drift's period count, so the
    tolerance is 1e-3 of max|y| (measured 2.9e-4).  With the factors of a
    note ratio of 1 (no drift) the shift is the input's within 1e-5."""
    from audiolab_tpu.dsp import harmony as JH
    from audiolab_tpu_torch import dsp as TD

    sr, n = 22050, 44100
    t = np.arange(n) / sr
    bg = np.stack([0.3 * np.sin(2 * np.pi * np.where(t < 1.0, 220.0, 330.0) * t)] * 2)
    main = _tone(n, sr, f=196.0, noise=0.01, seed=3)
    ref = np.asarray(JH.recreate_harmonies(bg.astype(np.float32), main, sr))
    out = TD.recreate_harmonies(bg.astype(np.float32), main, sr, device=CPU)
    assert out.shape == ref.shape == (n,) and np.isfinite(out).all()
    assert _rel(out, ref) <= 1e-3
    c4 = np.stack([0.3 * np.sin(2 * np.pi * 261.6256 * t)] * 2).astype(np.float32)
    ref = np.asarray(JH.recreate_harmonies(c4, main, sr))
    out = TD.recreate_harmonies(c4, main, sr, device=CPU)
    assert _rel(out, ref) <= 1e-5
    f0 = np.where(np.arange(200) % 50 < 40, 261.63, 0.0)
    assert TD.harmony.detect_chord_notes(f0, 16000, 160, 0.5) == JH.detect_chord_notes(
        f0, 16000, 160, 0.5)
