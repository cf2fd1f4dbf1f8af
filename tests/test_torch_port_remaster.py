"""The port's Remaster processor (pipelines/processors/remaster.py) against
the JAX package's, on the CPU: the host copies (mid/side, loudest pieces,
the limiters) give the JAX functions' arrays, ``match_spectrum`` and
``matchering_master`` agree within 1e-4 of the output's peak (fp32 FFTs of
up to 2**16 points, summed in another order), and Remaster through both
packages' ``run_chain`` writes the same WAVs to a PCM-16 step.  Every EQ
here filters a 2 s target against one loud 1 s piece of its reference, so
the JAX side compiles ``match_spectrum`` once per worker."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.core.audio_io import read_audio as j_read_audio
from audiolab_tpu.pipelines import chain as JC
from audiolab_tpu.pipelines.processors import remaster as JR
from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.pipelines.chain import run_chain
from audiolab_tpu_torch.pipelines.processors import remaster as TR

SR = 22050
PCM16 = 1.0 / 32767.0 + 1e-6   # one 16-bit step: see test_torch_port_processors


def _track(seconds, seed, tilt):
    """A stereo bed whose level rises through the track (loud and quiet
    pieces) and whose spectrum leans by ``tilt``."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    x = rng.standard_normal((2, n))
    spec = np.fft.rfft(x, axis=-1)
    f = np.linspace(0.0, 1.0, spec.shape[-1])
    x = np.fft.irfft(spec * (1.0 + tilt * f), n=n, axis=-1)
    env = np.linspace(0.3, 1.0, n)
    x = 0.15 * x / np.abs(x).max() * env
    x[1] = 0.8 * x[1] + 0.2 * x[0]
    return x.astype(np.float32)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def test_host_copies_are_the_jax_functions():
    x = _track(3.0, 0, 2.0)
    for a, b in zip(TR.ms_encode(x), JR.ms_encode(x)):
        np.testing.assert_array_equal(a, b)
    m, s = JR.ms_encode(x)
    np.testing.assert_array_equal(TR.ms_decode(m, s, 2), JR.ms_decode(m, s, 2))
    np.testing.assert_array_equal(TR.ms_encode(x[:1])[1], JR.ms_encode(x[:1])[1])
    mask = TR.loudest_pieces(m, SR)
    np.testing.assert_array_equal(mask, JR.loudest_pieces(m, SR))
    assert TR.piece_rms(m, SR, mask) == JR.piece_rms(m, SR, mask)
    loud = 3.0 * x
    np.testing.assert_array_equal(TR.limiter_lookahead(loud, SR), JR.limiter_lookahead(loud, SR))
    np.testing.assert_array_equal(TR.soft_limit(loud), JR.soft_limit(loud))


def test_match_spectrum_matches_jax():
    """A 2 s target against a 1 s reference (2**16-point FFTs): 1e-4 of
    the output's peak."""
    t, r = _track(2.0, 1, 3.0)[:1], _track(1.0, 2, -0.5)[:1]
    ref = np.asarray(JR.match_spectrum(jnp.asarray(t), jnp.asarray(r)))
    out = TR.match_spectrum(torch.from_numpy(t), torch.from_numpy(r)).numpy()
    assert out.shape == ref.shape == t.shape
    assert _rel(out, ref) <= 1e-4
    # the EQ moved the spectrum: the output is not the input
    assert np.abs(out - t).max() > 1e-2 * np.abs(t).max()


def test_matchering_master_matches_jax():
    """Level stage, mid and side EQ, RMS steps and the lookahead limiter
    (the reference is loud enough for the limiter to act): 1e-4 of peak."""
    t, r = _track(2.0, 3, 2.0), 4.0 * _track(2.0, 4, -0.5)
    ref = JR.matchering_master(t, r, SR)
    out = TR.matchering_master(t, r, SR, device="cpu")
    assert out.dtype == ref.dtype == np.float32 and out.shape == ref.shape
    assert _rel(out, ref) <= 1e-4
    assert np.abs(ref).max() <= 0.985 + 1e-6


@pytest.fixture
def song(tmp_path):
    p = tmp_path / "song.wav"
    write_wav(p, _track(2.0, 5, 1.0), SR)
    return str(p)


def _both(tmp_path, titles, files, settings):
    j = JC.run_chain(list(titles), list(files), json.loads(json.dumps(settings)),
                     output_root=str(tmp_path / "jax"))
    t = run_chain(list(titles), list(files), json.loads(json.dumps(settings)),
                  output_root=str(tmp_path / "port"), device="cpu")
    return j[0].last_outputs, t[0].last_outputs


@pytest.mark.parametrize("case", ["source", "reference", "lufs"])
def test_remaster_chain_matches_jax(tmp_path, song, case):
    """Remaster against the project's source track (the input itself, as
    the chain copies it), against an uploaded reference at another rate
    (host resample), and with no reference (target LUFS + soft limit): the
    same WAV names, rates and shapes, samples within a PCM-16 step of the
    JAX run's."""
    src = read_audio(song).samples
    quiet = tmp_path / "quiet_take.wav"
    write_wav(quiet, 0.4 * src, SR)
    settings = {"Remaster": {}}
    if case == "reference":
        refp = tmp_path / "reference.wav"
        write_wav(refp, _track(2.0, 6, -0.5), 16000)
        settings["Remaster"]["reference_file"] = str(refp)
    elif case == "lufs":
        settings["Remaster"] = {"use_source_track_as_reference": False, "target_lufs": -12.0}
    j, t = _both(tmp_path, ["Remaster"], [str(quiet)], settings)
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j] == [
        "quiet_take_remastered.wav"]
    a, b = read_audio(t[0]), j_read_audio(j[0])
    assert a.sample_rate == b.sample_rate == SR and a.samples.shape == b.samples.shape
    assert np.abs(a.samples - b.samples).max() <= PCM16
