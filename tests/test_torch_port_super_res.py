"""The port's Super Resolution (pipelines/super_res.py and its processor)
against the JAX package's, on the CPU: ``sbr_enhance`` (STFT band copy and
iSTFT), ``super_resolve`` with the DSP enhancer and with an enhancer passed
in, and the processor through both packages' ``run_chain`` with
``tgt_ensemble`` off and on.  Outputs within 1e-4 of their peak (fp32
FFTs summed in another order; the crossover and loudness match are the
same host code on both sides); WAVs to a PCM-16 step.

The inputs are 1 s long: the JAX ``resample`` returns a wrong last sample
for some lengths (22050 -> 48000 Hz at 66,150 samples; ROADMAP queue 3),
which the port's does not share."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.core.audio_io import read_audio as j_read_audio
from audiolab_tpu.pipelines import chain as JC
from audiolab_tpu.pipelines import super_res as JS
from audiolab_tpu.pipelines.processors import super_res as JSP
from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.pipelines import super_res as TS
from audiolab_tpu_torch.pipelines.chain import run_chain
from audiolab_tpu_torch.pipelines.processors import super_res as TSP

SR = 44100
PCM16 = 1.0 / 32767.0 + 1e-6


def _tones(n, seed=0):
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * np.sin(2 * np.pi * 3100 * t),
                  0.25 * np.sin(2 * np.pi * 660 * t) + 0.1 * np.sin(2 * np.pi * 5200 * t)])
    return (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(autouse=True)
def slots():
    saved = [(c, c.enhancer_fn, c.ckpt_pipeline) for c in (JSP.SuperResolution,
                                                           TSP.SuperResolution)]
    yield
    for c, fn, pipe in saved:
        c.enhancer_fn, c.ckpt_pipeline = fn, pipe


def test_sbr_enhance_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 2, 12000)).astype(np.float32) * 0.2
    ref = np.asarray(JS.sbr_enhance(jnp.asarray(x)))
    out = TS.sbr_enhance(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == x.shape
    assert _rel(out, ref) <= 1e-4


def test_crossover_splice_is_the_jax_function():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((2, 2, 9000))
    np.testing.assert_array_equal(TS.crossover_splice(a, b, 48000, 9000.0),
                                  JS.crossover_splice(a, b, 48000, 9000.0))


def test_super_resolve_matches_jax():
    """Two chunks of 0.6 s with 0.1 s of overlap, the DSP enhancer and then
    an enhancer passed in (a gain on the chunk tensor, called on (count,
    ch, n) tensors on the device)."""
    x = _tones(SR)
    kw = dict(chunk_seconds=0.6, overlap_seconds=0.1)
    ref, sr = JS.super_resolve(x, SR, **kw)
    out, sr_t = TS.super_resolve(x, SR, device="cpu", **kw)
    assert sr == sr_t == 48000 and out.shape == ref.shape == (2, 48000)
    assert _rel(out, ref) <= 1e-4
    seen = []

    def gain(chunks):
        seen.append((type(chunks), tuple(chunks.shape)))
        return chunks * 1.5

    ref, _ = JS.super_resolve(x, SR, enhancer_fn=lambda c: c * 1.5, **kw)
    out, _ = TS.super_resolve(x, SR, enhancer_fn=gain, device="cpu", **kw)
    assert seen == [(torch.Tensor, (2, 2, 28800))]
    assert _rel(out, ref) <= 1e-4


@pytest.mark.parametrize("ensemble", [False, True])
def test_super_resolution_chain_matches_jax(tmp_path, ensemble):
    """Super Resolution through both packages' run_chain (chunk_size 5 s,
    the schema's least: one chunk), with the low-passed original blended in
    below tgt_cutoff or not: one <name>_48k.wav at 48 kHz, within a PCM-16
    step of the JAX run's."""
    song = tmp_path / "song.wav"
    write_wav(song, _tones(SR, seed=3), SR)
    settings = {"Super Resolution": {"chunk_size": 5.0, "tgt_ensemble": ensemble,
                                     "tgt_cutoff": 6000}}
    j = JC.run_chain(["Super Resolution"], [str(song)], json.loads(json.dumps(settings)),
                     output_root=str(tmp_path / "jax"))[0].last_outputs
    t = run_chain(["Super Resolution"], [str(song)], json.loads(json.dumps(settings)),
                  output_root=str(tmp_path / "port"), device="cpu")[0].last_outputs
    assert [os.path.basename(p) for p in t] == [os.path.basename(p) for p in j] == [
        "song_48k.wav"]
    a, b = read_audio(t[0]), j_read_audio(j[0])
    assert a.sample_rate == b.sample_rate == 48000 and a.samples.shape == b.samples.shape
    assert np.abs(a.samples - b.samples).max() <= PCM16


def test_configure_keeps_the_jax_signature(tmp_path):
    """configure(enhancer_fn=None, ckpt_pipeline=None); a configured
    enhancer runs in the processor, a checkpoint pipeline gets the
    schema's steps, guidance and seed."""
    calls = []

    class Pipe:
        guidance_scale = None

        def enhance_chunks(self, chunks, steps, seed):
            calls.append((tuple(chunks.shape), steps, seed, self.guidance_scale))
            return chunks

    TSP.SuperResolution.configure(ckpt_pipeline=Pipe())
    song = tmp_path / "song.wav"
    write_wav(song, _tones(SR // 2), SR)
    run_chain(["Super Resolution"], [str(song)],
              {"Super Resolution": {"chunk_size": 5.0, "ddim_steps": 12, "seed": 7,
                                    "guidance_scale": 2.5}},
              output_root=str(tmp_path / "port"), device="cpu")
    assert calls == [((1, 2, 240000), 12, 7, 2.5)]
    TSP.SuperResolution.configure()
    assert TSP.SuperResolution.enhancer_fn is None and TSP.SuperResolution.ckpt_pipeline is None
