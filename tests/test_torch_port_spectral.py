"""Parity of the port's spectral front end and chunking with the JAX
package's, on the CPU: STFT/iSTFT (including hops that do not divide n_fft
and ``length=``), spectrogram, mel, resample and the chunk planner/stitch.
Tolerance 1e-5 (relative to the largest magnitude where stated): both sides
compute in fp32, the port with an FFT, the JAX package with DFT matmuls."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.core import chunking as JC
from audiolab_tpu_torch.core import chunking as TC
from audiolab_tpu_torch.kernels import mel as TM
from audiolab_tpu_torch.kernels import resample as TR
from audiolab_tpu_torch.kernels import stft as TS

# the JAX package's kernels/__init__ re-exports functions under the module
# names, so the modules are reached through importlib
JS = importlib.import_module("audiolab_tpu.kernels.stft")
JM = importlib.import_module("audiolab_tpu.kernels.mel")
JR = importlib.import_module("audiolab_tpu.kernels.resample")


def _signal(shape, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,win,window", [
    (512, 128, None, "hann"), (400, 160, None, "hann"), (256, 100, None, "hann"),
    (512, 160, 400, "hann"), (256, 64, None, "hamming")])
def test_stft_matches_jax(n_fft, hop, win, window):
    x = _signal((2, 3000))
    r, i = JS.stft(jnp.asarray(x), n_fft=n_fft, hop=hop, win_length=win, window=window)
    rt, it = TS.stft(torch.from_numpy(x), n_fft=n_fft, hop=hop, win_length=win, window=window)
    peak = float(np.abs(np.asarray(r)).max())
    np.testing.assert_allclose(rt.numpy(), np.asarray(r), atol=1e-5 * peak, rtol=0)
    np.testing.assert_allclose(it.numpy(), np.asarray(i), atol=1e-5 * peak, rtol=0)


@pytest.mark.parametrize("n_fft,hop,length", [
    (512, 128, None), (512, 128, 2900), (400, 160, 2900), (256, 100, None), (256, 100, 3000)])
def test_istft_matches_jax(n_fft, hop, length):
    """Round trip through each side's own STFT; hop 160/100 take the general
    overlap-add path."""
    x = _signal((2, 3000), 1)
    r, i = JS.stft(jnp.asarray(x), n_fft=n_fft, hop=hop)
    y = np.asarray(JS.istft(r, i, n_fft=n_fft, hop=hop, length=length))
    yt = TS.istft(torch.from_numpy(np.array(r)), torch.from_numpy(np.array(i)),
                  n_fft=n_fft, hop=hop, length=length)
    assert yt.shape == y.shape
    np.testing.assert_allclose(yt.numpy(), y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_spectrogram_matches_jax(power):
    x = _signal((3000,), 2)
    s = np.asarray(JS.spectrogram(jnp.asarray(x), n_fft=512, hop=128, power=power))
    st = TS.spectrogram(torch.from_numpy(x), n_fft=512, hop=128, power=power).numpy()
    np.testing.assert_allclose(st, s, atol=1e-5 * np.abs(s).max(), rtol=0)


@pytest.mark.parametrize("htk,norm,fmin,fmax", [
    (True, "slaney", 30.0, 8000.0), (False, "slaney", 0.0, None), (True, None, 0.0, None)])
def test_mel_matches_jax(htk, norm, fmin, fmax):
    np.testing.assert_allclose(TM.mel_filterbank(16000, 1024, 128, fmin, fmax, htk, norm),
                               np.asarray(JM.mel_filterbank(16000, 1024, 128, fmin, fmax,
                                                            htk, norm)), atol=1e-7)
    x = _signal((2, 4000), 3)
    m = JM.mel_spectrogram(jnp.asarray(x), sr=16000, n_fft=1024, hop=160, n_mels=128,
                           fmin=fmin, fmax=fmax, htk=htk, norm=norm, power=1.0)
    mt = TM.mel_spectrogram(torch.from_numpy(x), sr=16000, n_fft=1024, hop=160, n_mels=128,
                            fmin=fmin, fmax=fmax, htk=htk, norm=norm, power=1.0)
    np.testing.assert_allclose(mt.numpy(), np.asarray(m), atol=1e-5 * np.abs(m).max(), rtol=0)
    np.testing.assert_allclose(TM.log_mel(mt).numpy(), np.asarray(JM.log_mel(m)), atol=1e-4)


@pytest.mark.parametrize("orig,target", [(44100, 16000), (16000, 48000), (48000, 16000),
                                         (16000, 16000)])
def test_resample_matches_jax(orig, target):
    x = _signal((2, 4410), 4)
    y = np.asarray(JR.resample(jnp.asarray(x), orig, target))
    yt = TR.resample(torch.from_numpy(x), orig, target).numpy()
    assert yt.shape == y.shape
    np.testing.assert_allclose(yt, y, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,chunk,overlap", [(1000, 300, 60), (1000, 1200, 100),
                                             (601, 300, 0), (900, 300, 299)])
def test_chunking_matches_jax(n, chunk, overlap):
    assert TC.plan_chunks(n, chunk, overlap) == TC.ChunkPlan(
        **JC.plan_chunks(n, chunk, overlap).__dict__)
    plan_j, plan_t = JC.plan_chunks(n, chunk, overlap), TC.plan_chunks(n, chunk, overlap)
    x = _signal((2, n), 5)
    cj = np.asarray(JC.extract_chunks(jnp.asarray(x), plan_j))
    ct = TC.extract_chunks(torch.from_numpy(x), plan_t)
    np.testing.assert_array_equal(ct.numpy(), cj)
    proc = _signal(cj.shape, 6)
    for crossfade in (True, False):
        sj = np.asarray(JC.stitch_chunks(jnp.asarray(proc), plan_j, crossfade=crossfade))
        st = TC.stitch_chunks(torch.from_numpy(proc), plan_t, crossfade=crossfade).numpy()
        np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
