"""Parity of the port's host-side RVC surface with the JAX package's, on the
CPU: the host resampler, k-means and the retrieval index, the WAV codec
(byte for byte), ``sweep_convert`` and the debug-audio dump."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.core import audio_io as JIO
from audiolab_tpu.kernels.resample import resample_poly_np as j_resample_poly_np
from audiolab_tpu.retrieval import index as JI
from audiolab_tpu_torch.core import audio_io as TIO
from audiolab_tpu_torch.kernels.resample import resample_poly_np
from audiolab_tpu_torch.pipelines import rvc as TP
from audiolab_tpu_torch.retrieval import index as TI
from tests import torch_port_tiny as tiny


@pytest.mark.parametrize("rates", [(44100, 16000), (16000, 48000), (48000, 48000)])
def test_resample_poly_np_matches_jax(rates):
    x = np.random.default_rng(0).standard_normal((2, 4410)).astype(np.float32)
    ref = j_resample_poly_np(x, *rates)
    out = resample_poly_np(x, *rates)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def _jax_init(n, n_clusters, seed):
    """The rows the JAX kmeans starts from (jax.random.choice on its seed)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (n_clusters,),
                                        replace=n < n_clusters))


def _kmeans_case(n, d, n_clusters, iters, seed):
    """Well-separated clusters with the JAX kmeans's starting rows one in
    each, so that no row sits near a tie between two centres (a tie would
    let fp32 sums in another order move a row and its centres)."""
    rng = np.random.default_rng(seed)
    start = _jax_init(n, n_clusters, seed)
    labels = rng.integers(0, n_clusters, n)
    labels[start] = np.arange(n_clusters)
    centres = 3.0 * rng.standard_normal((n_clusters, d)).astype(np.float32)
    x = centres[labels] + rng.standard_normal((n, d), dtype=np.float32)
    ref = np.asarray(JI.kmeans(jnp.asarray(x), n_clusters=n_clusters, iters=iters, seed=seed))
    init = torch.from_numpy(x[start])
    out = TI.kmeans(torch.from_numpy(x), n_clusters=n_clusters, iters=iters, init=init).numpy()
    return x, out, ref


@pytest.mark.parametrize("iters", [1, 5])
def test_kmeans_matches_jax_2k_rows(iters):
    """2000 x 16 rows, 32 clusters, from the JAX kmeans's own starting rows:
    centres to 1e-4 after 1 and 5 Lloyd steps (fp32 sums in another order)."""
    _, out, ref = _kmeans_case(2000, 16, 32, iters, seed=iters)
    assert out.shape == ref.shape == (32, 16)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_kmeans_default_init_and_empty_clusters():
    """Without ``init`` the start rows come from numpy's generator on the
    seed; a centre that no row is nearest stays where it was."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((50, 4)).astype(np.float32))
    a = TI.kmeans(x, n_clusters=5, iters=3, seed=7)
    np.testing.assert_array_equal(a.numpy(), TI.kmeans(x, n_clusters=5, iters=3, seed=7).numpy())
    far = torch.cat([x[:3], torch.full((1, 4), 100.0)])
    c = TI.kmeans(x, n_clusters=4, iters=2, init=far)
    np.testing.assert_array_equal(c[3].numpy(), far[3].numpy())


@pytest.mark.slow
def test_kmeans_matches_jax_200k_rows():
    """At the index's compaction size: 200,001 rows of 768 (one past
    ``FeatureIndex.build``'s threshold), 64 clusters and 3 Lloyd steps from
    the JAX kmeans's starting rows: centres to 1e-3."""
    x, out, ref = _kmeans_case(200_001, 768, 64, 3, seed=0)
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_feature_index_matches_jax(tmp_path):
    """build (under and over the compaction threshold), save, load,
    device_data and blend against the JAX FeatureIndex."""
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    jfi = JI.FeatureIndex.build(feats)
    tfi = TI.FeatureIndex.build(feats, device="cpu")
    np.testing.assert_array_equal(tfi.features, jfi.features)
    tfi.save(str(tmp_path / "port.npz"))
    jfi.save(str(tmp_path / "jax.npz"))
    loaded = TI.FeatureIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(loaded.features, JI.FeatureIndex.load(
        str(tmp_path / "port.npz")).features)
    assert loaded.device_data() is loaded.device_data()
    ref = np.asarray(jfi.blend(jnp.asarray(q), 0.6))
    np.testing.assert_allclose(loaded.blend(torch.from_numpy(q), 0.6).numpy(), ref, atol=1e-5)
    small = TI.FeatureIndex.build(feats, compact_threshold=100, n_clusters=8, device="cpu")
    assert small.features.shape == (8, 16)


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "FLOAT"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_codec_bytes_match_jax(tmp_path, subtype, channels):
    """Both packages write the same bytes for the same array, and each reads
    the other's file to the same samples."""
    x = np.random.default_rng(channels).uniform(-1.2, 1.2, (channels, 3001)).astype(np.float32)
    x = x[0] if channels == 1 else x
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    TIO.write_wav(a, x, 44100, subtype)
    JIO.write_wav(b, x, 44100, subtype)
    assert a.read_bytes() == b.read_bytes()
    got, ref = TIO.read_wav(b), JIO.read_wav(a)
    assert got.sample_rate == ref.sample_rate == 44100 and got.channels == channels
    np.testing.assert_array_equal(got.samples, ref.samples)
    assert got.to_mono().samples.shape == (1, 3001) and got.duration == 3001 / 44100


def _converter():
    _, tsy = tiny.synth()
    _, thub = tiny.hubert()
    _, trm = tiny.rmvpe()
    return TP.VoiceConverter(tsy, thub, trm, device="cpu", cfg=TP.RVCPipelineConfig(
        sr=48000, chunk_seconds=0.5, overlap_seconds=0.1, device_batch=2,
        matmul_precision="highest"))


def test_sweep_convert_and_debug_dump(tmp_path, monkeypatch):
    """One file per combination, named as the JAX package names them, each
    the WAV of that combination's convert; with AUDIOLAB_SAVE_DEBUG_AUDIO set,
    convert writes the high-passed input and its output."""
    from tests.test_torch_port_rvc import _Noise

    _Noise(zero=True).patch(monkeypatch)
    vc = _converter()
    x = (0.3 * np.sin(2 * np.pi * 200 * np.arange(12000) / 16000)).astype(np.float32)
    paths = vc.sweep_convert(x, str(tmp_path / "sweep"), index_rates=(0.0,),
                             protects=(0.2, 0.5), transposes=(0, -2), name="take")
    names = [os.path.basename(p) for p in paths]
    assert names == ["take_ir0_pr0.2_tr+0.wav", "take_ir0_pr0.2_tr-2.wav",
                     "take_ir0_pr0.5_tr+0.wav", "take_ir0_pr0.5_tr-2.wav"]
    y = vc.convert(x, transpose=-2, index_rate=0.0, protect=0.5)
    JIO.write_wav(tmp_path / "expect.wav", y, 48000)
    assert (tmp_path / "expect.wav").read_bytes() == open(paths[3], "rb").read()
    dbg = tmp_path / "dbg"
    monkeypatch.setenv("AUDIOLAB_SAVE_DEBUG_AUDIO", str(dbg))
    y = vc.convert(x)
    files = sorted(os.listdir(dbg))
    assert len(files) == 2 and files[0].endswith("_converted.wav")
    assert files[1].endswith("_input16k_hp.wav")
    # 16-bit PCM: the writer truncates x * 32767, the reader divides by 32768
    np.testing.assert_allclose(TIO.read_wav(dbg / files[0]).samples[0], y, atol=2.0 / 32767)
    assert TIO.read_wav(dbg / files[1]).sample_rate == 16000
