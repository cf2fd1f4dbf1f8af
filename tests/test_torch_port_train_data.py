"""The port's RVC training data pipeline against the JAX package's, on the
CPU: the silence slicer, preprocessing (identical WAV bytes at both rates),
the filelist, feature extraction with tests/test_train_e2e.py's stub HuBERT
and the loader's batches.  Both packages read the same synthetic dataset
(seeded numpy tones with a silent gap, one file at 44.1 kHz).

Tolerances: features 1e-5 (fp32 products in another order), f0 1e-2 Hz (the
YIN tolerance of tests/test_torch_port_f0.py), the coarse bins and every
host-side array exactly, the loader's magnitude spectrogram 1e-5 of its
max (fp32 FFTs of two libraries).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from audiolab_tpu.core.audio_io import write_wav
from audiolab_tpu.train import data as JD
from audiolab_tpu_torch.train import data as TD
from tests.test_train_e2e import _stub_hubert

PRE = dict(sr=48000, slice_seconds=0.8, overlap_seconds=0.2, threshold_db=-60.0)
BASIS = np.random.default_rng(7).standard_normal((320, 32)) * 0.1   # _stub_hubert's


def _stub_hubert_torch(wavs: torch.Tensor) -> torch.Tensor:
    """_stub_hubert in torch: (b, n) 16 kHz -> (b, t50, 32)."""
    b, n = wavs.shape
    t = n // 320
    frames = wavs[:, : t * 320].reshape(b, t, 320)
    return torch.tanh(frames @ torch.from_numpy(BASIS.astype(np.float32)))


def _voice(sr, seconds, f, seed, gap=None):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.3 * np.sin(2 * np.pi * (f + 15 * np.sin(2 * np.pi * 3 * t)) * t)
    x = x + 0.01 * rng.standard_normal(len(t))
    if gap is not None:
        x[int(gap[0] * sr): int(gap[1] * sr)] = 0.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    raw = root / "raw"
    raw.mkdir()
    write_wav(str(raw / "take0.wav"), _voice(48000, 2.2, 180, 0), 48000)
    write_wav(str(raw / "take1.wav"), _voice(44100, 2.0, 230, 1), 44100)
    write_wav(str(raw / "take2.wav"), _voice(48000, 4.0, 150, 2, gap=(1.6, 2.3)), 48000)
    return root


@pytest.fixture(scope="module")
def prepared(dataset):
    """Both packages' preprocess, features and filelist on the dataset."""
    out = {}
    for name, mod, stub, kw in (("jax", JD, _stub_hubert, {}),
                                ("port", TD, _stub_hubert_torch, {"device": "cpu"})):
        exp = dataset / name
        n = mod.preprocess_dataset(str(dataset / "raw"), str(exp), mod.PreprocessConfig(**PRE))
        m = mod.extract_features(str(exp), stub, batch_size=4, **kw)
        out[name] = (exp, n, m, mod.write_filelist(str(exp), sid=1))
    return out


@pytest.mark.parametrize("signal", ["gaps", "noise", "short", "silent"])
def test_slice_silence_matches_jax(signal):
    x = {"gaps": _voice(48000, 4.0, 200, 3, gap=(1.0, 1.8)),
         "noise": (0.2 * np.random.default_rng(4).standard_normal(30000)).astype(np.float32),
         "short": _voice(48000, 0.3, 300, 5),
         "silent": np.zeros(20000, np.float32)}[signal]
    ref = JD.slice_silence(x, 48000, threshold_db=-50.0)
    got = TD.slice_silence(x, 48000, threshold_db=-50.0)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("folder", ["gt_wavs", "16k_wavs"])
def test_preprocess_writes_the_same_files(prepared, folder):
    (jexp, jn, _, _), (texp, tn, _, _) = prepared["jax"], prepared["port"]
    assert tn == jn >= 8
    names = sorted(p.name for p in (jexp / folder).iterdir())
    assert names == sorted(p.name for p in (texp / folder).iterdir()) and len(names) == jn
    for name in names:
        assert (texp / folder / name).read_bytes() == (jexp / folder / name).read_bytes(), name


def test_filelist_matches_jax(prepared):
    (jexp, _, _, jfl), (texp, _, _, tfl) = prepared["jax"], prepared["port"]
    ref = json.loads(Path(jfl).read_text().replace(str(jexp), "EXP"))
    assert json.loads(Path(tfl).read_text().replace(str(texp), "EXP")) == ref


@pytest.mark.parametrize("kind", ["feats", "f0", "f0c"])
def test_extract_features_matches_jax(prepared, kind):
    (jexp, jn, jm, _), (texp, _, tm, _) = prepared["jax"], prepared["port"]
    assert tm == jm == jn
    for p in sorted((jexp / kind).glob("*.npy")):
        ref, got = np.load(p), np.load(texp / kind / p.name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, p.name
        if kind == "f0c":
            np.testing.assert_array_equal(got, ref, err_msg=p.name)
        else:
            np.testing.assert_allclose(got, ref, atol={"feats": 1e-5, "f0": 1e-2}[kind],
                                       rtol=0, err_msg=p.name)


def test_loader_batches_match_jax(prepared):
    """Two epochs of batch 3 over the JAX package's files (the last partial
    batch dropped): the same examples in the same order, the spectrogram
    computed on the device."""
    jfl = prepared["jax"][3]
    cfg = dict(sr=48000, n_fft=2048, hop=480, win_length=2048, batch_size=3, seed=5)
    jl = JD.RVCDataLoader(jfl, JD.LoaderConfig(**cfg))
    tl = TD.RVCDataLoader(jfl, TD.LoaderConfig(**cfg), device="cpu")
    assert len(tl) == len(jl) >= 2
    jb, tb = list(jl.batches(epochs=2)), list(tl.batches(epochs=2))
    assert len(tb) == len(jb) == 2 * len(jl)
    for j, t in zip(jb, tb):
        assert set(t) == set(j)
        for k in j:
            ref, got = np.asarray(j[k]), t[k].numpy()
            assert got.shape == ref.shape, k
            if k == "spec":
                np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
            else:
                np.testing.assert_array_equal(got, ref.astype(got.dtype), err_msg=k)
    assert not torch.equal(tb[0]["phone"], tb[1]["phone"])
