"""The port's multi-take alignment (models/rtla.py, pipelines/align.py)
against the JAX package's, on the CPU: the CRNN and RtlaCRNN frame
classifiers at narrow widths (seeded flax trees carried over by
``crnn_from_jax`` / ``rtla_crnn_from_jax``; ``convert_rtla_crnn`` maps the
port's state_dict back), the RTLA front end and phoneme stream, chroma, the
host code (OLTW, sentence grouping and matching, crossfades), and
``align_take`` with and without the phoneme model.

Tolerances: frame outputs, mel power (the mel-dB front end read back as
power) and features within 1e-5 of their scale (fp32 convolutions, GRU /
LSTM steps and STFT sums in another order).
OLTW's argmins and the rounded warp indices follow the features exactly, so
the OLTW path and the warped take are held identical on the SAME features
(the JAX package's, handed to both implementations); end to end, each
package on its own features, on takes of gliding notes whose OLTW
decisions are not near a tie (stationary notes leave the costs flat, and a
4e-7 feature difference then flips a step), the output is identical too."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import rtla as JR
from audiolab_tpu.pipelines import align as JA
from audiolab_tpu.utils.convert import convert_rtla_crnn
from audiolab_tpu_torch.models import rtla as TR
from audiolab_tpu_torch.pipelines import align as TA
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny

SR = 16000
CRNN = dict(n_mels=16, n_classes=12, conv_ch=(4, 4, 8), gru_dim=16)
RTLA = dict(n_mels=66, num_lbl=12, model_complexity=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: its small recurrent and attention
    ops run fastest so, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def rtla_pair():
    """(JAX RtlaCRNN, flax template, flax params, port RtlaCRNN)."""
    jm = JR.RtlaCRNN(JR.RtlaCRNNConfig(**RTLA))
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 66))))["params"]
    p = tiny.filled(tpl, 70)
    tm = TR.RtlaCRNN(TR.RtlaCRNNConfig(**RTLA))
    tm.load_state_dict(W.rtla_crnn_from_jax(p), strict=True)
    return jm, tpl, p, tm.eval()


def _notes(pitches, durations, seed=0):
    """Harmonic notes (3 partials) of the given MIDI pitches and seconds,
    each gliding up 4 semitones: a stationary note would leave OLTW's
    costs flat along it, every step a near tie."""
    rng = np.random.default_rng(seed)
    out = []
    for m, d in zip(pitches, durations):
        t = np.arange(int(d * SR)) / SR
        f = 440.0 * 2 ** ((m - 69 + 4 * t / d) / 12)
        phase = 2 * np.pi * np.cumsum(f) / SR
        out.append(sum(0.3 / k * np.sin(k * phase) for k in (1, 2, 3)))
    x = np.concatenate(out)
    return (x + 0.003 * rng.standard_normal(len(x))).astype(np.float32)


def _words(durations, names, gap=0.0):
    words, t = [], 0.0
    for d, w in zip(durations, names):
        words.append({"word": w, "start": round(t, 3), "end": round(t + d - gap, 3)})
        t += d
    return words


PITCHES = (60, 64, 67, 72, 62, 65, 69, 71)
NAMES = ["one", "two", "three.", "four", "five", "six,", "seven", "eight"]
MASTER_D = (0.5, 0.4, 0.6, 0.5, 0.45, 0.5, 0.55, 0.45)
TAKE_D = (0.6, 0.35, 0.7, 0.4, 0.5, 0.6, 0.5, 0.5)


def test_crnn_matches_jax():
    jm = JR.CRNN(JR.CRNNConfig(**CRNN))
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 16))))["params"]
    p = tiny.filled(tpl, 71)
    tm = TR.CRNN(TR.CRNNConfig(**CRNN))
    tm.load_state_dict(W.crnn_from_jax(p), strict=True)
    mel = np.random.default_rng(0).standard_normal((2, 30, 16)).astype(np.float32)
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(mel)))
    with torch.no_grad():
        out = tm(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 30, 12)
    _close(out, ref)


def test_rtla_crnn_front_end_and_phoneme_stream_match_jax():
    jm, tpl, p, tm = rtla_pair()
    tiny.assert_tree_equal(convert_rtla_crnn(tiny.numpy_state(tm), tpl), p)
    x = _notes(PITCHES, MASTER_D)
    ref_db = np.asarray(JR.rtla_mel_db(x))
    db = TR.rtla_mel_db(x, device="cpu").numpy()
    assert db.shape == ref_db.shape == (len(x) // 640 - 1, 66)
    # as power: dB magnifies the STFT's rounding in bins 40 dB under the peak
    _close(10 ** (db / 10), 10 ** (ref_db / 10))
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(ref_db)[None]))
    with torch.no_grad():
        out = tm(torch.from_numpy(ref_db)[None]).numpy()
    _close(out, ref)
    ph_ref = JR.phoneme_features(x, SR, jm, p)
    ph = TR.phoneme_features(x, SR, tm, device="cpu")
    assert ph.shape == ph_ref.shape == (12, ref_db.shape[0] - 2)
    _close(ph, ph_ref)
    # 8 kHz resampled to 16 kHz: the bins above 4 kHz hold only rounding,
    # whose dB the two STFTs give up to 1e-3 apart; the CRNN reads dB, so
    # the posteriors there agree to 5e-5 of their scale
    x8 = x[::2].copy()
    _close(TR.phoneme_features(x8, 8000, tm, device="cpu"), JR.phoneme_features(x8, 8000, jm, p),
           rel=5e-5)


def test_chroma_and_oltw_match_jax():
    """Chroma within 1e-5; OLTW on the same features (both metrics) gives
    the same path, and the same strictly monotonic path."""
    m, t = _notes(PITCHES, MASTER_D), _notes(PITCHES, TAKE_D, seed=1)
    ref_m, ref_t = JR.chroma_features(m, SR), JR.chroma_features(t, SR)
    _close(TR.chroma_features(m, SR, device="cpu"), ref_m)
    for metric in ("cosine", "euclidean"):
        jp = JR.OLTW(ref_m, window=32, metric=metric).align(ref_t)
        tp = TR.OLTW(ref_m, window=32, metric=metric).align(ref_t)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(TR.make_path_strictly_monotonic(tp),
                                      JR.make_path_strictly_monotonic(jp))
    assert [c.tolist() for c in TR.StreamChunker(m, SR)] == [
        c.tolist() for c in JR.StreamChunker(m, SR)]


def test_sentences_matching_and_crossfade_match_jax():
    mw, tw = _words(MASTER_D, NAMES, 0.05), _words(TAKE_D, NAMES[:3] + ["for"] + NAMES[4:], 0.05)
    for a, b in (("kitten", "sitting"), ("", "abc"), ("same", "same")):
        assert TA.levenshtein(a, b) == JA.levenshtein(a, b)
    ms, ts = TA.group_sentences(mw), TA.group_sentences(tw)
    assert [vars(s) for s in ms] == [vars(s) for s in JA.group_sentences(mw)]
    assert TA.match_sentences(ms, ts) == JA.match_sentences(JA.group_sentences(mw),
                                                            JA.group_sentences(tw))
    regions = [np.ones(500, np.float32), np.zeros(300, np.float32), np.full(10, 2, np.float32)]
    np.testing.assert_array_equal(TA.crossfade_concat(regions, SR),
                                  JA.crossfade_concat(regions, SR))


@pytest.mark.parametrize("phonemes", [False, True])
def test_align_take_matches_jax(monkeypatch, phonemes):
    """A take of the master's eight notes at other durations, with and
    without the phoneme model: on the JAX features (handed to the port's
    warp) the aligned take and report are identical, and identical again
    with each package on its own features."""
    jm, _tpl, p, tm = rtla_pair()
    m, t = _notes(PITCHES, MASTER_D), _notes(PITCHES, TAKE_D, seed=1)
    mw, tw = _words(MASTER_D, NAMES), _words(TAKE_D, NAMES)
    # the JAX phoneme stream compiles its model anew at every call: keep each
    # region's stream (the same function of the same input)
    streams, j_phonemes = {}, JR.phoneme_features

    def phoneme_stream(wav, sr, *_args, **_kw):
        key = (wav.tobytes(), sr)
        if key not in streams:
            streams[key] = j_phonemes(wav, sr, jm, p)
        return streams[key]

    monkeypatch.setattr(JR, "phoneme_features", phoneme_stream)
    ref, ref_rep = JA.align_take(m, t, SR, mw, tw, phoneme_model=(jm, p) if phonemes else None)
    assert ref_rep["matched"] == 3 and ref.shape == m.shape
    kw = dict(phoneme_model=tm if phonemes else None, device="cpu")
    out, rep = TA.align_take(m, t, SR, mw, tw, **kw)
    assert rep == ref_rep
    np.testing.assert_array_equal(out, ref)
    monkeypatch.setattr(TA, "chroma_features",
                        lambda wav, sr, hop, device: JR.chroma_features(wav, sr, hop))
    monkeypatch.setattr(TA, "phoneme_features", phoneme_stream)
    out, rep = TA.align_take(m, t, SR, mw, tw, **kw)
    assert rep == ref_rep
    np.testing.assert_array_equal(out, ref)
