"""The port's TTS pipeline (pipelines/tts.py), its host code (the emotion
chunk parser, the phonemizer copy, the tokenizers) and the speech routes
(serve/tts_api.py) against the JAX package's, on the CPU, with the test
width of tests/torch_port_tiny.py (the hybrid Mamba2 mixer) and a narrow
DAC at the published rates.

``synthesize`` is held to 1e-5 of max|y|: the codes are JAX's exactly (the
port takes the draws the JAX keys give) and the float paths agree to fp32
rounding (tests/test_torch_port_zonos.py)."""

import base64
from pathlib import Path

import numpy as np
import pytest

from audiolab_tpu.models import lm as JLm
from audiolab_tpu.models import phonemize as JPh
from audiolab_tpu.models import zonos as JZ
from audiolab_tpu.pipelines import tts as JT
from audiolab_tpu.serve import tts_api as j_tts_api
from audiolab_tpu.serve.http import Router as JRouter
from audiolab_tpu_torch.core.audio_io import read_wav
from audiolab_tpu_torch.models import phonemize as TPh
from audiolab_tpu_torch.models import zonos as TZ
from audiolab_tpu_torch.pipelines import tts as TT
from audiolab_tpu_torch.serve import tts_api as t_tts_api
from audiolab_tpu_torch.serve.http import RawResponse, Router
from tests import torch_port_tiny as tiny

# tests/test_phonemize_ipa.py's espeak fixture: one "word<TAB>ipa" a line
FIXTURE_WORDS = [ln.split("\t")[0] for ln in (Path(__file__).parent / "fixtures"
                 / "espeak_en_us_ipa.tsv").read_text().splitlines()
                 if ln and not ln.startswith("#")]
TTS_CFG = dict(max_seconds=0.5, frame_rate=24.0)
TEXT = "Hello there, my friend. [happiness] What a lovely day it is!"


@pytest.fixture(scope="module")
def engines():
    """(JAX ZonosTTS, port ZonosTTS) holding the same weights."""
    cfg, p, tm = tiny.zonos("mamba2")
    dcfg, dp, td = tiny.dac()
    sp, ts = tiny.speaker_encoder()
    jt = JT.ZonosTTS(cfg, p, dcfg, dp, sp, JT.ZonosTTSConfig(**TTS_CFG))
    tt = TT.ZonosTTS(tm, td, ts, TT.ZonosTTSConfig(**TTS_CFG), device="cpu")
    return jt, tt


# ------------------------------------------------------------------ host code

@pytest.mark.parametrize("text", [
    TEXT, "One. Two. Three.", "[sadness] Oh no. [ANGER] Stop it! [fear]", "", "   ",
    "No tags, one sentence", "Mixed [surprise]tag inside. And after? Yes!"])
def test_parse_emotion_chunks_matches_jax(text):
    ref = JT.parse_emotion_chunks(text)
    out = TT.parse_emotion_chunks(text)
    assert [s for s, _ in out] == [s for s, _ in ref]
    for (_s, a), (_r, b) in zip(out, ref):
        np.testing.assert_array_equal(a, b)


SENTENCES = ["Hello world, this is a test.", "Strange xylophones vibrate, quietly echoing!",
             "The 42 churches were boxed; cats loved it.", TEXT]


@pytest.mark.parametrize("fn", ["word_to_phonemes", "phonemize", "phonemize_ids",
                                "phonemize_ipa", "normalize_text"])
def test_phonemize_copy_matches_jax(fn):
    """The copy gives the JAX module's output on every fixture word of
    tests/test_phonemize_ipa.py and on a few sentences."""
    for text in FIXTURE_WORDS + SENTENCES:
        a, b = getattr(TPh, fn)(text), getattr(JPh, fn)(text)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, text


def test_tokenizers_match_jax():
    for text in SENTENCES:
        np.testing.assert_array_equal(TZ.tokenize_text(text, 20), JZ.tokenize_text(text, 20))
    ipa = [JPh.phonemize_ipa(s) for s in SENTENCES]
    np.testing.assert_array_equal(TZ.tokenize_phonemes_np(ipa), JZ.tokenize_phonemes_np(ipa))
    assert TZ.ZONOS_PHONEME_VOCAB == JZ.ZONOS_PHONEME_VOCAB


def test_register_default_backends_matches_jax():
    for kw in (dict(zonos=1), dict(zonos=1, dia=2), dict(zonos=1, xtts=3, chatterbox=4), {}):
        tables = []
        for pkg in (JT, TT):
            table = {}

            class Api:
                @staticmethod
                def register_backend(name, be, table=table):
                    table[name] = be

            pkg.register_default_backends(Api, **kw)
            tables.append(table)
        assert tables[0] == tables[1]


# ------------------------------------------------------------------ pipeline

def test_synthesize_matches_jax(engines):
    """Two sentences with an [emotion] tag, batched into one decode: the
    waveform within 1e-5 of max|y| of the JAX pipeline's."""
    jt, tt = engines
    ref, sr = jt.synthesize(TEXT, seed=5)
    out, sr_t = tt.synthesize(TEXT, seed=5, draws=lambda *shape: tiny.jax_draws(5, *shape),
                              timed=True)
    assert sr == sr_t == 44100
    assert out.shape == ref.shape and np.isfinite(out).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    st = tt.last_stats
    assert st["batch"] == 2 and st["steps"] == st["frames"] + 3
    assert all(st[k] >= 0 for k in ("prefill_s", "decode_s", "dac_s"))


@pytest.mark.parametrize("sr", [16000, 22050])
def test_speaker_embedding_matches_jax(engines, sr):
    jt, tt = engines
    wav = (0.1 * np.random.default_rng(13).standard_normal(sr)).astype(np.float32)
    ref = jt.make_speaker_embedding(wav, sr)
    out = tt.make_speaker_embedding(wav, sr)
    assert out.shape == (16,)
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


# ------------------------------------------------------------------ routes

@pytest.fixture
def routers(engines):
    """JAX and port routers with the TTS routes, "zonos" registered in each
    package's table (both tables restored afterwards)."""
    saved = dict(j_tts_api._BACKENDS), dict(t_tts_api._BACKENDS)
    j_tts_api._BACKENDS.clear()
    t_tts_api._BACKENDS.clear()
    jr, tr = JRouter(), Router()
    j_tts_api.register(jr)
    t_tts_api.register(tr)
    try:
        yield jr, tr, engines
    finally:
        for table, old in zip((j_tts_api._BACKENDS, t_tts_api._BACKENDS), saved):
            table.clear()
            table.update(old)


@pytest.mark.parametrize("path", ["/api/v1/audio/speech/models", "/api/v1/audio/speech/voices",
                                  "/api/v1/audio/speech/formats"])
def test_listing_routes_match_jax(routers, path):
    jr, tr, (jt, tt) = routers
    assert tr.dispatch("GET", path, {}) == jr.dispatch("GET", path, {})  # nothing loaded
    j_tts_api.register_backend("zonos", jt)
    t_tts_api.register_backend("zonos", tt)
    assert tr.dispatch("GET", path, {}) == jr.dispatch("GET", path, {})


def test_speech_route_returns_a_wav_and_the_download_works(routers, tmp_path):
    jr, tr, (_jt, tt) = routers
    t_tts_api.register_backend("zonos", tt)
    code, body = tr.dispatch("POST", "/api/v1/audio/speech",
                             {"model": "zonos", "input": "Hi there. Bye now.", "speed": 1.2})
    assert code == 200 and body["format"] == "wav" and body["sample_rate"] == 44100
    data = base64.b64decode(body["audio"])
    (tmp_path / "s.wav").write_bytes(data)
    wav = read_wav(tmp_path / "s.wav")
    chunk = int(min(0.5, 1.5) * 24.0) * 512
    assert wav.sample_rate == 44100
    assert wav.samples.shape == (1, 2 * chunk + int(0.12 * 44100))
    code, raw = tr.dispatch("GET", f"/api/v1/audio/speech/download/{body['file_id']}", {})
    assert code == 200 and isinstance(raw, RawResponse) and raw.body == data
    assert tr.dispatch("POST", "/api/v1/audio/speech", {"model": "zonos"})[0] == 400
    assert tr.dispatch("GET", "/api/v1/audio/speech/download/nope", {})[0] == 404


def test_unloaded_model_is_501(routers):
    jr, tr, (_jt, tt) = routers
    t_tts_api.register_backend("zonos", tt)
    j_tts_api.register_backend("zonos", _jt)
    body = {"model": "dia", "input": "hello"}
    assert tr.dispatch("POST", "/api/v1/audio/speech", body)[0] == 501
    assert jr.dispatch("POST", "/api/v1/audio/speech", body)[0] == 501


def test_random_zonos_keeps_the_rope_frequencies():
    """The demo model's weights come from fast_init, which leaves the
    attention's rotary frequencies (a buffer that is not persistent) alone,
    so they are the JAX package's rope_freqs."""
    tts = TT.random_zonos(seed=3, device="cpu")
    c = tts.model.cfg
    attn = [layer.mixer for layer in tts.model.backbone.layers if layer.attn]
    assert attn
    want = JLm.rope_freqs(JLm.LMConfig(dim=c.dim, n_heads=c.n_heads, rope_theta=10000.0))
    for blk in attn:
        np.testing.assert_array_equal(blk.freqs.numpy(), want)
