"""The port's cloning stack against the JAX package's, on the CPU: the
OpenVoice tone-color converter (models/openvoice.py, its weights carried by
``openvoice_from_jax`` and read back by the JAX ``convert_openvoice``), the
OpenVoiceCloner, the k-means diarizer over the Zonos SpeakerEncoder,
``split_speakers``, the CloningFacade, and Clone's OpenVoice and TTS
methods and ``diarize_speakers`` through both packages' ``run_chain``.

Tolerances: ``extract_se`` within 1e-5 of max|g| and the converted
waveform within 1e-4 of max|y| (fp32 convolutions and a GRU summed in
another order); diarization turns identical when both k-means runs start
from the rows the JAX one draws (``jax.random.choice`` on seed 0); Clone's
WAVs within a PCM-16 step plus 1e-4 of their peak.  The TTS method runs the
tiny Zonos of tests/torch_port_tiny.py with the draws the JAX keys give, so
its codes are JAX's and its waveform agrees to fp32 rounding
(tests/test_torch_port_tts.py)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.core.audio_io import read_audio as j_read_audio
from audiolab_tpu.kernels.resample import resample_poly_np as j_resample_poly_np
from audiolab_tpu.models import openvoice as JO
from audiolab_tpu.models import zonos as JZ
from audiolab_tpu.pipelines import chain as JC
from audiolab_tpu.pipelines import cloning as JCl
from audiolab_tpu.pipelines import tts as JT
from audiolab_tpu.pipelines.processors import clone as JClone
from audiolab_tpu.serve import clone_api as j_clone_api
from audiolab_tpu.serve.http import Router as JRouter
from audiolab_tpu.utils.convert import convert_openvoice
from audiolab_tpu_torch.core.audio_io import read_audio, write_wav
from audiolab_tpu_torch.models import openvoice as TO
from audiolab_tpu_torch.pipelines import cloning as TCl
from audiolab_tpu_torch.pipelines import tts as TT
from audiolab_tpu_torch.pipelines.chain import run_chain
from audiolab_tpu_torch.pipelines.processors import clone as TClone
from audiolab_tpu_torch.retrieval.index import kmeans
from audiolab_tpu_torch.serve import clone_api as t_clone_api
from audiolab_tpu_torch.serve.http import Router
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny

SR = 8000
OV = dict(sr=SR, n_fft=128, hop=32, spec_channels=65, inter_channels=8, hidden_channels=8,
          gin_channels=16, upsample_rates=(4, 4, 2), upsample_kernel_sizes=(8, 8, 4),
          upsample_initial_channel=32)
CLONE_CFG = dict(chunk_seconds=0.5, overlap_seconds=0.1)
PCM16 = 1.0 / 32767.0 + 1e-6
TTS_CFG = dict(max_seconds=0.5, frame_rate=24.0)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def ov():
    """(JAX params, the flax template, port ToneColorConverter) at OV: the
    port module's seeded weights mapped onto the template by the JAX
    converter and carried back by openvoice_from_jax."""
    jm = JO.ToneColorConverter(JO.ToneColorConfig(**OV))
    spec = jnp.zeros((1, 8, OV["spec_channels"]))
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), spec, jnp.full((1,), 8),
                                         spec, spec))["params"]
    src = tiny.seeded(lambda: TO.ToneColorConverter(TO.ToneColorConfig(**OV)), 9, 0.05)
    p = tiny._f32(convert_openvoice(tiny._numpy(src), tpl))
    tm = TO.ToneColorConverter(TO.ToneColorConfig(**OV))
    tm.load_state_dict(W.openvoice_from_jax(p), strict=True)
    return p, tpl, tm.eval()


class _Jitted:
    """A flax module whose ``apply`` is compiled once per method and shape
    (the JAX cloner applies the converter op by op, which costs seconds of
    per-op compiles on the CPU; the values are the same)."""

    def __init__(self, module):
        self.module, self.fns = module, {}

    def apply(self, variables, *args, method=None):
        if method not in self.fns:
            self.fns[method] = jax.jit(lambda v, *a: self.module.apply(v, *a, method=method))
        return self.fns[method](variables, *args)


J_SPK = _Jitted(JZ.SpeakerEncoder(16))


@pytest.fixture(scope="module")
def cloners(ov):
    p, _tpl, tm = ov
    jc = JCl.OpenVoiceCloner(JO.ToneColorConfig(**OV), p, JCl.OpenVoiceCloneConfig(**CLONE_CFG))
    jc.model = _Jitted(jc.model)
    return jc, TCl.OpenVoiceCloner(tm, TCl.OpenVoiceCloneConfig(**CLONE_CFG), device="cpu")


def _voice(n, sr, f, seed, amp=0.3):
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    x = amp * np.sin(2 * np.pi * f * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def test_openvoice_weights_round_trip(ov):
    """The JAX converter reads the port's state_dict back into the tree it
    came from (upstream names kept)."""
    p, tpl, tm = ov
    back = convert_openvoice({k: v.numpy() for k, v in tm.state_dict().items()}, tpl)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)


def test_openvoice_cloner_matches_jax(cloners):
    """extract_se on a 0.6 s reference at 16 kHz (host resample to 8 kHz)
    within 1e-5 of max|g|; convert of 1.3 s (3 chunks of 0.5 s, crossfade)
    within 1e-4 of max|y|, at the model rate and the input's length."""
    jc, tc = cloners
    ref = _voice(9600, 16000, 180.0, 1)
    g_ref, g = jc.extract_se(ref, 16000), tc.extract_se(ref, 16000)
    assert g.shape == g_ref.shape == (16,)
    assert _rel(g, g_ref) <= 1e-5
    src = _voice(10400, SR, 220.0, 2)
    (y_ref, sr_ref), (y, sr) = jc.convert(src, SR, ref, 16000), tc.convert(src, SR, ref, 16000)
    assert sr == sr_ref == SR and y.shape == y_ref.shape == src.shape
    assert np.isfinite(y).all() and np.abs(y_ref).max() > 1e-3
    assert _rel(y, y_ref) <= 1e-4


@pytest.fixture(scope="module")
def spk():
    return tiny.speaker_encoder(16)


def _two_speakers():
    """3 s of a low tone, then 3 s of bright noise, at 16 kHz.  The tone
    carries a little noise, so that no two windows embed to the same row
    (k-means starting from two equal rows is a tie between its centres)."""
    rng = np.random.default_rng(4)
    a = 0.3 * np.sin(2 * np.pi * 200 * np.arange(48000) / 16000)
    a = a + 0.01 * rng.standard_normal(48000)
    b = 0.1 * rng.standard_normal(48000)
    return np.concatenate([a, b]).astype(np.float32)


def _jax_rows(n, k):
    """The rows the JAX kmeans starts from (jax.random.choice on seed 0)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(0), n, (k,), replace=n < k))


@pytest.fixture
def jax_start(monkeypatch):
    """The port's diarize with its k-means started from the rows the JAX
    k-means draws."""
    def start_as_jax(x, n_clusters, **kw):
        rows = torch.from_numpy(np.array(_jax_rows(x.shape[0], n_clusters))).to(x.device)
        return kmeans(x, n_clusters=n_clusters, init=x.float()[rows], **kw)

    monkeypatch.setattr(TCl, "kmeans", start_as_jax)


def test_diarize_matches_jax_under_its_kmeans_start(spk, jax_start):
    """Identical turns and speaker split when the port's k-means starts from
    the JAX k-means's rows; the same at 8 kHz input (host resample)."""
    p, se = spk
    wav = _two_speakers()
    for x, sr in ((wav, 16000), (wav[::2].copy(), 8000)):
        ref = JCl.diarize(x, sr, J_SPK, p, n_speakers=2)
        out = TCl.diarize(x, sr, se, n_speakers=2)
        assert out == ref and len({s for *_, s in ref}) == 2
        parts, ref_parts = TCl.split_speakers(x, sr, out), JCl.split_speakers(x, sr, ref)
        assert sorted(parts) == sorted(ref_parts)
        for k in parts:
            np.testing.assert_array_equal(parts[k], ref_parts[k])
    short = wav[:8000]
    assert TCl.diarize(short, 16000, se) == JCl.diarize(short, 16000, J_SPK, p)


def test_facade_dispatch(cloners, spk, jax_start):
    """methods, the voice store, OpenVoice through the facade, TTS without
    an engine, and choose_speaker against the JAX facade."""
    p, se = spk
    jfac = JCl.CloningFacade(openvoice=cloners[0], spk_encoder=J_SPK,
                             spk_params=p)
    tfac = TCl.CloningFacade(openvoice=cloners[1], spk_encoder=se)
    assert tfac.methods == jfac.methods == ["openvoice", "tts"]
    for fac in (jfac, tfac):
        fac.register_voice("alice", np.zeros(10, np.float32), 8000)
    assert sorted(tfac.voices) == sorted(jfac.voices)
    with pytest.raises(NotImplementedError):
        tfac.clone_voice_tts("hi", np.zeros(800, np.float32), SR)
    wav = _two_speakers()
    for index in (0, 1):
        got, turns = tfac.choose_speaker(wav, 16000, index=index)
        want, ref_turns = jfac.choose_speaker(wav, 16000, index=index)
        assert turns == ref_turns
        np.testing.assert_array_equal(got, want)


def test_clone_api_answers_from_the_facade(cloners):
    """/api/v1/clone/{methods,voices} with and without a facade, as the
    JAX routes answer."""
    routers = []
    for api in (j_clone_api, t_clone_api):
        r = JRouter() if api is j_clone_api else Router()
        api.register(r)
        routers.append((api, r))
    try:
        for fac in (None, "set"):
            answers = []
            for api, r in routers:
                if fac:
                    f = (JCl if api is j_clone_api else TCl).CloningFacade()
                    f.register_voice("bob", np.zeros(4, np.float32), 8000)
                    api.set_facade(f)
                else:
                    api.set_facade(None)
                answers.append([r.dispatch("GET", path, {}) for path in
                                ("/api/v1/clone/methods", "/api/v1/clone/voices")])
            assert answers[0] == answers[1]
    finally:
        j_clone_api.set_facade(None)
        t_clone_api.set_facade(None)


# ---------------------------------------------------------------- run_chain

@pytest.fixture(autouse=True)
def clone_state():
    saved = [(c, c.converter, c.facade) for c in (JClone.Clone, TClone.Clone)]
    yield
    for c, conv, fac in saved:
        c.converter, c.facade = conv, fac


class _JaxOpenVoice(JCl.CloningFacade):
    """The JAX Clone processor takes the facade's answer for the waveform,
    but OpenVoiceCloner answers (waveform, rate): a facade that answers the
    waveform alone lets the JAX chain run (ROADMAP queue 3)."""

    def clone_voice_openvoice(self, src, src_sr, ref, ref_sr):
        return super().clone_voice_openvoice(src, src_sr, ref, ref_sr)[0]


class _JaxDraws:
    """The port's ZonosTTS with the Gumbel draws the JAX keys give for its
    seed 0, so that its codes are the JAX engine's."""

    def __init__(self, tts):
        self.tts = tts

    def make_speaker_embedding(self, wav, sr):
        return self.tts.make_speaker_embedding(wav, sr)

    def synthesize(self, text, speaker=None):
        return self.tts.synthesize(text, speaker=speaker,
                                   draws=lambda *shape: tiny.jax_draws(0, *shape))


def _chain(tmp_path, files, settings):
    j = JC.run_chain(["Clone"], list(files), json.loads(json.dumps(settings)),
                     output_root=str(tmp_path / "jax"))
    t = run_chain(["Clone"], list(files), json.loads(json.dumps(settings)),
                  output_root=str(tmp_path / "port"), device="cpu")
    return j[0], t[0]


def _same_wav(j, t, n_files=1):
    jo, to = j.last_outputs, t.last_outputs
    assert [os.path.basename(p) for p in to] == [os.path.basename(p) for p in jo]
    assert len(to) == n_files and os.path.basename(to[0]).endswith("(Cloned).wav")
    a, b = read_audio(to[0]), j_read_audio(jo[0])
    assert a.sample_rate == b.sample_rate and a.samples.shape == b.samples.shape
    peak = float(np.abs(b.samples).max())
    assert peak > 1e-3 and np.isfinite(a.samples).all()
    err = float(np.abs(a.samples - b.samples).max())
    assert err <= PCM16 + 1e-4 * peak, f"max|diff| {err:.3e}, peak {peak:.3e}"
    return a


def test_clone_openvoice_through_run_chain(tmp_path, cloners, spk, jax_start):
    """Clone with clone_method OpenVoice, voice_strength 0.7 and
    diarize_speakers on a stereo (Vocals) stem at the model rate: the
    k-means split's second speaker is converted and blended; the same
    (Cloned).wav, a little shorter than the stem."""
    p, se = spk
    JClone.Clone.configure(None, _JaxOpenVoice(
        openvoice=cloners[0], spk_encoder=J_SPK, spk_params=p))
    TClone.Clone.configure(None, TCl.CloningFacade(openvoice=cloners[1], spk_encoder=se))
    vocal = _two_speakers()[::2].copy()
    stem = tmp_path / "song_(Vocals).wav"
    write_wav(stem, np.stack([vocal, 0.9 * vocal]), SR)
    ref = tmp_path / "ref.wav"
    write_wav(ref, _voice(9600, 16000, 180.0, 1), 16000)
    settings = {"Clone": {"clone_method": "OpenVoice", "source_speaker": str(ref),
                          "voice_strength": 0.7, "diarize_speakers": True,
                          "speaker_index": 1}}
    j, t = _chain(tmp_path, [str(stem)], settings)
    a = _same_wav(j, t)
    assert a.sample_rate == SR and a.samples.shape[-1] < len(vocal)


def test_clone_openvoice_brings_the_answer_to_the_stem_rate(tmp_path, cloners):
    """A 44.1 kHz stereo stem (the rate Separate writes): the port's Clone
    takes the cloner's (waveform, model rate) answer back to 44.1 kHz before
    the voice_strength blend.  Held against the JAX cloner's waveform for
    the same stem, brought to 44.1 kHz by the JAX package's host
    resample_poly_np and blended with the stem's mono mix: within a PCM-16
    step plus 1e-4 of the peak, at the stem's rate and length."""
    TClone.Clone.configure(None, TCl.CloningFacade(openvoice=cloners[1]))
    n = 57330                                       # 1.3 s at 44.1 kHz
    vocal = _voice(n, 44100, 220.0, 2)
    stem = tmp_path / "song_(Vocals).wav"
    write_wav(stem, np.stack([vocal, 0.9 * vocal]), 44100)
    ref = tmp_path / "ref.wav"
    write_wav(ref, _voice(9600, 16000, 180.0, 1), 16000)
    tau = 0.7
    settings = {"Clone": {"clone_method": "OpenVoice", "source_speaker": str(ref),
                          "voice_strength": tau}}
    t = run_chain(["Clone"], [str(stem)], settings, output_root=str(tmp_path / "port"),
                  device="cpu")[0]
    src = j_read_audio(str(stem)).samples.mean(axis=0)
    r = j_read_audio(str(ref))
    y_j, sr_j = cloners[0].convert(src, 44100, r.samples.mean(axis=0), r.sample_rate)
    assert sr_j == SR
    y_j = j_resample_poly_np(np.asarray(y_j, np.float32), SR, 44100)
    m = min(len(y_j), len(src))
    want = tau * y_j[:m] + (1.0 - tau) * src[:m]
    got = read_audio(t.last_outputs[0])
    assert got.sample_rate == 44100 and got.samples.shape == (1, n) == (1, m)
    peak = float(np.abs(want).max())
    err = float(np.abs(got.samples[0] - want).max())
    assert peak > 1e-3 and err <= PCM16 + 1e-4 * peak, f"max|diff| {err:.3e}, peak {peak:.3e}"


@pytest.fixture(scope="module")
def engines():
    """(JAX ZonosTTS, port ZonosTTS) holding the same weights
    (tests/test_torch_port_tts.py's)."""
    cfg, p, tm = tiny.zonos("mamba2")
    dcfg, dp, td = tiny.dac()
    sp, ts = tiny.speaker_encoder()
    jt = JT.ZonosTTS(cfg, p, dcfg, dp, sp, JT.ZonosTTSConfig(**TTS_CFG))
    tt = TT.ZonosTTS(tm, td, ts, TT.ZonosTTSConfig(**TTS_CFG), device="cpu")
    return jt, tt


def test_clone_tts_through_run_chain(tmp_path, engines):
    """Clone with clone_method TTS and a custom_text: the facade's Zonos
    speaks it with the reference's speaker embedding; the WAV is written at
    the engine's 44.1 kHz.  Without custom_text and without a transcriber
    both processors fail and the chain returns its input."""
    jt, tt = engines
    JClone.Clone.configure(None, JCl.CloningFacade(tts=jt))
    TClone.Clone.configure(None, TCl.CloningFacade(tts=_JaxDraws(tt)))
    stem = tmp_path / "take_(Vocals).wav"
    write_wav(stem, _voice(4000, 16000, 200.0, 7), 16000)
    ref = tmp_path / "ref.wav"
    write_wav(ref, _voice(8000, 16000, 180.0, 1), 16000)
    settings = {"Clone": {"clone_method": "TTS", "source_speaker": str(ref),
                          "custom_text": "Good morning. [happiness] Lovely!"}}
    j, t = _chain(tmp_path, [str(stem)], settings)
    assert _same_wav(j, t).sample_rate == 44100
    settings["Clone"]["custom_text"] = ""
    j, t = _chain(tmp_path / "no_text", [str(stem)], settings)
    assert "cloned" not in t.file_dict and "cloned" not in j.file_dict


def test_clone_tts_transcribes_when_no_text_is_given(tmp_path, engines):
    """Clone by TTS with an empty custom_text: the facade's transcriber gives
    the text (clone.py:247-253).  The port's facade takes the port's
    Transcriber itself, a callable; the JAX Transcriber is not callable, so
    the JAX facade holding it fails the processor (ROADMAP queue 3) and is
    given its ``transcribe(...)["text"]`` instead.  Both transcribers hold the
    demo Whisper's weights (tests/torch_port_tiny.py): the same text, and
    WAVs as in test_clone_tts_through_run_chain."""
    jt, tt = engines
    jtr, ttr = tiny.transcriber_pair()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the port's small ops, beside the suite's other workers
    try:
        _clone_by_transcript(tmp_path, jt, tt, jtr, ttr)
    finally:
        torch.set_num_threads(threads)


def _clone_by_transcript(tmp_path, jt, tt, jtr, ttr):
    stem = tmp_path / "take_(Vocals).wav"
    write_wav(stem, _voice(16000, 16000, 200.0, 7), 16000)
    ref = tmp_path / "ref.wav"
    write_wav(ref, _voice(8000, 16000, 180.0, 1), 16000)
    settings = {"Clone": {"clone_method": "TTS", "source_speaker": str(ref), "custom_text": ""}}
    facade = JCl.CloningFacade(tts=jt)
    facade.transcriber = jtr
    JClone.Clone.configure(None, facade)
    TClone.Clone.configure(None, TCl.CloningFacade(tts=_JaxDraws(tt), transcriber=ttr))
    j, t = _chain(tmp_path / "jax_transcriber", [str(stem)], settings)
    assert "cloned" not in j.file_dict
    with pytest.raises(TypeError, match="not callable"):
        jtr(np.zeros(1600, np.float32), 16000)
    facade.transcriber = lambda x, sr: jtr.transcribe(x, sr)["text"]
    x = read_audio(str(stem)).samples.mean(axis=0)
    assert ttr(x, 16000) == facade.transcriber(x, 16000) != ""
    j, t = _chain(tmp_path, [str(stem)], settings)
    assert _same_wav(j, t).sample_rate == 44100


def test_clone_without_a_facade_fails_as_jax(tmp_path):
    """OpenVoice and TTS without a facade: both processors raise, the chain
    keeps its input; diarize_speakers without a facade is ignored."""
    stem = tmp_path / "v_(Vocals).wav"
    write_wav(stem, _voice(1600, SR, 220.0, 8), SR)
    for method in ("OpenVoice", "TTS"):
        j, t = _chain(tmp_path / method, [str(stem)], {"Clone": {"clone_method": method}})
        assert list(t.file_dict) == list(j.file_dict) == []
