"""The port's transcription path against the JAX package's, on the CPU:
the wav2vec2 CTC aligner (models/wav2vec2.py), the forced-alignment host
code (pipelines/forced_align.py), PyanNet (models/pyannet.py) and its VAD,
the Transcriber with aligner, VAD and diarization turns
(pipelines/transcribe.py), and the diarizer's PyanNet back end.

Every model is narrow (the aligner at ``random_ctc_aligner``'s widths with
2 layers, PyanNet with a 2-layer LSTM of 32, Whisper at the demo widths);
the weights are seeded flax trees carried over by the ``*_from_jax``
functions, and the JAX converters map the port's state_dicts back onto them.

Tolerances: log-probs within 1e-5 (fp32 convolutions, attention and LSTM
steps summed in another order); CTC spans, aligned words, VAD regions,
transcription JSON and diarization turns identical (each comes from an
argmax or a threshold that the data keeps at least 1e-4 away from a tie, or
from host code that is the same on both sides)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiolab_tpu.models import diarize as JD
from audiolab_tpu.models import hubert as JH
from audiolab_tpu.models import pyannet as JP
from audiolab_tpu.models import wav2vec2 as JV
from audiolab_tpu.models import whisper as JW
from audiolab_tpu.pipelines import forced_align as JF
from audiolab_tpu.pipelines import transcribe as JT
from audiolab_tpu.utils.convert import convert_pyannet, convert_wav2vec2
from audiolab_tpu_torch.models import diarize as TD
from audiolab_tpu_torch.models import hubert as TH
from audiolab_tpu_torch.models import pyannet as TP
from audiolab_tpu_torch.models import wav2vec2 as TV
from audiolab_tpu_torch.models import whisper as TW
from audiolab_tpu_torch.pipelines import forced_align as TF
from audiolab_tpu_torch.pipelines import transcribe as TT
from audiolab_tpu_torch.utils import weights as W
from tests import torch_port_tiny as tiny

W2V_ENC = dict(dim=64, ffn_dim=128, heads=4, layers=2)
PYAN = dict(lstm_hidden=32, lstm_layers=2, linear_dim=32)
# the classifier's kernels times 30 and its no-speech bias lifted by 1.72
# (the median margin of the filled tree's logits on the test track): the
# frames then split into speech and silence, 14 regions on the VAD track
PYAN_KERNEL_SCALE, PYAN_SILENCE_BIAS = 30.0, 1.72


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one CPU thread: its small recurrent and attention
    ops run fastest so, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@functools.lru_cache(maxsize=None)
def aligners():
    """(flax template, flax params, JAX CTCWordAligner, port CTCWordAligner)."""
    jcfg = JV.Wav2Vec2Config(encoder=JH.HubertConfig(**W2V_ENC))
    tpl = jax.eval_shape(lambda: JV.Wav2Vec2CTC(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16000))))["params"]
    p = tiny.filled(tpl, 60)
    tm = TV.Wav2Vec2CTC(TV.Wav2Vec2Config(encoder=TH.HubertConfig(**W2V_ENC)))
    tm.load_state_dict(W.wav2vec2_from_jax(p), strict=True)
    return tpl, p, JV.CTCWordAligner(p, jcfg), TV.CTCWordAligner(tm, device="cpu")


@functools.lru_cache(maxsize=None)
def pyannets():
    """(JAX PyanNet, flax template, flax params, port PyanNet)."""
    jm = JP.PyanNet(JP.PyanNetConfig(**PYAN))
    tpl = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16000))))["params"]
    p = tiny.filled(tpl, 61)
    p["classifier"]["kernel"] = p["classifier"]["kernel"] * PYAN_KERNEL_SCALE
    p["classifier"]["bias"][0] += PYAN_SILENCE_BIAS
    tm = TP.PyanNet(TP.PyanNetConfig(**PYAN))
    tm.load_state_dict(W.pyannet_from_jax(p), strict=True)
    return jm, tpl, p, tm.eval()


def _speech(seconds: float, seed: int) -> np.ndarray:
    """Seeded noise gated on and off in 0.25 s blocks, at 16 kHz."""
    rng = np.random.default_rng(seed)
    gate = np.repeat(rng.random(int(seconds * 4)) > 0.5, 4000)
    return (0.2 * rng.standard_normal(len(gate)) * gate).astype(np.float32)


def test_wav2vec2_log_probs_and_spans_match_jax():
    """Segments of 1.0 and 1.44 s: log-probs within 1e-5, the CTC spans of
    each package's trellis identical, and align_words identical."""
    tpl, p, ja, ta = aligners()
    tiny.assert_tree_equal(convert_wav2vec2(W.wav2vec2_to_hf(tiny.numpy_state(ta.model)), tpl), p)
    x = _speech(4.0, 1)
    ids = np.asarray([11, 5, 15, 15, 8, 4, 6, 11, 5, 13, 5])
    for n in (16000, 23040):
        ref = np.asarray(ja._logits(jnp.asarray(x[:n])[None])[0])
        lp = ta.log_probs(x[:n])
        assert lp.shape == ref.shape == (n // 320 - 1, 32)
        _close(lp, ref)
        assert TF.ctc_forced_align(lp, ids) == JF.ctc_forced_align(ref, ids)
    words = ["hello", "there,", "my", "FRIEND", "x"]
    assert ta.align_words(x, 16000, 0.3, 2.9, words) == ja.align_words(x, 16000, 0.3, 2.9, words)
    # a segment under 40 ms takes the energy aligner, as in the JAX package
    assert ta.align_words(x, 16000, 1.0, 1.03, words) == ja.align_words(x, 16000, 1.0, 1.03,
                                                                        words)


def test_forced_align_host_code_matches_jax():
    rng = np.random.default_rng(2)
    lp = np.log(rng.dirichlet(np.ones(12), size=40))
    for toks in ([3, 3, 5, 1], [2], list(rng.integers(1, 12, 15))):
        toks = np.asarray(toks)
        assert TF.ctc_forced_align(lp, toks) == JF.ctc_forced_align(lp, toks)
    x = _speech(3.0, 3)
    words = ["one", "three", "eleven", "a"]
    for start, end in ((0.0, 3.0), (0.5, 1.2), (2.0, 2.01)):
        assert TF.energy_align_words(x, 16000, start, end, words) == JF.energy_align_words(
            x, 16000, start, end, words)


def test_ctc_forced_align_past_64_tokens():
    """ROADMAP queue 3: the JAX trellis keeps its backtrack pointers in int8
    and subtracts them from a Python int, which NumPy 2 keeps in int8: past
    state 127 (a transcript of 64 tokens or more, about 60 characters) it
    raises OverflowError.  On posteriors that put token k on frames 4k+1 to
    4k+3 (blanks between), the port gives exactly those spans."""
    rng = np.random.default_rng(3)
    toks = rng.integers(5, 32, 70)
    lp = np.full((4 * 70 + 1, 32), -8.0)
    lp[::4, 0] = -0.01
    for k, tok in enumerate(toks):
        lp[4 * k + 1: 4 * k + 4, tok] = -0.01
    assert TF.ctc_forced_align(lp, toks) == [(4 * k + 1, 4 * k + 4) for k in range(70)]
    with pytest.raises(OverflowError, match="int8"):
        JF.ctc_forced_align(lp, toks)
    assert TF.ctc_forced_align(lp[:101], toks[:25]) == JF.ctc_forced_align(lp[:101], toks[:25])


def test_pyannet_log_probs_match_jax_and_the_replica():
    """Two 4 s windows: log-probs within 1e-5 of the JAX model and of the
    seeded torch replica of pyannote's PyanNet (tests/torch_pyannet_replica.py)
    holding the port's state_dict; the round trip through convert_pyannet."""
    from tests.torch_pyannet_replica import PyanNet as ReplicaPyanNet

    jm, tpl, p, tm = pyannets()
    tiny.assert_tree_equal(convert_pyannet(tiny.numpy_state(tm), tpl), p)
    wav = np.stack([_speech(4.0, 4), _speech(4.0, 5)])
    ref = np.asarray(jax.jit(lambda w: jm.apply({"params": p}, w))(jnp.asarray(wav)))
    replica = ReplicaPyanNet(**PYAN).eval()
    missing, unexpected = replica.load_state_dict(tm.state_dict(), strict=False)
    assert not unexpected and all(k.endswith(("window_", "n_")) for k in missing)
    with torch.no_grad():
        out = tm(torch.from_numpy(wav)).numpy()
        witness = replica(torch.from_numpy(wav)[:, None]).numpy()
    assert out.shape == ref.shape == (2, 234, 7)
    _close(out, ref)
    _close(out, witness)
    ml = TP.powerset_to_multilabel(torch.from_numpy(out)).numpy()
    np.testing.assert_array_equal(ml, np.asarray(JP.powerset_to_multilabel(jnp.asarray(ref))))


def test_pyannet_vad_regions_identical():
    """25 s gated noise (three 10 s windows, the last padded): identical
    regions, 14 of them; the speech decisions are at least 1e-4 from a tie."""
    jm, _tpl, p, tm = pyannets()
    x = _speech(25.0, 2)
    ref = JT.pyannet_vad(jm, p)(x, 16000)
    assert TT.pyannet_vad(tm, device="cpu")(x, 16000) == ref and len(ref) == 14
    with torch.no_grad():
        lp = tm(torch.from_numpy(np.pad(x, (0, 80000)).reshape(3, 160000))).numpy()
    assert np.abs(lp[..., 0] - lp[..., 1:].max(-1)).min() > 1e-4
    x8 = x[::2].copy()
    assert TT.pyannet_vad(tm, device="cpu")(x8, 8000) == JT.pyannet_vad(jm, p)(x8, 8000)


def test_segments_formatters_and_merge_match_jax():
    cfg_j, cfg_t = JW.WhisperConfig(), TW.WhisperConfig()
    toks = np.asarray([cfg_j.sot, cfg_j.timestamp_base, 40, 41, cfg_j.timestamp_base + 50,
                       cfg_j.no_timestamps, 42, cfg_j.timestamp_base + 90, 43, 44, cfg_j.eot, 45])

    def detok(ids):
        return "".join(chr(65 + i % 26) for i in ids)

    js = JT.tokens_to_segments(toks, cfg_j, detok, 12.0)
    ts = TT.tokens_to_segments(toks, cfg_t, detok, 12.0)
    assert [vars(s) for s in ts] == [vars(s) for s in js] and len(ts) == 3
    turns = [(11.0, 12.5, "SPEAKER_00"), (12.5, 14.0, "SPEAKER_01")]
    JT.assign_speakers(js, turns)
    TT.assign_speakers(ts, turns)
    assert [s.speaker for s in ts] == [s.speaker for s in js] == ["SPEAKER_00", "SPEAKER_01",
                                                                  "SPEAKER_01"]
    assert set(TT.FORMATTERS) == set(JT.FORMATTERS)
    for name, fmt in TT.FORMATTERS.items():
        assert fmt(ts) == JT.FORMATTERS[name](js)
    regions = [(0.0, 3.0), (3.5, 40.0), (40.2, 41.0), (45.0, 45.02), (46.0, 50.0)]
    assert TT.merge_vad_regions(regions) == JT.merge_vad_regions(regions)


def transcribers():
    """The JAX and the port Transcriber on tests/torch_port_tiny.py's demo
    Whisper, with the CTC aligner and the PyanNet VAD of this file."""
    _tpl, _p, ja, ta = aligners()
    pj, _ptpl, pp, pt = pyannets()
    return tiny.transcriber_pair(dict(aligner=ja, vad=JT.pyannet_vad(pj, pp)),
                                 dict(aligner=ta, vad=TT.pyannet_vad(pt, device="cpu")))


def test_transcriber_json_matches_jax():
    """12 s of gated noise through Whisper, the VAD's chunks, the CTC aligner
    and two diarization turns: the same JSON (text, segments, words,
    speakers) and the same SRT."""
    j, t = transcribers()
    x = _speech(12.0, 7)
    turns = [(0.0, 6.0, "SPEAKER_00"), (6.0, 12.0, "SPEAKER_01")]
    ref = j.transcribe(x, 16000, response_format="srt", diarize_turns=turns)
    out = t.transcribe(x, 16000, response_format="srt", diarize_turns=turns)
    assert out == ref
    assert len(ref["segments"]) >= 2 and all(s["words"] for s in ref["segments"])
    # a segment of no duration overlaps no turn and keeps no speaker
    assert "SPEAKER_00" in {s["speaker"] for s in ref["segments"]}
    # the facade's callable: the text without speaker labels
    assert t(x, 16000) == j.transcribe(x, 16000)["text"] != ref["text"]


def test_diarizer_pyannet_back_end_matches_jax():
    """NeuralDiarizer(pyannet_params=...) on 5.5 s (5 chunks of 2 s): the
    PyanNet activities mapped onto the mel grid and the turns identical."""
    from tests.test_torch_port_diarize import CFG, _speech as two_speakers

    jm, _tpl, p, _tm = pyannets()
    jc, tc = JD.DiarizeConfig(**CFG), TD.DiarizeConfig(**CFG)
    seg_tpl = jax.eval_shape(lambda: JD.SegmentationNet(jc).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, CFG["n_mels"]))))["params"]
    emb_tpl = jax.eval_shape(lambda: JD.SpeakerEmbedder(jc).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, CFG["n_mels"]))))["params"]
    seg_p, emb_p = tiny.filled(seg_tpl, 21), tiny.filled(emb_tpl, 22)
    seg_sd, emb_sd = W.diarize_from_jax(seg_p, emb_p)
    seg, emb = TD.SegmentationNet(tc), TD.SpeakerEmbedder(tc)
    seg.load_state_dict(seg_sd, strict=True)
    emb.load_state_dict(emb_sd, strict=True)
    jd = JD.NeuralDiarizer(jc, seg_p, emb_p, pyannet_params=p,
                           pyannet_cfg=JP.PyanNetConfig(**PYAN))
    td = TD.NeuralDiarizer(tc, seg, emb, pyannet_params=W.pyannet_from_jax(p),
                           pyannet_cfg=TP.PyanNetConfig(**PYAN), device="cpu")
    x = two_speakers(5.5, 2)
    ref = jd.diarize(x, 16000)
    assert td.diarize(x, 16000) == ref and len(ref) >= 2
